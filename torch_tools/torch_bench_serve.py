#!/usr/bin/env python
"""Serving benchmark of the port: continuous batching against batch-of-1
sequential decode — the twin of ``tools/bench_serve.py``.

Serves a GPT through ``paddle_tpu_torch.serving`` (static KV cache,
prefill/decode split, slot-based continuous batching, speculative decoding
and chunked prefill on by default) and reports:

* tokens/s of (a) SEQUENTIAL serving — one request at a time through a
  batch-1 engine — and (b) CONTINUOUS batching at ``--concurrency`` slots,
  and the speedup;
* p50/p95 request latency from arrival to the last token (every request
  arrives at t0, so the sequential baseline pays its queue wait) and TTFT;
* decode-batch occupancy, decode steps and the ``serve.*`` telemetry;
* the distinct shapes each serving program was dispatched with
  (``GenerationEngine.dispatch_shapes``), where the JAX bench counts
  compiles: decode and verify one shape each, chunked prefill one, prefill
  one a bucket used;
* with ``--prompt-len-sweep``, TTFT against prompt length at queue
  pressure; with ``--chaos``, the chaos harness's verdict
  (``torch_tools/torch_chaos_serve.py``, its tiny CPU config).

Not ported: the JAX bench's ``--long-prompt`` leg (it needs the
long-context item) and its graph lint of the decode step (the analysis
package, ``ROADMAP.md`` A9).

Usage::

    python3 torch_tools/torch_bench_serve.py --smoke   # tiny CPU config
    python3 torch_tools/torch_bench_serve.py           # GPT-2 124M, card

The full run serves GPT-2 124M (bf16, fp32 LayerNorms, random weights from
``torch.manual_seed(0)``) on the card and needs the kernel build (K4, K7).
Prints one JSON line; ``--artifact PATH`` also writes it to ``PATH``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _pctl(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def build_model(smoke, device):
    import torch

    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import LayerNorm

    if smoke:
        cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                        num_heads=2, max_position_embeddings=64,
                        hidden_dropout=0.0, attention_dropout=0.0)
    else:
        # GPT-2 small (124M), the configuration bench.py trains
        cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                        num_heads=12, max_position_embeddings=1024,
                        hidden_dropout=0.0, attention_dropout=0.0)
    torch.manual_seed(0)
    dtype = torch.bfloat16 if device.startswith("cuda") else None
    model = GPTForCausalLM(cfg, device=device, dtype=dtype)
    if dtype is not None:
        for mod in model.modules():
            if isinstance(mod, LayerNorm):
                mod.float()
    model.eval()
    return cfg, model


def make_requests(cfg, n, max_new, buckets, seed):
    from paddle_tpu_torch.serving import Request

    rng = np.random.RandomState(seed)
    lo, hi = 4, max(5, buckets[-1] // 2)
    return [Request(prompt=rng.randint(0, cfg.vocab_size,
                                       int(rng.randint(lo, hi))).tolist(),
                    max_new_tokens=max_new)
            for _ in range(n)]


def _sync(model):
    import torch

    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def run_sequential(model, requests, max_len, buckets):
    """Batch-of-1 serial decode: every request waits for its predecessors
    (all arrive at t0)."""
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(model, max_batch=1, max_len=max_len,
                           prefill_buckets=buckets, device=model.device)
    for b in buckets:  # every step once, outside the timer
        eng.generate([1] * min(b, max_len - 2), max_new_tokens=2)
    _sync(model)
    t0 = time.perf_counter()
    lat, tokens = [], 0
    for req in requests:
        out = eng.generate(req.prompt, max_new_tokens=req.max_new_tokens,
                           eos_id=req.eos_id)
        tokens += len(out)
        lat.append(time.perf_counter() - t0)  # includes queue wait
    _sync(model)
    wall = time.perf_counter() - t0
    return {
        "wall_s": wall,
        "tokens": tokens,
        "tokens_per_sec": tokens / wall if wall else None,
        "p50_latency_s": _pctl(lat, 50),
        "p95_latency_s": _pctl(lat, 95),
    }


def warm_engine(eng, buckets, max_len, concurrency):
    """Run every serving step once outside the timers: one prefill a
    bucket, the decode step, and (when built) the chunked-prefill and
    verify steps."""
    for b in buckets:
        eng.prefill(0, [1] * min(b, max_len - 2))
    eng.decode_once(np.zeros(concurrency, np.int32))
    if eng.prefill_chunk:
        warm = [1] * (eng.prefill_chunk + 1)  # exactly two chunks
        off, tok = 0, None
        while tok is None:
            tok = eng.prefill_chunk_step(0, warm, off)
            off += eng.prefill_chunk
    if eng.spec_k:
        eng.verify_once(np.zeros((concurrency, eng.spec_k + 1), np.int32))


def run_continuous(model, requests, max_len, buckets, concurrency,
                   spec_k=0, prefill_chunk=None):
    """Continuous batching under telemetry."""
    from paddle_tpu_torch.profiler import telemetry
    from paddle_tpu_torch.serving import GenerationEngine, Scheduler

    telemetry.reset()
    telemetry.enable()
    eng = GenerationEngine(model, max_batch=concurrency, max_len=max_len,
                           prefill_buckets=buckets, spec_k=spec_k,
                           prefill_chunk=prefill_chunk or None,
                           device=model.device)
    warm_engine(eng, buckets, max_len, concurrency)
    # the shapes the timed run dispatches, apart from the warm-up's
    eng.dispatch_shapes = {k: [] for k in eng.dispatch_shapes}

    sched = Scheduler(eng)
    _sync(model)
    t0 = time.perf_counter()
    submit_ns = time.perf_counter_ns()
    for req in requests:
        sched.submit(req)
        req.submit_ns = submit_ns  # common arrival instant, like sequential
    finished = sched.run()
    _sync(model)
    wall = time.perf_counter() - t0

    lat = [r.latency_s for r in finished if r.latency_s is not None]
    ttft = [r.ttft_s for r in finished if r.ttft_s is not None]
    tokens = sum(len(r.tokens) for r in finished)
    tm = telemetry.get_telemetry()
    stats = {
        "wall_s": wall,
        "tokens": tokens,
        "tokens_per_sec": tokens / wall if wall else None,
        "p50_latency_s": _pctl(lat, 50),
        "p95_latency_s": _pctl(lat, 95),
        "p50_ttft_s": _pctl(ttft, 50),
        "p95_ttft_s": _pctl(ttft, 95),
        "batch_occupancy": sched.occupancy(),
        "decode_steps": sched.decode_steps,
        "requests_in_flight": tm.gauges().get("serve.requests_in_flight",
                                              0.0),
    }
    tm.set_gauge("serve.tokens_per_s", stats["tokens_per_sec"] or 0.0)
    tm.set_gauge("serve.p95_latency_s", stats["p95_latency_s"])
    tm.set_gauge("serve.p50_latency_s", stats["p50_latency_s"])
    tm.set_gauge("serve.batch_occupancy", stats["batch_occupancy"])
    telemetry.disable()  # data stays readable for the block below
    return eng, sched, stats


def run_prompt_len_sweep(cfg, model, max_len, buckets, concurrency,
                         spec_k, prefill_chunk, seed, lengths=None):
    """TTFT against prompt length at queue pressure (2× concurrency, every
    prompt the same length L); ``growth_ratio`` < 1 means p95 TTFT grew
    sub-linearly with the prompt length."""
    from paddle_tpu_torch.serving import GenerationEngine, Request, Scheduler

    eng = GenerationEngine(model, max_batch=concurrency, max_len=max_len,
                           prefill_buckets=buckets, spec_k=spec_k,
                           prefill_chunk=prefill_chunk or None,
                           device=model.device)
    warm_engine(eng, buckets, max_len, concurrency)
    max_new = 8
    lengths = [x for x in (lengths or (4, 8, 16, 24, 32))
               if x <= buckets[-1] and x + max_new <= max_len]
    rng = np.random.RandomState(seed)
    rows = []
    for L in lengths:
        reqs = [Request(prompt=rng.randint(0, cfg.vocab_size, L).tolist(),
                        max_new_tokens=max_new)
                for _ in range(2 * concurrency)]
        sched = Scheduler(eng)
        t0 = time.perf_counter_ns()
        for r in reqs:
            sched.submit(r)
            r.submit_ns = t0
        sched.run()
        ttft = [r.ttft_s for r in reqs if r.ttft_s is not None]
        rows.append({"prompt_len": int(L), "requests": len(reqs),
                     "p50_ttft_s": _pctl(ttft, 50),
                     "p95_ttft_s": _pctl(ttft, 95)})
    lo, hi = rows[0], rows[-1]
    growth = None
    if lo["p95_ttft_s"] > 0 and hi["prompt_len"] > lo["prompt_len"]:
        growth = ((hi["p95_ttft_s"] / lo["p95_ttft_s"])
                  / (hi["prompt_len"] / lo["prompt_len"]))
    return {"rows": rows, "growth_ratio": growth,
            "sub_linear": bool(growth is not None and growth < 1.0)}


def telemetry_serve_block():
    from paddle_tpu_torch.profiler import telemetry

    s = telemetry.summary()
    block = {k: v for k, v in s["gauges"].items() if k.startswith("serve.")}
    block.update({k: v for k, v in s["counters"].items()
                  if k.startswith("serve.")})
    tm = telemetry.get_telemetry()
    for name in ("serve.ttft_s", "serve.tpot_s", "serve.latency_s"):
        st = tm.get(name)
        if st and st.get("count"):
            block[name + ".mean"] = st["sum"] / st["count"]
            block[name + ".sum"] = st["sum"]
            block[name + ".p50"] = tm.stat(name, "p50")
            block[name + ".p95"] = tm.stat(name, "p95")
    return block


def check(result, buckets, spec_k, prefill_chunk):
    """The bench's contract (the JAX bench's, on dispatch shapes): the
    problems found, empty on a green run."""
    tblock, shapes = result["telemetry"], result["dispatch_shapes"]
    problems = []
    for key in ("serve.tokens_per_s", "serve.p95_latency_s"):
        if key not in tblock:
            problems.append(f"telemetry block missing {key}")
    conc = result["config"]["concurrency"]
    if shapes["serve_decode"] not in ([], [[conc, 1]]):
        problems.append(f"decode dispatched {shapes['serve_decode']} "
                        f"(want at most [[{conc}, 1]])")
    if len(shapes["serve_prefill"]) > len(buckets):
        problems.append("prefill dispatched more shapes than buckets")
    if spec_k and shapes["serve_verify"] != [[conc, spec_k + 1]]:
        problems.append(f"verify dispatched {shapes['serve_verify']} "
                        f"(want [[{conc}, {spec_k + 1}]])")
    if prefill_chunk and len(shapes["serve_prefill_chunk"]) > 1:
        problems.append(f"chunked prefill dispatched "
                        f"{shapes['serve_prefill_chunk']} (want one shape)")
    if spec_k and not tblock.get("serve.spec_ticks"):
        problems.append("speculation enabled but no speculative ticks ran")
    sweep = result.get("prompt_len_sweep")
    if sweep is not None and prefill_chunk and not sweep["sub_linear"]:
        problems.append(f"p95 TTFT grew super-linearly with prompt length "
                        f"(growth_ratio {sweep['growth_ratio']})")
    chaos = result.get("chaos")
    if chaos is not None and chaos["problems"]:
        problems.append("chaos harness: " + "; ".join(chaos["problems"]))
    return problems


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config on the CPU + the contract checks")
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--max-new-tokens", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec-k", type=int, default=None,
                    help="speculative draft length (default 4; 0 disables)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill width (default 16, smoke 4; "
                         "0 disables)")
    ap.add_argument("--prompt-len-sweep", action="store_true",
                    help="append TTFT-vs-prompt-length rows")
    ap.add_argument("--artifact", default=None)
    ap.add_argument("--chaos", action="store_true",
                    help="also run torch_tools/torch_chaos_serve.py (its "
                         "tiny CPU config) and embed its verdict")
    args = ap.parse_args(argv)

    device = "cpu" if args.smoke else "cuda"
    if args.smoke:
        args.concurrency = min(args.concurrency, 4)
    n_req = args.requests or 2 * args.concurrency
    max_new = args.max_new_tokens or (8 if args.smoke else 64)
    spec_k = 4 if args.spec_k is None else max(0, args.spec_k)
    prefill_chunk = ((4 if args.smoke else 16) if args.prefill_chunk is None
                     else max(0, args.prefill_chunk))

    cfg, model = build_model(args.smoke, device)
    # the cache sized to the workload: the largest prompt (buckets[-1]/2)
    # plus the generation budget
    max_len = 64 if args.smoke else 32 + max_new
    buckets = (8, 16) if args.smoke else (16, 64)

    requests = make_requests(cfg, n_req, max_new, buckets, args.seed)
    from paddle_tpu_torch.serving import Request

    seq_requests = [Request(prompt=list(r.prompt),
                            max_new_tokens=r.max_new_tokens)
                    for r in requests]
    sequential = run_sequential(model, seq_requests, max_len, buckets)
    eng, sched, continuous = run_continuous(
        model, requests, max_len, buckets, args.concurrency, spec_k=spec_k,
        prefill_chunk=prefill_chunk)
    tblock = telemetry_serve_block()

    speedup = None
    if sequential["tokens_per_sec"] and continuous["tokens_per_sec"]:
        speedup = continuous["tokens_per_sec"] / sequential["tokens_per_sec"]
    device_name = str(model.device)
    if model.device.type == "cuda":
        import torch

        device_name = torch.cuda.get_device_name(model.device)
    result = {
        "metric": "serve_tokens_per_sec",
        "value": continuous["tokens_per_sec"],
        "unit": "tok/s",
        "speedup_vs_sequential": speedup,
        "device": device_name,
        "config": {
            "model": "gpt2-smoke" if args.smoke else "gpt2-124M",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "max_len": max_len, "prefill_buckets": list(buckets),
            "concurrency": args.concurrency, "requests": n_req,
            "max_new_tokens": max_new,
            "spec_k": spec_k, "prefill_chunk": prefill_chunk,
        },
        "sequential": sequential,
        "continuous": continuous,
        "dispatch_shapes": {k: [list(s) for s in v]
                            for k, v in eng.dispatch_shapes.items()},
        "telemetry": tblock,
    }
    if args.prompt_len_sweep:
        result["prompt_len_sweep"] = run_prompt_len_sweep(
            cfg, model, max_len, buckets, args.concurrency, spec_k,
            prefill_chunk, args.seed)
    if args.chaos:
        import torch_chaos_serve

        chaos = torch_chaos_serve.run_chaos(seed=args.seed)
        result["chaos_ok"] = 1.0 if chaos["ok"] else 0.0
        result["chaos"] = {k: chaos[k] for k in
                           ("finish_reasons", "survivors", "slo_alerts",
                            "problems")}
    print(json.dumps(result))
    if args.artifact:
        with open(args.artifact, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    problems = check(result, buckets, spec_k, prefill_chunk)
    if problems:
        print("torch_bench_serve FAILED: " + "; ".join(problems),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
