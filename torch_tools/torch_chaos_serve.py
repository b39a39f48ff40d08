#!/usr/bin/env python
"""Deterministic chaos harness for the port's serving tier — the twin of
``tools/chaos_serve.py``, with the same contract.

Floods a :class:`~paddle_tpu_torch.serving.Scheduler` while injecting
faults through ``paddle_tpu_torch.fault.inject`` and asserts:

* **full accounting** — every submitted request reaches EXACTLY ONE
  terminal ``finish_reason`` from ``FINISH_REASONS``, and the ``serve.*``
  telemetry counters agree with the per-request records;
* **no scheduler crash** — the injected OOM (``serve.decode``), transient
  prefill error (``serve.prefill``), draft fault (``serve.draft``) and
  mid-verify faults (``serve.verify`` error + stall) are absorbed by the
  degraded-decode / retry / plain-tick-fallback paths;
* **survivor parity** — the chaos pass serves with speculative decoding
  and chunked prefill ON while the clean reference runs the PLAIN greedy
  path (``Scheduler(speculative=False)``); every request that finished
  normally (``eos``/``length``) produced the same token stream;
* **overload pages** — an ``SLOMonitor`` over the shipped ``SERVING_SLOS``,
  driven on a synthetic clock, fires on the shed burst;
* **recovery** — after ``disarm_all()``, tokens/s is back within 10 % of a
  never-faulted control engine on the same model (medians of ``--reps``
  passes each, the two engines interleaved in one process).

Faults are armed at fixed hit counts, ``retry_sleep`` is stubbed, the OOM
victim is a deterministic largest-footprint choice and the submission
order is fixed: a re-run gives the same event log and survivor set.

Usage::

    python3 torch_tools/torch_chaos_serve.py --smoke   # tiny CPU config
    python3 torch_tools/torch_chaos_serve.py --json    # one JSON object

``--smoke`` (and the default) run the JAX harness's tiny config on the CPU
(vocab 256, hidden 64, 2 layers, 4 slots, 64 positions, chunk 4,
``spec_k`` 4). ``chip_smoke.py``'s ``serving_chaos`` phase calls
:func:`run_chaos` with GPT-2 124M on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the JAX harness's tiny CPU configuration
SMOKE = dict(max_batch=4, max_len=64, prefill_buckets=(8, 16),
             prefill_chunk=4, max_new=8, prompt_lens=(4, 8))
SPEC_K = 4
MAX_QUEUE = 4
N_PROMPTS = 24


def smoke_model(seed=0):
    """The JAX harness's tiny GPT on the CPU, weights from ``seed``."""
    import torch

    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=2, max_position_embeddings=SMOKE["max_len"],
                    hidden_dropout=0.0, attention_dropout=0.0)
    return GPTForCausalLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def build_engines(model, *, max_batch, max_len, prefill_buckets,
                  prefill_chunk):
    """TWO identically warmed engines over the same model: the chaos
    subject and a never-faulted CONTROL. The recovery check compares the
    two in interleaved passes, so slow host drift cancels. Every step —
    per-bucket prefill, decode, chunked prefill, verify — runs once up
    front: chaos measures the steady state, not first calls."""
    from paddle_tpu_torch.serving import GenerationEngine

    engines = []
    for _ in range(2):
        eng = GenerationEngine(model, max_batch=max_batch, max_len=max_len,
                               prefill_buckets=prefill_buckets,
                               spec_k=SPEC_K, prefill_chunk=prefill_chunk,
                               device=model.device)
        for b in eng.prefill_buckets:
            eng.prefill(0, [1] * min(b - 1, max_len - 2))
        eng.decode_once(np.zeros(max_batch, np.int32))
        off, tok = 0, None
        warm = [1] * (prefill_chunk + 1)  # exactly two chunks
        while tok is None:
            tok = eng.prefill_chunk_step(0, warm, off)
            off += prefill_chunk
        # a verify does not advance lengths, so warming leaves no state
        eng.verify_once(np.zeros((max_batch, SPEC_K + 1), np.int32))
        engines.append(eng)
    return engines[0], engines[1]


def make_prompts(vocab, n, seed, lo, hi):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, int(rng.randint(lo, hi))).tolist()
            for _ in range(n)]


def _new_requests(prompts, max_new):
    from paddle_tpu_torch.serving import Request

    return [Request(prompt=list(p), max_new_tokens=max_new) for p in prompts]


def run_clean(eng, prompts, max_new):
    """Reference pass through the PLAIN greedy path (speculation off):
    idx → tokens."""
    from paddle_tpu_torch.serving import Scheduler

    sched = Scheduler(eng, speculative=False)
    reqs = _new_requests(prompts, max_new)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return {i: list(r.tokens) for i, r in enumerate(reqs)}


def _sync(eng):
    import torch

    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def _tps_pass(eng, prompts, max_new):
    """One full serving pass → tokens/s; decodes 4× the chaos budget so a
    pass is long enough for the 10 % bar to sit above timing noise."""
    from paddle_tpu_torch.serving import Request, Scheduler

    sched = Scheduler(eng)
    reqs = [Request(prompt=list(p), max_new_tokens=4 * max_new)
            for p in prompts]
    _sync(eng)
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    fin = sched.run()
    _sync(eng)
    wall = time.perf_counter() - t0
    return sum(len(r.tokens) for r in fin) / wall


def measure_pair(eng_a, eng_b, prompts, max_new, reps=3):
    """Median tokens/s of ``reps`` passes of each engine, INTERLEAVED
    (b, a, b, a, ...) so both sample the same host conditions; also
    every pass's figure."""
    a_vals, b_vals = [], []
    for _ in range(reps):
        b_vals.append(_tps_pass(eng_b, prompts, max_new))
        a_vals.append(_tps_pass(eng_a, prompts, max_new))
    return (statistics.median(a_vals), statistics.median(b_vals), a_vals,
            b_vals)


def run_chaos(seed=0, reps=3, model=None, *, max_batch=SMOKE["max_batch"],
              max_len=SMOKE["max_len"],
              prefill_buckets=SMOKE["prefill_buckets"],
              prefill_chunk=SMOKE["prefill_chunk"], max_new=SMOKE["max_new"],
              prompt_lens=SMOKE["prompt_lens"], prompt_vocab=None):
    """Clean → chaos → recovery on ``model`` (default: the tiny CPU GPT;
    the engines run where the model lies). ``prompt_lens`` is the
    ``[lo, hi)`` range of prompt lengths; prompts draw their ids from
    ``[0, prompt_vocab)`` (default: the model's vocabulary; a small one
    repeats n-grams, which gives the draft proposer something to propose).
    Returns a result dict with ``ok`` and the list of contract
    ``problems`` (empty on a green run)."""
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.profiler import telemetry, tracing
    from paddle_tpu_torch.profiler.slo import SERVING_SLOS, SLOMonitor
    from paddle_tpu_torch.serving import FINISH_REASONS, Request, Scheduler

    model = model if model is not None else smoke_model(seed)
    model.eval()
    eng, control = build_engines(
        model, max_batch=max_batch, max_len=max_len,
        prefill_buckets=prefill_buckets, prefill_chunk=prefill_chunk)
    prompts = make_prompts(prompt_vocab or model.cfg.vocab_size, N_PROMPTS,
                           seed, *prompt_lens)
    clean_streams = run_clean(eng, prompts, max_new)

    problems = []
    counters = {}
    alerts = []
    reason_counts = {}
    survivors = 0
    diverged = []
    submitted = []
    try:
        inject.disarm_all()
        telemetry.reset()
        telemetry.enable()
        tracing.reset()
        tracing.enable()
        # synthetic clock (+1 s per check): SLO burn windows deterministic
        clk = {"now": 0.0}

        def clock():
            clk["now"] += 1.0
            return clk["now"]

        monitor = SLOMonitor(SERVING_SLOS, clock=clock,
                             sinks=[alerts.append])
        sched = Scheduler(eng, slo=monitor, slo_check_every=1,
                          max_queue=MAX_QUEUE, retry_sleep=lambda s: None)
        # a transient prefill error the retry absorbs, a draft fault and
        # two mid-verify errors that each fall back to a plain tick, an
        # OOM on one of those plain ticks (the third serve.decode hit)
        # that evicts exactly one victim, and a mid-verify stall
        inject.arm("error", "serve.prefill", at=2)
        inject.arm("error", "serve.draft", at=2)
        inject.arm("error", "serve.verify", at=3)
        inject.arm("error", "serve.verify", at=5)
        inject.arm("oom", "serve.decode", at=3)
        inject.arm("stall", "serve.verify", at=7)

        chaos_reqs = _new_requests(prompts, max_new)
        # two requests with an already-expired deadline: deterministic
        # queue-wait timeouts at the first tick
        doomed = [Request(prompt=list(prompts[0]), max_new_tokens=max_new,
                          deadline_s=0.0) for _ in range(2)]
        submitted.extend(doomed)
        for r in doomed:
            sched.submit(r)
        # flood in waves of 8: each overflows the bounded queue, then the
        # scheduler ticks twice before the next wave lands
        for lo in range(0, len(chaos_reqs), 8):
            for r in chaos_reqs[lo:lo + 8]:
                submitted.append(sched.submit(r))
            sched.step()
            sched.step()
        sched.run()
        sched.shutdown()
        inject.disarm_all()

        fin = sched.finished
        if len(fin) != len(submitted):
            problems.append(f"accounting: {len(submitted)} submitted but "
                            f"{len(fin)} finished")
        if len({r.rid for r in fin}) != len(fin):
            problems.append("accounting: a request finished more than once")
        for r in submitted:
            if not r.finished or r.finish_reason not in FINISH_REASONS:
                problems.append(f"rid {r.rid}: no terminal finish_reason "
                                f"(got {r.finish_reason!r})")
                break
        for r in fin:
            reason_counts[r.finish_reason] = \
                reason_counts.get(r.finish_reason, 0) + 1
        for want in ("shed", "timeout", "oom_evicted"):
            if not reason_counts.get(want):
                problems.append(f"chaos produced no {want!r} termination")
        counters = {k: v for k, v in
                    telemetry.get_telemetry().counters().items()
                    if k.startswith("serve.")}
        for reason, counter in (("shed", "serve.shed"),
                                ("timeout", "serve.timeouts"),
                                ("oom_evicted", "serve.oom_evictions"),
                                ("drained", "serve.drained")):
            want = reason_counts.get(reason, 0)
            got = int(counters.get(counter, 0))
            if got != want:
                problems.append(f"{counter}={got} but {want} request(s) "
                                f"finished {reason!r}")
        if not counters.get("serve.degraded_steps"):
            problems.append("injected decode OOM did not count a "
                            "degraded step")
        if not counters.get("serve.spec_ticks"):
            problems.append("chaos pass ran no speculative ticks")
        if int(counters.get("serve.spec_fallback_ticks", 0)) < 2:
            problems.append(
                f"expected both injected verify faults to force plain-"
                f"tick fallbacks, got serve.spec_fallback_ticks="
                f"{counters.get('serve.spec_fallback_ticks', 0)}")
        if not counters.get("serve.prefill_chunks"):
            problems.append("chaos pass never took the chunked-prefill "
                            "path")
        span_names = {s.name for s in tracing.get_tracer().spans()}
        for want in ("shed", "timeout", "oom_evicted"):
            if want in reason_counts and want not in span_names:
                problems.append(f"no {want!r} trace event span recorded")
        if not any(a["metric"] == "serve.shed" for a in alerts):
            problems.append("SLO monitor never fired on the shed burst "
                            f"({len(alerts)} alert(s) total)")
        for i, r in enumerate(chaos_reqs):
            if r.finish_reason in ("eos", "length"):
                survivors += 1
                if r.tokens != clean_streams[i]:
                    at = next(j for j, (a, b) in enumerate(
                        zip(r.tokens + [None], clean_streams[i] + [None]))
                        if a != b)
                    diverged.append({"rid": r.rid, "at": at,
                                     "tokens": len(r.tokens)})
                    problems.append(
                        f"survivor rid {r.rid} diverged from the clean "
                        f"run at token {at}: {r.tokens[at:at + 4]}... vs "
                        f"{clean_streams[i][at:at + 4]}...")
        if survivors == 0:
            problems.append("chaos left no surviving request to check "
                            "parity against")
    except Exception as e:  # noqa: BLE001 — a crash IS the finding
        problems.append(f"scheduler crashed under chaos: {type(e).__name__}: "
                        f"{e}")
    finally:
        inject.disarm_all()
        telemetry.disable()
        tracing.disable()

    # recovery: post-chaos tokens/s against the never-faulted control,
    # interleaved under the same host conditions
    recovery_tps, clean_tps, rec_all, clean_all = measure_pair(
        eng, control, prompts, max_new, reps=reps)
    if recovery_tps < 0.9 * clean_tps:
        problems.append(f"post-chaos throughput {recovery_tps:.1f} tok/s "
                        f"recovered to less than 90% of the clean control "
                        f"{clean_tps:.1f} tok/s")

    return {
        "ok": not problems,
        "problems": problems,
        "submitted": len(submitted),
        "finish_reasons": reason_counts,
        "survivors": survivors,
        "diverged": diverged,
        "slo_alerts": len(alerts),
        "clean_tokens_per_sec": clean_tps,
        "recovery_tokens_per_sec": recovery_tps,
        "clean_passes": clean_all,
        "recovery_passes": rec_all,
        "counters": {k: v for k, v in sorted(counters.items())},
        "device": str(eng.device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny CPU config (also the default); nonzero "
                         "exit on any contract violation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3,
                    help="throughput samples per median (clean + recovery)")
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON object")
    args = ap.parse_args(argv)

    result = run_chaos(seed=args.seed, reps=args.reps)
    if args.json:
        print(json.dumps(result))
    else:
        status = "OK" if result["ok"] else "FAILED"
        print(f"torch_chaos_serve {status} ({result['device']}): "
              f"{result['submitted']} submitted, "
              f"reasons {result['finish_reasons']}, "
              f"{result['survivors']} survivor(s) token-exact, "
              f"{result['slo_alerts']} SLO alert(s), clean "
              f"{result['clean_tokens_per_sec']:.2f} tok/s → recovery "
              f"{result['recovery_tokens_per_sec']:.2f} tok/s")
        for p in result["problems"]:
            print(f"  problem: {p}", file=sys.stderr)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
