"""Where the time goes in the port's encoder paths, on one NVIDIA card.

    python3 torch_tools/torch_encoder_profile.py [--steps N]

Runs, with ``chip_smoke.py``'s models and data (random weights from a
seed):

* BERT-large MLM training (``tools/bench_bert.py``'s recipe: bf16 with fp32
  LayerNorms, dropout 0, ``AdamW(lr=1e-4, multi_precision=True)``, the
  chunked MLM loss) at s128 x 128 and s512 x 48: 2 warm-up steps, then
  ``--steps`` steps (default 2) under ``torch.profiler``;
* one ``EncoderScorer`` call of BERT-large (``max_batch`` 32, 32 requests
  in the 512 bucket, fp32 from the first attention output on) after one
  warm-up call, under ``torch.profiler``.

For each it prints one JSON line: the wall time of the profiled window
(host clock around work ending in a synchronize), the device time summed
over CUDA kernels, the device's idle share (one minus their ratio: the
kernels run on one stream), the device time by kind of kernel (cuBLAS
products, K7/K8, softmax, the dropout-free elementwise and reduction
kernels, the optimizer's, ...) and the 12 kernels with the most device
time. The first line is the card's name and power limit. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: kernel kinds by name (first match wins)
KINDS = (
    ("K7/K8 (layer_norm.cu)", r"ln_fwd|ln_bwd"),
    ("K9-K11 (fused_ce.cu)", r"ce_fwd|ce_bwd"),
    ("products (cuBLAS)", r"gemm|xmma|nvjet|cutlass|sm90_|s16816|s1688"),
    ("softmax", r"softmax"),
    ("optimizer (multi-tensor / Adam)", r"multi_tensor|adam|foreach"),
    ("reductions", r"reduce_kernel|Reduce"),
    ("copies and casts", r"copy|Copy|cast"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def _kind(name, kinds=KINDS):
    for kind, pat in kinds:
        if re.search(pat, name):
            return kind
    return "other"


def _profile(torch, fn):
    """Wall ms of ``fn()`` (ending in a synchronize) under the profiler, and
    the device ms of every kernel it launched, by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is None:
            continue
        if str(e.device_type).endswith("CUDA") and e.key:
            total = getattr(e, "self_device_time_total", None)
            if total is None:
                total = getattr(e, "self_cuda_time_total", 0)
            if total > 0:
                kernels[e.key] = kernels.get(e.key, 0.0) + total / 1e3
    return wall, kernels


def _report(name, wall, kernels, per, by=KINDS):
    busy = sum(kernels.values())
    kinds = {}
    for k, ms in kernels.items():
        kinds[_kind(k, by)] = kinds.get(_kind(k, by), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"what": name, "per": per, "wall_ms": wall,
            "device_kernel_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[k[:120], ms] for k, ms in top]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_encoder_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.models import (BertForPretraining,
                                         BertForSequenceClassification)
    from paddle_tpu_torch.ops.cuda import library

    library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    for seq, batch in cs.BERT_MLM_SHAPES:
        model = cs._bert_large(torch, 0, BertForPretraining, no_dropout=True)
        batches = cs._mlm_batches(np, seq, 2 + args.steps, batch, seq,
                                  model.cfg.vocab_size)
        # warm-up steps, then the profiled steps with the optimizer's state
        # in place (``_train`` makes one optimizer a call)
        from paddle_tpu_torch.io import DeviceLoader
        from paddle_tpu_torch.optimizer import AdamW

        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    multi_precision=True)
        model.train()

        def steps(part):
            for ids, labels in DeviceLoader(part, buffer_size=2,
                                            device=model.device):
                model.loss(ids, labels).backward()
                opt.step()
                opt.clear_grad()

        steps(batches[:2])
        wall, kernels = _profile(torch, lambda: steps(batches[2:]))
        print(json.dumps(_report(f"bert_large_mlm s{seq} x {batch}", wall,
                                 kernels, f"{args.steps} steps")))
        del model, opt
        torch.cuda.empty_cache()
    model = cs._bert_large(torch, 0, BertForSequenceClassification,
                           num_classes=2)
    scorer = model.scorer(max_batch=32, seq_buckets=(128, 512))
    rng = np.random.RandomState(31)
    seqs = [rng.randint(1, model.bert.cfg.vocab_size, int(n))
            for n in rng.randint(129, 513, 32)]
    scorer.score(seqs)
    wall, kernels = _profile(torch, lambda: scorer.score(seqs))
    print(json.dumps(_report("bert_score (32, 512)", wall, kernels,
                             "1 scorer call")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
