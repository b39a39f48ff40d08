"""The encoder part of ``chip_smoke.py`` alone, on one NVIDIA card.

    python3 torch_tools/torch_encoder_phases.py

Builds the kernels, then runs ``chip_smoke.py``'s checks at the encoders'
shapes and its encoder phases, nothing else: K7/K8 at 16384 and 24576
rows of 1024 (eps 1e-12; K7 also in fp32) and K9-K11 at BERT-large's and
ERNIE-large's MLM heads against their plain versions, then
``bert_score``, ``bert_large_mlm``, the MLM steps against the plain run,
and ``ernie_large``. Prints the card's name and power limit, the build
seconds, then one line a case or phase (JSON). About 100 s on an H100,
against ``chip_smoke.py``'s 240: the quick check after a change to the
encoder path. Needs a CUDA card; any failed check raises.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_encoder_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import build_info, library

    t0 = time.perf_counter()
    print(cs._card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    library()
    print(f"build {time.perf_counter() - t0:.1f} s "
          f"{json.dumps(build_info().get('per_source', {}))}")
    timer = cs._Timer(torch)
    gen = torch.Generator().manual_seed(1)
    for rows, name, dt in ((16384, "bert_rows=16384x1024", None),
                           (24576, "bert_rows=24576x1024", None),
                           (16384, "bert_rows=16384x1024_fp32",
                            torch.float32)):
        fwd, bwd = cs._layer_norm_train_cases(
            torch, timer, gen, rows, 1024, name, eps=1e-12, dtype=dt,
            backward=dt is None)
        if bwd is not None:
            bwd.pop("_split")
        print("K7", json.dumps(fwd))
        print("K8", json.dumps(bwd), flush=True)
    cs.FCE_CASES = [c for c in cs.FCE_CASES if c[0] in ("bert", "ernie")]
    for name, cases in zip(("K9", "K10", "K11"),
                           cs.fused_ce_kernel_phase(torch, timer)[:3]):
        for c in cases:
            print(name, json.dumps(c), flush=True)
    for fn in (cs.bert_score_phase, cs.bert_mlm_phase, cs.bert_mlm_vs_plain,
               cs.ernie_large_phase):
        t = time.perf_counter()
        out = fn(torch, np)
        print(fn.__name__, f"{time.perf_counter() - t:.1f} s",
              json.dumps(out), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
