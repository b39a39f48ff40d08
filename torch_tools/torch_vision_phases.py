"""The vision part of ``chip_smoke.py`` alone, on one NVIDIA card.

    python3 torch_tools/torch_vision_phases.py [--only PHASE ...]

Runs ``chip_smoke.py``'s vision phases, nothing else (``--only``: the
phases named, e.g. ``shufflenet_v2_train_phase``): ``resnet50_train``
(``tools/bench_resnet.py``'s train step at batch 128 x 224 x 224, bf16 with
fp32 batch norms, channels-last), ``resnet50_vs_plain`` (bf16 channels-last
against fp32 NCHW, and the layout route alone), ``resnet50_eval``,
``lenet``, ``mobilenet_v3_large_train`` (batch 128 x 224 x 224, bf16
channels-last, the classifier's dropout live), ``mobilenet_vs_plain``,
``nn_random_layers``, ``shufflenet_v2_train`` (ShuffleNetV2 x1.0 at batch
128 x 224 x 224, bf16 channels-last), ``shufflenet_vs_plain`` and
``nn_second_half`` (the transposed convs, resampling, norms, pools, losses
and sparse attention against the CPU port). The vision path launches none
of the port's kernels, so nothing is built. Prints the card's name and
power limit, then one line a phase (JSON). The quick check after a change to the vision path. Needs a CUDA
card; any failed check raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_vision_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    t0 = time.perf_counter()
    print(cs._card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for fn in (cs.resnet50_train_phase, cs.resnet50_vs_plain,
               cs.resnet50_eval_phase, cs.lenet_phase,
               cs.mobilenet_v3_large_train_phase, cs.mobilenet_vs_plain,
               cs.nn_random_layers_phase, cs.shufflenet_v2_train_phase,
               cs.shufflenet_vs_plain, cs.nn_second_half_phase):
        if args.only and fn.__name__ not in args.only:
            continue
        t = time.perf_counter()
        out = fn(torch, np)
        print(fn.__name__, f"{time.perf_counter() - t:.1f} s",
              json.dumps(out), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
