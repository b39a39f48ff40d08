"""``chip_smoke.py``'s phases from two checkouts of the repo, alternated on
one NVIDIA card.

    python3 torch_tools/torch_ab_phases.py OTHER_ROOT [--rounds 2]
        [--phases training_phase recipe_phase paddle_api_train_phase]
        [--log ab_phases.jsonl]

Runs the named phases of ``chip_smoke.py`` from ``OTHER_ROOT`` (another
checkout: the parent commit unpacked with ``git archive`` into ``_parent/``,
say) and from this checkout, in the order other, this, this, other
(``--rounds`` such pairs), each run in a process of its own, so that the
two trees meet the card in both orders in one call. The kernel library is
built once when both checkouts hold the same ``csrc/``. Prints the card's
name and power limit, then one line a run and phase: the tree, the
phase's seconds and its step, forward and backward milliseconds (JSON);
the phases' whole results go to ``--log``, one JSON line a run and phase.
Needs a CUDA card; any failed check in a phase fails the run.
"""
from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("training_phase", "recipe_phase", "paddle_api_train_phase")
MARK = "AB_PHASE "
#: the keys of a phase's result printed on its line
KEYS = ("step_ms", "forward_ms", "backward_ms", "optimizer_ms",
        "scaler_clip_ms", "tokens_per_s")


def child(root, phases):
    """Run ``phases`` of ``root``'s ``chip_smoke.py`` in this process."""
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    assert os.path.dirname(os.path.abspath(cs.__file__)) == root, cs.__file__
    from paddle_tpu_torch.ops.cuda import library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    library()
    timer = cs._Timer(torch)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:  # clocks up before timing
        timer.flush.add_(1)
    torch.cuda.synchronize()
    for name in phases:
        t = time.perf_counter()
        out = getattr(cs, name)(torch, np)
        out = out[-1] if isinstance(out, tuple) else out
        print(MARK + json.dumps({"phase": name,
                                 "seconds": time.perf_counter() - t,
                                 "result": out}, default=str), flush=True)
        torch.cuda.empty_cache()


def _same_sources(a, b):
    cmp = filecmp.dircmp(os.path.join(a, "paddle_tpu_torch", "csrc"),
                         os.path.join(b, "paddle_tpu_torch", "csrc"))
    return not (cmp.left_only or cmp.right_only or cmp.diff_files)


def _build_dir(root):
    return os.path.join(root, "paddle_tpu_torch", "ops", "cuda", "_build")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--phases", nargs="+", default=list(PHASES))
    ap.add_argument("--log", default="ab_phases.jsonl")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(os.path.abspath(args.other), args.phases)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_ab_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    other = os.path.abspath(args.other)
    print(cs._card_line(), flush=True)
    trees = {"other": other, "this": ROOT}
    order = ["other", "this", "this", "other"] * (args.rounds // 2) + (
        ["other", "this"] if args.rounds % 2 else [])
    log = open(args.log, "w")
    t_start = time.perf_counter()
    for i, which in enumerate(order):
        root = trees[which]
        if i == 1 and _same_sources(other, ROOT):
            # the first run built the library; the same sources share it
            shutil.copytree(_build_dir(trees[order[0]]), _build_dir(root),
                            dirs_exist_ok=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--child",
             "--phases", *args.phases],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(MARK)]
        for ln in lines:
            rec = json.loads(ln[len(MARK):])
            rec.update(run=i, tree=which)
            log.write(json.dumps(rec) + "\n")
            res = rec["result"]
            brief = {k: res[k] for k in KEYS if k in res}
            print(f"run {i} {which} {rec['phase']} {rec['seconds']:.1f} s "
                  f"{json.dumps(brief)}", flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-6000:])
            print(f"run {i} ({which}) failed: exit {proc.returncode}")
            return 1
    log.close()
    print(f"total {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
