"""What hapi's ``Model.fit`` and the ``DataLoader`` cost GPT-2 124M's train
step, on one NVIDIA card.

    python3 torch_tools/torch_hapi_loader_cost.py

Runs ``chip_smoke.py``'s ``hapi_gpt2`` step (GPT-2 124M, bf16 with fp32
LayerNorms, AdamW multi_precision, ``F.cross_entropy`` on the full logits,
batch 24 x 1024, 3 warm-up and 10 timed steps, the loss read back at the
first step and every 5th) fed five ways, in turns: a hand-written loop over
a list of host batches (through ``io.DeviceLoader``) and over a
``DataLoader`` with 2 worker processes; ``Model.fit`` over the same
process-worker ``DataLoader``, over an in-process one and over an iterator
of host batches. For each run it prints ms a step on the device clock,
each timed step's device ms, the step's body (the step's own calls, host
clock) and the host gap before it (fetching and staging the batch). Needs a
CUDA card and the kernel build (K5-K8).
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
        print("torch_hapi_loader_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import DeviceLoader
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import library

    print(cs._card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    library()
    warm, timed = cs.HAPI_STEPS
    b, s = cs.HAPI_BATCH, cs.HAPI_SEQ
    n = (warm + timed) * b
    inputs, labels = cs._token_sequences(np, 15, n, s, 50304)
    np.random.seed(1234)
    perm = np.random.permutation(n)
    batches = [(inputs[perm[i:i + b]], labels[perm[i:i + b]])
               for i in range(0, n, b)]

    def source(kind):
        if kind == "list":
            return iter(batches)
        kw = dict(num_workers=2, use_process=True) if kind == "proc" else {}
        return paddle.io.DataLoader(paddle.io.TensorDataset([inputs, labels]),
                                    batch_size=b, shuffle=True, **kw)

    def mark(rec, what):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        rec.append((what, ev, time.perf_counter()))

    def fence(step):
        return step == 0 or (step + 1) % cs.HAPI_LOG_FREQ == 0

    def loop(src, rec):
        model = cs._gpt124m(torch, 0)
        model.train()
        opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                     parameters=model.parameters(),
                                     multi_precision=True)
        np.random.seed(1234)
        for step, (ids, lab) in enumerate(DeviceLoader(src,
                                                       device=model.device)):
            mark(rec, "begin")
            loss = F.cross_entropy(model(ids), lab)
            loss.backward()
            opt.step()
            opt.clear_grad()
            if fence(step):
                float(loss.detach())
            mark(rec, "end")

    def hapi(src, rec):
        model = cs._gpt124m(torch, 0)
        m = paddle.Model(model)
        m.prepare(paddle.optimizer.AdamW(learning_rate=1e-4,
                                         parameters=model.parameters(),
                                         multi_precision=True),
                  paddle.nn.CrossEntropyLoss())

        class Marks(paddle.callbacks.Callback):
            def on_train_batch_begin(self, step, logs=None):
                mark(rec, "begin")

            def on_train_batch_end(self, step, logs=None):
                mark(rec, "end")

        np.random.seed(1234)
        m.fit(src, epochs=1, log_freq=cs.HAPI_LOG_FREQ, verbose=0,
              callbacks=[Marks()])

    for name, run, kind in (("loop_list", loop, "list"),
                            ("hapi_proc", hapi, "proc"),
                            ("hapi_list", hapi, "list"),
                            ("hapi_single", hapi, "single"),
                            ("loop_proc", loop, "proc"),
                            ("loop_list", loop, "list"),
                            ("hapi_proc", hapi, "proc"),
                            ("loop_proc", loop, "proc")):
        rec = []
        torch.cuda.synchronize()
        run(source(kind), rec)
        torch.cuda.synchronize()
        ends = [r for r in rec if r[0] == "end"]
        begins = [r for r in rec if r[0] == "begin"]
        steps = [a[1].elapsed_time(c[1])
                 for a, c in zip(ends[warm - 1:], ends[warm:])]
        print(name, json.dumps({
            "step_ms": sum(steps) / timed,
            "steps_ms": [round(x, 2) for x in steps],
            "body_host_ms": [round(1e3 * (e[2] - g[2]), 2)
                             for g, e in zip(begins[warm:], ends[warm:])],
            "gap_host_ms": [round(1e3 * (g[2] - e[2]), 2)
                            for e, g in zip(ends[warm - 1:], begins[warm:])]}))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
