#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Requires CUDA (exits non-zero without a card) and prints the card's name
   and power limit as ``nvidia-smi`` reports them.
2. Builds the kernels from ``paddle_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (timed).
3. Kernel phase: every kernel of the serving and training paths against its
   plain PyTorch version at the shapes GPT-2 124M gives it (serving: K4,
   K7, K4 also at GPT-3 Large's head dim 96; training at batch 24 x 1024:
   K5, K6, K7, K8; K9-K11 in 6; K1-K3, and K7/K8 at width 1536, in 8;
   K4 also at head dims 320 and 512, bf16 and fp32), in bf16, with the
   kernel's, the plain version's and one library call's time (CUDA events,
   L2 flushed before every launch) beside the kernel's bound.
   Tolerance: kernel and plain version compute in fp32 and round once to
   bf16, so they agree to one bf16 step, |Δ| <= 2^-7 · max(1, |ref|) (K6's
   dq is summed with atomics, K8's dgamma/dbeta over 24576 or 16384 rows,
   both in fp32: orders that differ far below a bf16 step). K5 runs K1's
   tensor-core forward and rounds p to bf16 before p v, as its plain
   version does (K1's 64-key online softmax); K4 (prefill on K1's tiles,
   decode and verify on split keys) and K6 (one tensor-core pass) round p
   (K6 also ds * scale) where their plain versions do: also a quarter step
   in relative L2 norm. K4's split-key cases give their key parts as
   measured (launched: the grid its launcher reports; live: the parts
   that wrote a record into a NaN-filled workspace), which must match
   the plain version's part rule, and the merge's bits on a second
   launch; K6 is timed beside K2 + K3 on the same packed strides
   (the witness, held to K6's plain version) and beside SDPA's backward
   timed before and after it.
4. Serving phase (a main path): GPT-2 124M (vocab 50304, hidden 768, 12
   layers, 12 heads, 1024 positions) with random weights from
   ``torch.manual_seed(0)``, bf16 with fp32 LayerNorms, behind
   ``GenerationEngine(max_batch=8, max_len=1024, prefill_chunk=256,
   spec_k=4)`` and a ``Scheduler`` answering 8 requests (four of them take
   chunked prefill), then one ``engine.generate`` on a 700-token prompt
   (prefill bucket 1024). Launch counts are zeroed just before and read
   just after; every request must end with exactly one finish reason.
   Then one prefill's and one decode tick's logits are held against the
   same model run on the plain versions on the card: max |Δ| <= 0.125
   (bf16 activations through 12 layers; logits have std ~0.5), and a small
   fp32 model served on the card must give the CPU port's greedy tokens
   and logits within 1e-3.
5. Training phase (the other main path): ``bench.py``'s TPU train step on
   the same model (dropout 0, bf16 with fp32 LayerNorms,
   ``AdamW(lr=1e-4, multi_precision=True)``), batch 24 x 1024, fed through
   ``io.DeviceLoader``: 3 warm-up steps and 10 timed ones, each
   ``model.loss``, ``backward``, ``opt.step``, ``opt.clear_grad``. Launch
   counts are zeroed just before the 13 steps and read just after. Then
   3 steps at batch 8 on the kernels against the same 3 steps on the
   plain versions (same init and batches): losses within 2e-3 (bf16
   activations round at other places through 12 layers, and AdamW's first
   steps are ±lr wherever a gradient is near 0; the loss is ~10.8, a mean
   over 8192 tokens; the gap measured on an H100 was 1.6e-4 to 2.7e-4,
   and the limit is ten times that. AdamW's update does not see a
   gradient's overall scale, so a gradient wrong only in scale shows in
   the kernel phase, not here),
   and a small fp32 model (2 heads of 64, seq 1024, so
   K5/K6 run) trained 3 steps on the card against the CPU port: losses
   within 1e-4.
6. Flash CE (in the kernel phase): K9, K10 and K11 against their plain
   versions at the train step's shape (24576 tokens, hidden 768, vocab
   50304, bf16) and at an odd shape (300 tokens, vocab 1000, hidden 128,
   bias, two ignored labels; bf16 and fp32): within one bf16 step of the
   largest reference value for bf16, 5e-5 absolute for fp32. Each K9 case
   gives the library's plan for it (``kernel_plan`` mode 2: route, vocab
   ranges, CTAs; bf16/fp16 the warp-specialised wgmma kernel) and its share
   of the bound, and each K10/K11 case its plan (route, CTAs of a cluster,
   slice columns) and share; at the train shape K9 must give the same
   loss and lse bits, and K10 and K11 the same dx, dW and db bits, on a
   second launch. Beside them, the chunked loop the flag replaces, forward
   and backward ms and peak memory, K10 + K11 against its backward, and
   K9 against its forward and against the same product alone as one
   cuBLAS call (``torch.matmul(x, w.t())``, the yardstick: it moves the
   same tiles) at the train shape and GPT-3 Large's.
7. Recipe phase (the main path of the pretraining slice): GPT-3 Small's
   recipe (Brown et al. 2020, Table 2.1, Appendix B) on GPT-2 124M built in
   fp32 from ``torch.manual_seed(0)``: ``amp.decorate(O2, bf16)``,
   AdamW(0.9, 0.95, 1e-8, weight decay 0.1 but not on biases and
   LayerNorms), ``LinearWarmup(CosineAnnealingDecay(6e-4, 8, 6e-5), 5)``,
   ``ClipGradByGlobalNorm(1.0)``, ``GradScaler(2^15)`` and
   ``FLAGS_enable_flash_ce``, batch 24 x 1024 through ``DeviceLoader``, 3
   warm-up and 10 timed steps: tokens/s, the step split (forward,
   backward, unscale + finite check + clip, optimizer), peak memory, K9,
   K10 and K11 once a step and no call of the chunked loop, the loss
   falling. Then 3 recipe steps at batch 8 on the kernels against the
   plain versions (losses within 2e-3, as in 5) and a small fp32 model
   trained 3 recipe steps on the card (fp32 K9-K11) against the CPU port
   (losses within 1e-4).
8. K1-K3 (in the kernel phase): the layout-swapping flash forward, dq and
   dk/dv against their plain versions at GPT-3 Large's train shape (b 8,
   s 2048, 16 heads of 96, bf16 and fp16, causal, q/k/v views of one fused
   qkv buffer), at b 2, sq 300 > sk 200 causal with a (2, 1, sq, sk) bias,
   at a (1, 16, sq, sk) bias, and in fp32: within one step of the type per
   element (bf16 2^-7, fp16 2^-10) and a quarter of one in relative L2
   norm, 5e-5 in fp32; rows with no visible key exactly 0 in out and dq, a
   key no row sees exactly 0 in dk and dv. Each case gives its route
   (K1-K3: ``mma.sync`` tensor cores at bf16/fp16 up to head dim 128,
   ``fma`` at fp32 and wider heads; K2 rounds ds * scale to the input type
   before ds k, as its plain version does), achieved TFLOP/s and share of
   its bound. Beside them SDPA's forward and backward at the train shape.
   Right after the build, ``cuobjdump -sass`` of the library must show
   tensor-core instructions (HMMA, or HGMMA) in every bf16 K1, K2, K3,
   K4-prefill and K6 tensor-core function and HGMMA (wgmma) in every bf16
   K10/K11 cluster kernel and in the bf16 K9 kernel, and ptxas's registers
   and spills of the bf16 attention and K9-K11 wgmma kernels, and of every
   K9 instantiation, are printed.
   K7 and K8 at GPT-3 Large's LayerNorm shape (16384 rows of 1536, bf16 x,
   fp32 gamma and beta) and at 2048 rows of 5120 (wider than 4096: the
   general kernels) within one bf16 step, beside ``F.layer_norm`` and
   ``native_layer_norm_backward``. Every K7/K8 case gives the library's
   kernel for it (``kernel_plan``) and its share of the bound; K8's cases
   give its row kernel's and its column reduction's device time apart
   (``torch.profiler`` kernel names) and must give the same bits on a
   second launch; ptxas's registers and spills of the K7/K8
   instantiations on the paths are printed after the build.
9. GPT-3 Large phase (the main path of this slice): GPT-3 Large (Brown et
   al. 2020, Table 2.1: 24 layers, d_model 1536, 16 heads of 96, context
   2048; vocab 50304) built in fp32 from ``torch.manual_seed(0)``, the
   recipe of 7 with its peak learning rate 2.5e-4 (cosine to 2.5e-5) and
   the chunked loss (``FLAGS_enable_flash_ce`` off, the default), batch
   8 x 2048 through ``DeviceLoader``, 2 warm-up and 5 timed steps: K1, K2
   and K3 24 times a step, K7 and K8 49 times, K5/K6 never; losses finite
   and falling, no skipped step; tokens/s, the step split, peak memory.
   Then one 64-token greedy ``generate`` of the trained model (300-token
   prompt, ``max_len`` 2048: K4 at head dim 96) with its prefill and
   decode logits within 0.125 of the plain run; 3 recipe steps at batch
   2 x 2048 against the plain versions (losses within 2e-3); a small fp32
   model with 2 heads of 96 (2 layers, seq 1024) trained 3 recipe steps
   on the card against the CPU port (losses within 1e-4).
10. Attention dropout and the widened shapes (in the kernel phase): K5/K6
    at GPT-2 124M's train shape and K1-K3 at GPT-3 Large's, bf16, causal,
    p = 0.1, against their plain versions on the same seed (the plain
    versions draw the kernels' Philox bits: the dropout-0 limits hold),
    each timed beside its dropout-0 time on the same inputs; the device
    Philox (a test-only launch) against ``ops/philox.py`` bit for bit on
    the train shape's whole mask, its keep rate within 4 sigma of 0.9.
    K1-K3 at head dims 16, 48, 112 and 256 (b 2, s 1024, 8 heads, bf16,
    causal) and above 256 (320 and 512 in bf16, 320 in fp32: the chunked
    kernels), K4 at GPT-3 2.7B's head dim 80 (32 heads; prefill and
    decode) and at 320 and 512, and K9-K11 at GPT-3 Large's loss shape (16384 tokens, hidden
    1536, vocab 50304, bf16: the hidden width streamed) and in fp16 (one
    fp16 step of the largest value), each against its plain version.
11. gpt2_dropout phase (the main path of the dropout slice): GPT-2 124M at
    ``GPTConfig``'s defaults (hidden and attention dropout 0.1), the recipe
    of 7 with ``FLAGS_enable_flash_ce``, batch 24 x 1024 through
    ``DeviceLoader``, 2 warm-up and 5 timed steps: K5 and K6 12 times a
    step, every launch with in-kernel dropout, K9-K11 once a step, the
    loss falling and no skipped step; tokens/s beside the dropout-0
    recipe's of 7. Then 3 steps at batch 8 against the plain versions from
    one seed (both runs drop the same elements; losses within 2e-3), and a
    second kernel run whose first forward loss must equal the first run's
    bit for bit.
12. The encoder family (the main paths of the encoder slice), after the
    GPT phases, random weights from ``torch.manual_seed``:
    ``bert_score``: ``BertForSequenceClassification(bert_large(),
    num_classes=2)`` (24 layers, hidden 1024, 16 heads, vocab 30522), bf16
    with fp32 LayerNorms, eval, behind ``model.scorer(max_batch=32,
    seq_buckets=(128, 512))``: 96 requests, lengths log-uniform in 16-512
    from a seed and in ascending order (both buckets used, most rows
    padded, so attention promotes against the fp32 padding mask and K7
    sees fp32 rows), one warm-up ``score`` and one timed: sequences/s,
    tokens/s, ms a scorer call, exactly the padded shapes (32, 128) and
    (32, 512); logits within 0.125 of the same scorer on the plain versions
    and of each request scored alone, unpadded (with a keep-mask of ones,
    so through the same fp32 promotion). ``bert_large_mlm``:
    ``tools/bench_bert.py``'s recipe (``BertForPretraining(bert_large())``,
    dropout 0, bf16 with fp32 LayerNorms, ``AdamW(lr=1e-4,
    multi_precision=True)``, labels on 15 % of the positions, the chunked
    MLM loss) at s128 x 128 and s512 x 48 (its ``DEFAULT_BATCH``) through
    ``DeviceLoader``, 2 warm-up and 5 timed steps each: tokens/s, the step
    split, peak memory, K7 and K8 50 times a step, no flash attention
    (s <= 512: the dense path); then 3 steps at s128 x 128 within 2e-3 of
    the plain run. ``ernie_large``: ``ErnieForPretraining(ernie_large())``
    at its defaults (dropout 0.1, task ids, vocab 18000), built fp32, then
    ``amp.decorate(O2, bf16)``, AdamW(1e-4), ``FLAGS_enable_flash_ce`` (K9-
    K11 once a step with the head's bias live), MLM labels from
    ``ErnieDataCollator`` and NSP labels, batch 16 x 512, 2 warm-up and 3
    timed steps: tokens/s; its first loss within 2e-3 of the plain run from
    the same seed. The kernel phase holds K7/K8 at the encoders' width (16384
    and 24576 rows of 1024, eps 1e-12, bf16; K7 also in fp32; K7 gives
    beta on rows of zero variance) and K9-K11 at BERT-large's head (16384 x
    1024 x 30522, bf16) and ERNIE-large's (8192 x 1024 x 18000, bf16, bias,
    85 % of the labels ignored: K10/K11's bounds count the labelled rows).
13. The vision path (the main path of the vision slice), after the encoder
    phases, random weights from ``torch.manual_seed`` and seeded synthetic
    images and labels drawn on the card; cuDNN's algorithm search on and
    layout autotune on inside each phase (``_vision_setup``), both
    restored after; TF32 off. ``resnet50_train``: ``tools/bench_resnet.py``'s
    train step, ``resnet50(num_classes=1000)`` in bf16 with fp32 batch
    norms, channels-last convolutions, ``Momentum(0.1, 0.9, weight decay
    1e-4, multi_precision)``, cross entropy on fp32 logits, batch 128 x 3 x
    224 x 224, 3 warm-up and 10 timed steps: images/s over the device
    clock, the step split, peak memory and the analytic model-FLOP share
    (3 x 2 x 4.089e9 FLOP an image against the dense bf16 peak); it fails
    without cuDNN, unless layer1.0.conv2's output is channels-last and its
    batch norm's output bf16 with fp32 statistics that moved.
    ``resnet50_vs_plain``: 3 steps at batch 32 from one seed in bf16
    channels-last and in fp32 NCHW: the first step's logits within
    ``VS_FP32_STEPS`` bf16 steps of the largest fp32 logit and the first
    loss within ``VS_FP32_LOSS_TOL``; then the bf16 model's eval logits
    channels-last against a copy run NCHW within ``LAYOUT_STEPS`` steps.
    ``resnet50_eval``: images/s of the eval forward at batch 128.
    ``lenet``: LeNet, 5 Adam(1e-3) steps on one seeded batch of 64 x 1 x
    28 x 28: the loss falls. None of them launches K1-K11.
14. The Paddle-API surface (the main path of the API slice), after the
    vision phases. ``paddle_api``: GPT-2 124M's train step written against
    the API (``import paddle_tpu_torch as paddle``, ``set_device("gpu")``,
    the model built with no ``device``, bf16 with fp32 LayerNorms,
    batches from ``paddle.to_tensor``, ``loss = model.loss(...)``,
    ``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``,
    ``float(loss)``), batch 24 x 1024, 3 + 5 steps, between two runs of
    the same steps through plain tensors (the training phase's calls, same
    seed and batches): the step time of each, so both orders are timed in
    one call; the first step's loss the same bits in all three, a forward
    through the API on the trained weights the plain tensors' bits, and
    the later losses within 2e-3 of both plain runs (K6 sums dq with
    atomics: the two plain runs' own spread is printed); K5-K8 launched.
    ``paddle_api checkpoint``: ``paddle.save(model.state_dict())`` then a
    fresh model's ``set_state_dict(paddle.load(...))``, the same eval
    logits bit for bit, for that GPT-2 124M (bf16 saved as fp32) and for
    ResNet-50 at batch 32 after a train-mode forward moved its batch-norm
    buffers. ``paddle_api op sweep``: every entry of
    ``ops/op_table.py`` (every op of the registry) on CUDA against the
    port on the CPU, fp32 and, where the op takes floats and is not an
    fp32-only decomposition, bf16, forward and the gradient of
    ``sum(out * c)``; limits ``SWEEP_*_TOL``; an op CUDA refuses fails the
    phase. It prints ``paddle_api ops held N/N`` and the sweep's time.
15. The training runtime (the main path of the hapi slice), after the API
    phases. ``hapi_gpt2``: GPT-2 124M (``bench.py``'s configuration, bf16
    with fp32 LayerNorms, dropout 0) behind ``paddle.Model(net).prepare(
    AdamW(1e-4, multi_precision=True), nn.CrossEntropyLoss())`` and
    ``fit`` over an in-memory ``io.TensorDataset`` of 13 x 24 sequences of
    1025 ids (inputs ``ids[:-1]``, labels ``ids[1:]``) through a
    ``DataLoader`` with 2 worker processes (forkserver), shuffled,
    ``log_freq=5``: 3 warm-up and 10 timed steps between two hand-written
    loops (forward, ``F.cross_entropy``, backward, step, clear_grad) over
    the same batches in the same order from the same init; ms a step on
    the device clock and tokens/s of each, and whether hapi's median step
    lies within ``HAPI_STEP_TOL`` of the loops' (printed, not enforced:
    host-paced steps); the first loss the loops' bits and the fence losses within the
    loops' spread; K5-K8 12/12/25/25 times a step; the timed steps'
    synchronising calls (``torch.cuda.set_sync_debug_mode("warn")``) by
    call site, hapi adding none over the loops' but its fences; then
    ``evaluate`` on 2 batches (a forward's loss bits) and ``predict`` of 4
    sequences of 128 stacked (a forward's logits bits). ``hapi_resume``:
    the same model at batch 8 x 1024, one shuffled epoch of 12 steps
    (AdamW on a cosine schedule) twice uninterrupted, once with
    ``fit(resume=dir, ckpt_freq=4)`` and a SIGTERM injected after step 6
    (``TrainingPreempted``), once resumed by a fresh model and optimizer:
    parameters, fp32 masters and moments, the schedule, every generator,
    numpy's state and the cursor bit for bit, steps 7-12 on run 1's input
    ids, losses within the uninterrupted runs' spread; the checkpoint's
    bytes, save and restore seconds. ``hapi_lenet``: LeNet behind
    ``prepare(Adam(1e-3), CrossEntropyLoss(), Accuracy(topk=(1, 2)))``,
    one epoch of ``fit`` at batch 64 over 60,000 synthetic MNIST images
    (``synthetic_mnist``, built on the host), ``evaluate`` and ``predict``
    over 10,000: images/s, the metric line, eval top-1 at least
    ``LENET_MIN_ACC``; no K1-K11.
16. Prints the ``kernels`` JSON line (K1-K11; K1-K6 with their routes,
    K1-K4 and K6 with their bf16 HMMA counts and ptxas registers and
    spills, K9-K11 with their plan a case and their bf16 wgmma kernels'
    HGMMA counts and registers and spills (K9 also beside the cuBLAS
    product), K4 with its key parts at decode, K6 with the K2 + K3 witness,
    K1-K3 and K5/K6 with a ``dropout`` entry; every entry's
    ``launches_by_path`` names the vision paths with their launches, 0),
    then the result line last.

Any failure raises and exits non-zero; nothing is printed as a result then.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12       # dense tensor-core bf16
H100_FP32_FLOPS = 67e12        # fp32 outside the tensor cores
BF16_STEP = 2.0 ** -7
FP16_STEP = 2.0 ** -10
LOGIT_TOL = 0.125
SMALL_LOGIT_TOL = 1e-3
TRAIN_LOSS_TOL = 2e-3
SMALL_LOSS_TOL = 1e-4


def _require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _descendants():
    """The processes below this one that still run (a zombie has ended),
    from each process's parent in /proc."""
    parent, state = {}, {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        state[int(pid)], parent[int(pid)] = fields[0], int(fields[1])
    found, frontier = [], [os.getpid()]
    while frontier:
        kids = [p for p, pp in parent.items() if pp in frontier]
        found += [p for p in kids if state[p] != "Z"]
        frontier = kids
    return sorted(found)


def _card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


class _Timer:
    """Mean device time of ``fn`` over ``iters`` launches, each preceded by
    a write of a buffer larger than the 50 MB L2, so every launch finds its
    inputs in device memory as a serving step does."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20):
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _bf16_err(got, want, step=BF16_STEP):
    """Max |got - want|, held to one step of the type (bf16 by default):
    |Δ| <= step · max(1, |want|)."""
    g, w = got.float(), want.float()
    _require(bool(g.isfinite().all()), "kernel output is finite")
    err = (g - w).abs()
    _require(bool((err <= step * w.abs().clamp_min(1.0)).all()),
             f"kernel within one step ({step:.3g}) of its plain version "
             f"(max err {err.max().item():.3g})")
    return float(err.max())


def _rel_l2_err(got, want, step=BF16_STEP):
    """||got - want|| / ||want||, held to a quarter of a step of the type
    (bf16 by default): one rounding of each output gives far less, while a
    dropped tile or a wrong scale gives percents even where every value is
    below 1 (there ``_bf16_err``'s per-element limit is an absolute
    step)."""
    g, w = got.float(), want.float()
    err = float((g - w).norm() / w.norm().clamp_min(1e-30))
    _require(err <= step / 4, f"kernel within {step / 4:.3g} of "
             f"its plain version in relative L2 norm ({err:.3g})")
    return err


def _bound(nbytes, flops, peak):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, timer):
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.cuda import flash_attention as k4
    from paddle_tpu_torch.ops.cuda import layer_norm as k7

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    ln_cases, fa_cases = [], []

    # 8 rows (the decode shape) is timed after the others: the first
    # timing after the clock warm-up has read slow before
    for rows in (256, 1024, 8):
        x = (torch.randn(rows, 768, generator=gen) * 2).to(dev, torch.bfloat16)
        g = (1 + 0.1 * torch.randn(768, generator=gen)).to(dev)
        b = (0.1 * torch.randn(768, generator=gen)).to(dev)
        err = _bf16_err(k7.layer_norm(x, g, b), k7.layer_norm_plain(x, g, b))
        nbytes = rows * 768 * 2 * 2 + 2 * 768 * 4
        bound, by = _bound(nbytes, rows * 768 * 8, H100_FP32_FLOPS)
        # torch's layer_norm takes no fp32 gamma/beta with bf16 x: the
        # yardstick gets bf16 copies, made before timing
        gl, bl = g.to(x.dtype), b.to(x.dtype)
        ln_cases.append({
            "case": f"rows={rows}", "shape": [rows, 768],
            "max_abs_err": err,
            "ms": timer(lambda: k7.layer_norm(x, g, b)),
            "plain_ms": timer(lambda: k7.layer_norm_plain(x, g, b)),
            "library_ms": timer(lambda: TF.layer_norm(x, (768,), gl, bl)),
            "bound_ms": bound, "bound_by": by,
            "kernel_plan": k7.kernel_plan(x)})
        ln_cases[-1]["share_of_bound"] = bound / ln_cases[-1]["ms"]

    h, d = 12, 64

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    cache_k, cache_v = rand(8, 1024, h, d), rand(8, 1024, h, d)
    pos0 = torch.tensor([0, 100, 300, 511, 700, 900, 1018, 5],
                        dtype=torch.int32)
    cases = {
        # name: (q, k, v, q_pos, kv_len)
        "prefill": (rand(1, 1024, h, d), rand(1, 1024, h, d),
                    rand(1, 1024, h, d),
                    torch.arange(1024, dtype=torch.int32)[None],
                    torch.tensor([700], dtype=torch.int32)),
        # a chunk reads one slot's row of the cache in place (strided view)
        "chunk": (rand(1, 256, h, d), cache_k[3:4], cache_v[3:4],
                  (256 + torch.arange(256, dtype=torch.int32))[None], None),
        "decode": (rand(8, 1, h, d), cache_k, cache_v, pos0[:, None], None),
        # slot 7 has kv_len 0: its rows are fully masked and give 0
        "verify": (rand(8, 5, h, d), cache_k, cache_v,
                   pos0[:, None] + torch.arange(5, dtype=torch.int32)[None],
                   torch.tensor([5, 105, 305, 516, 705, 905, 1023, 0],
                                dtype=torch.int32)),
    }
    # GPT-3 Large's head dim (16 heads of 96): a 300-token prompt in its
    # 512-row prefill bucket, and a decode tick over 2048-row caches
    h96, d96 = 16, 96

    def rand96(*shape):
        return torch.randn(*shape, h96, d96, generator=gen).to(
            dev, torch.bfloat16)

    cases["prefill_d96"] = (rand96(1, 512), rand96(1, 512), rand96(1, 512),
                            torch.arange(512, dtype=torch.int32)[None],
                            torch.tensor([300], dtype=torch.int32))
    cases["decode_d96"] = (rand96(8, 1), rand96(8, 2048), rand96(8, 2048),
                           torch.tensor([[0], [299], [511], [900], [1200],
                                         [1700], [2047], [64]],
                                        dtype=torch.int32), None)
    # GPT-3 2.7B's head dim (Brown et al. 2020, Table 2.1: 32 heads of 80),
    # which K4 runs in its 96-wide instantiation: the same prefill and
    # decode shapes

    def rand80(*shape):
        return torch.randn(*shape, 32, 80, generator=gen).to(
            dev, torch.bfloat16)

    cases["prefill_d80"] = (rand80(1, 512), rand80(1, 512), rand80(1, 512),
                            torch.arange(512, dtype=torch.int32)[None],
                            torch.tensor([300], dtype=torch.int32))
    cases["decode_d80"] = (rand80(8, 1), rand80(8, 2048), rand80(8, 2048),
                           torch.tensor([[0], [299], [511], [900], [1200],
                                         [1700], [2047], [64]],
                                        dtype=torch.int32), None)
    # head dims above 256 (the chunked kernel: q and K in 128-column
    # chunks, the output in 256-column slices): prefill and decode at 320
    # (a ragged last chunk), 512 (two slices) in bf16, 320 in fp32

    def wide(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, generator=gen).to(dev, dt)

    for name, hw, dw, dt in (("d320", 4, 320, torch.bfloat16),
                             ("d512", 2, 512, torch.bfloat16),
                             ("d320_fp32", 2, 320, torch.float32)):
        cases["prefill_" + name] = (
            wide(2, 512, hw, dw, dt=dt), wide(2, 512, hw, dw, dt=dt),
            wide(2, 512, hw, dw, dt=dt),
            torch.arange(512, dtype=torch.int32)[None].repeat(2, 1),
            torch.tensor([300, 512], dtype=torch.int32))
        cases["decode_" + name] = (
            wide(2, 1, hw, dw, dt=dt), wide(2, 1024, hw, dw, dt=dt),
            wide(2, 1024, hw, dw, dt=dt),
            torch.tensor([[700], [1023]], dtype=torch.int32), None)
    for name, (q, k, v, qp, kl) in cases.items():
        b, sq, h, d = q.shape
        qp = qp.to(dev)
        kl = None if kl is None else kl.to(dev)
        sk = k.shape[1]
        got = k4.flash_attention_cached(q, k, v, qp, kl)
        want = k4.flash_attention_cached_plain(q, k, v, qp, kl)
        err = (_max_rel_err(got, want, "fp32") if q.dtype == torch.float32
               else _bf16_err(got, want))
        col = torch.arange(sk, device=dev)
        ok = col[None, None, :] <= qp[:, :, None]
        if kl is not None:
            ok = ok & (col[None, None, :] < kl[:, None, None])
        pairs = int(ok.sum()) * h
        # K/V rows this data needs: each slot's prefix up to its last
        # visible key
        vis = ok.any(1)                                       # [b, sk]
        keys = int((torch.where(vis, col, -1).amax(-1) + 1).sum())
        esz = q.element_size()
        nbytes = (2 * q.numel() * esz + 2 * keys * h * d * esz
                  + qp.numel() * 4 + (0 if kl is None else kl.numel() * 4))
        bound, by = _bound(nbytes, 4 * d * pairs,
                           H100_FP32_FLOPS if esz == 4 else H100_BF16_FLOPS)
        mask = ok[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        # the route as the kernel library plans it, which must be the one
        # the plain version followed
        route, parts, _ = k4.cached_plan(b, sq, sk, h, d, q.dtype)
        if route != k4.cached_route(q.dtype, sq, d):
            raise RuntimeError(f"K4 {name}: the library routes {route}, the "
                               f"plain version {k4.cached_route(q.dtype, sq, d)}")
        extra = {}
        if route == "split":
            # key parts, measured: launched (the split kernel's grid, as its
            # launcher reports it) and live (the parts that wrote their
            # records into a NaN-filled workspace; the rest exit at once)
            probe, launched, live = k4.flash_attention_cached_parts(
                q, k, v, qp, kl)
            need = torch.where(vis, col, -1).amax(-1) + 1           # [b]
            want_live = h * int(((need + k4.PART_KEYS - 1)
                                 // k4.PART_KEYS).sum())
            if (launched != k4.split_parts(sk) * b * h or parts
                    != k4.split_parts(sk) or live != want_live):
                raise RuntimeError(
                    f"K4 {name}: {launched} parts launched and {live} live, "
                    f"the plain version's rule gives "
                    f"{k4.split_parts(sk) * b * h} and {want_live}")
            if not torch.equal(probe, got):
                raise RuntimeError(f"K4 {name}: the part merge gave other "
                                   "bits on a second launch")
            extra = {"parts_launched": launched, "parts_live": live}
        if q.dtype != torch.float32:
            extra["rel_l2_err"] = _rel_l2_err(got, want)
        fa_cases.append({
            "case": name, "shape": {"q": list(q.shape), "kv": list(k.shape),
                                    "dtype": str(q.dtype)},
            "route": route, **extra, "max_abs_err": err,
            "ms": timer(lambda: k4.flash_attention_cached(q, k, v, qp, kl)),
            "plain_ms": timer(
                lambda: k4.flash_attention_cached_plain(q, k, v, qp, kl)),
            "library_ms": timer(lambda: TF.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)),
            "bound_ms": bound, "bound_by": by})
    return ln_cases, fa_cases


def _packed_inputs(torch, gen, b, sq, sk, h, d):
    """q, k, v as (b, s, h·d) views of fused qkv buffers (row stride 3·h·d),
    as the model's qkv projection hands them to the packed kernels."""
    qkv_q = torch.randn(b, sq, 3, h, d, generator=gen).to("cuda", torch.bfloat16)
    qkv_k = (qkv_q if sk == sq else torch.randn(
        b, sk, 3, h, d, generator=gen).to("cuda", torch.bfloat16))
    return (qkv_q[:, :, 0].reshape(b, sq, h * d),
            qkv_k[:, :, 1].reshape(b, sk, h * d),
            qkv_k[:, :, 2].reshape(b, sk, h * d))


#: fp32 K7 against its plain version: both compute in fp32 in other orders
FP32_LN_STEP = 5e-5


def _layer_norm_train_cases(torch, timer, gen, rows, feat, name, eps=1e-5,
                            dtype=None, backward=True):
    """K7 and K8 against their plain versions at a train step's shape (bf16
    x and dy unless ``dtype`` says otherwise, fp32 gamma and beta, epsilon
    ``eps``), beside ``F.layer_norm`` and ``native_layer_norm_backward`` on
    copies of gamma and beta in x's dtype, and K8's dgamma and dbeta held
    to the same bits on a second launch. K8's case keeps its call
    (``_split``) to time its row kernel and its column reduction apart at
    the end of the run. At ``eps`` below 1e-5 (the encoders' 1e-12) K7 is
    also held on rows of zero variance. ``backward=False``: K7 alone."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.cuda import layer_norm as k7

    dt = torch.bfloat16 if dtype is None else dtype
    step = FP32_LN_STEP if dt == torch.float32 else BF16_STEP
    esz = torch.tensor([], dtype=dt).element_size()
    x = (torch.randn(rows, feat, generator=gen) * 2).to("cuda", dt)
    g = (1 + 0.1 * torch.randn(feat, generator=gen)).to("cuda")
    bt = (0.1 * torch.randn(feat, generator=gen)).to("cuda")
    dy = torch.randn(rows, feat, generator=gen).to("cuda", dt)
    gl, bl = g.to(x.dtype), bt.to(x.dtype)
    err = _bf16_err(k7.layer_norm(x, g, bt, eps),
                    k7.layer_norm_plain(x, g, bt, eps), step)
    bound, by = _bound(rows * feat * esz * 2 + 2 * feat * 4, rows * feat * 8,
                       H100_FP32_FLOPS)
    fwd = {
        "case": name, "shape": [rows, feat], "dtype": str(dt), "eps": eps,
        "max_abs_err": err,
        "ms": timer(lambda: k7.layer_norm(x, g, bt, eps)),
        "plain_ms": timer(lambda: k7.layer_norm_plain(x, g, bt, eps)),
        "library_ms": timer(lambda: TF.layer_norm(x, (feat,), gl, bl, eps)),
        "bound_ms": bound, "bound_by": by, "kernel_plan": k7.kernel_plan(x)}
    fwd["share_of_bound"] = bound / fwd["ms"]
    if eps < 1e-5:
        # rows of zero variance (padding rows, a constant embedding): the
        # statistics rest on eps alone, and the output is beta exactly (a
        # constant with bf16's 8 significant bits sums exactly in fp32)
        xz = x.clone()
        xz[:64] = xz[:64, :1].to(torch.bfloat16).to(dt)
        got = k7.layer_norm(xz, g, bt, eps)
        fwd["zero_variance_err"] = _bf16_err(
            got, k7.layer_norm_plain(xz, g, bt, eps), step)
        _require(torch.equal(got[:64], bt.to(dt).expand(64, feat)),
                 f"K7 gives beta on rows of zero variance at {name}")
        del xz, got
    if not backward:
        return fwd, None
    got = k7.layer_norm_bwd(x, g, dy, eps)
    want = k7.layer_norm_bwd_plain(x, g, dy, eps)
    err = max(_bf16_err(a, w, step) for a, w in zip(got, want))
    again = k7.layer_norm_bwd(x, g, dy, eps)
    _require(all(torch.equal(a, b) for a, b in zip(got, again)),
             f"K8 gives the same bits twice at {name}")
    # x and dy read, dx written, gamma read, dgamma and dbeta written
    bound, by = _bound(rows * feat * esz * 3 + 3 * feat * 4, rows * feat * 20,
                       H100_FP32_FLOPS)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [feat], gl, bl, eps)
    bwd = {
        "case": name, "shape": [rows, feat], "dtype": str(dt), "eps": eps,
        "max_abs_err": err,
        "ms": timer(lambda: k7.layer_norm_bwd(x, g, dy, eps)),
        "plain_ms": timer(lambda: k7.layer_norm_bwd_plain(x, g, dy, eps)),
        "library_ms": timer(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [feat], mean, rstd, gl, bl, [True, True, True])),
        "bound_ms": bound, "bound_by": by,
        "kernel_plan": k7.kernel_plan(x, dy)}
    bwd["share_of_bound"] = bound / bwd["ms"]
    # timed apart at the end of the run (the profiler stays out of the
    # phases' timings)
    bwd["_split"] = lambda: k7.layer_norm_bwd(x, g, dy, eps)
    return fwd, bwd


def _k8_launches_apart(torch, timer, fn, iters=20):
    """K8's two launches apart: device ms of its row kernel (dx, and a
    workspace row of dgamma/dbeta partials a CTA) and of its column
    reduction, from ``torch.profiler``'s kernel names over ``iters`` calls
    of ``fn`` (L2 flushed before each)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        key = ("row_kernel_ms" if "ln_bwd_rows" in e.key
               or "ln_bwd_general" in e.key else
               "reduce_ms" if "ln_bwd_reduce" in e.key else None)
        if key is not None:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = getattr(e, "cuda_time_total", 0)
            out[key] = total / e.count / 1e3
    _require(len(out) == 2 and all(v > 0 for v in out.values()),
             f"the profiler times K8's two launches ({out})")
    return out


def training_kernel_phase(torch, timer):
    """K5, K6 and K8 (and K7 at the training shapes) against their plain
    versions at GPT-2 124M's train-step shapes (batch 24 x 1024: 24576
    rows, 12 heads of 64), bf16, plus one small packed-attention case with
    sq > sk and a bias that masks a row (zero output and gradients); K7
    and K8 also at GPT-3 Large's (16384 rows of 1536) and at 2048 rows of
    5120 (wider than 4096: the general kernels)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.cuda import flash_attention as k1
    from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5

    gen = torch.Generator(device="cpu").manual_seed(1)
    fwd_cases, bwd_cases, ln_fwd, ln_bwd = [], [], [], []
    h, d = 12, 64
    for name, b, sq, sk, use_bias in (("train", 24, 1024, 1024, False),
                                      ("masked", 2, 100, 60, True)):
        q, k, v = _packed_inputs(torch, gen, b, sq, sk, h, d)
        bias = None
        if use_bias:
            bias = 0.5 * torch.randn(sq, sk, generator=gen)
            bias[3] = k5.NEG_INF
            bias = bias.to("cuda")
        out, lse = k5.flash_attention_packed_fwd(q, k, v, h, bias, True)
        want_out, want_lse = k5.flash_attention_packed_fwd_plain(
            q, k, v, h, bias, True)
        err = max(_bf16_err(out, want_out), _bf16_err(lse, want_lse))
        rel = _rel_l2_err(out, want_out)
        dout = torch.randn(b, sq, h * d, generator=gen).to("cuda",
                                                            torch.bfloat16)
        grads = k5.flash_attention_packed_bwd(q, k, v, out, lse, dout, h,
                                              bias, True)
        want = k5.flash_attention_packed_bwd_plain(q, k, v, out, lse, dout, h,
                                                   bias, True)
        berr = max(_bf16_err(g, w) for g, w in zip(grads, want))
        brel = max(_rel_l2_err(g, w) for g, w in zip(grads, want))
        witness = None
        if name == "train":
            # the witness: K2 + K3 on the same packed strides, (b, s, h, d)
            # views of q, k, v, out and dout, held to K6's plain version
            wargs = (q.reshape(b, sq, h, d), k.reshape(b, sk, h, d),
                     v.reshape(b, sk, h, d), out.reshape(b, sq, h, d), lse,
                     dout.reshape(b, sq, h, d), None, True)
            wgrads = (k1.flash_attention_bwd_dq(*wargs),
                      *k1.flash_attention_bwd_dkv(*wargs))
            for g, w in zip(wgrads, want):
                _bf16_err(g.reshape(w.shape), w)
                _rel_l2_err(g.reshape(w.shape), w)
            del wgrads
            witness = {
                "k2_ms": timer(lambda: k1.flash_attention_bwd_dq(*wargs)),
                "k3_ms": timer(lambda: k1.flash_attention_bwd_dkv(*wargs))}
            witness["k2_plus_k3_ms"] = witness["k2_ms"] + witness["k3_ms"]
        if use_bias:
            masked = torch.zeros(sq, dtype=torch.bool, device="cuda")
            masked[:sq - sk] = True
            masked[3] = True
            _require(bool((out[:, masked] == 0).all())
                     and bool((grads[0][:, masked] == 0).all()),
                     "rows with no visible key give 0 output and dq")
        # causal pairs this data needs: query i sees keys 0 .. i + sk - sq
        pairs = b * h * sum(max(0, min(sk, i + sk - sq + 1))
                            for i in range(sq))
        io = q.numel() * 2
        kvio = 2 * k.numel() * 2
        lse_b = b * h * sq * 4
        bias_b = 0 if bias is None else bias.numel() * 4
        fb, fby = _bound(io + kvio + io + lse_b + bias_b, 4 * d * pairs,
                         H100_BF16_FLOPS)
        bb_, bby = _bound(3 * io + kvio + lse_b + bias_b + io + kvio,
                          10 * d * pairs, H100_BF16_FLOPS)
        # the yardstick: SDPA on contiguous (b, h, s, d) copies
        qt, kt, vt = (t.reshape(b, -1, h, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        lib_mask = None
        if bias is not None:
            row = torch.arange(sq, device="cuda")[:, None]
            col = torch.arange(sk, device="cuda")[None, :]
            lib_mask = torch.where(col <= row + sk - sq, bias,
                                   k5.NEG_INF).to(torch.bfloat16)
        lib_causal = lib_mask is None

        def lib_fwd():
            return TF.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=lib_mask, is_causal=lib_causal)

        shape = {"q": [b, sq, h * d], "kv": [b, sk, h * d], "heads": h}
        # K5 runs K1's forward (tensor cores at bf16); K6 is FMA
        fwd_cases.append({
            "case": name, "shape": shape, "max_abs_err": err,
            "rel_l2_err": rel, "route": k1.kernel_route(torch.bfloat16, d),
            "runs": "fwd_tc_kernel (csrc/flash_attention.cu)",
            "ms": timer(lambda: k5.flash_attention_packed_fwd(
                q, k, v, h, bias, True)),
            "plain_ms": timer(lambda: k5.flash_attention_packed_fwd_plain(
                q, k, v, h, bias, True)),
            "library_ms": timer(lib_fwd),
            "bound_ms": fb, "bound_by": fby})
        ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
        lib_out = TF.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=lib_mask, is_causal=lib_causal)
        gl = dout.reshape(b, sq, h, d).transpose(1, 2).contiguous()

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), gl,
                                       retain_graph=True)

        # SDPA's backward timed before and after K6 (each after its
        # warm-up): the library time is their mean
        lib_before = timer(lib_bwd)
        ms = timer(lambda: k5.flash_attention_packed_bwd(
            q, k, v, out, lse, dout, h, bias, True))
        lib_after = timer(lib_bwd)
        bwd_cases.append({
            "case": name, "shape": shape, "max_abs_err": berr,
            "rel_l2_err": brel, "route": k1.kernel_route(torch.bfloat16, d),
            "ms": ms,
            "plain_ms": timer(lambda: k5.flash_attention_packed_bwd_plain(
                q, k, v, out, lse, dout, h, bias, True)),
            "library_ms": (lib_before + lib_after) / 2,
            "library_ms_before_after": [lib_before, lib_after],
            "bound_ms": bb_, "bound_by": bby})
        if witness is not None:
            bwd_cases[-1]["witness_k2_k3"] = witness
        del ql, kl, vl, lib_out

    # GPT-2 124M's train shape, and GPT-3 Large's (batch 8 x 2048, width
    # 1536): 49 launches each a step on its path; width 5120 (above 4096,
    # C5: the general kernels) at 2048 rows
    for rows, feat, name in ((24 * 1024, 768, "rows=24576"),
                             (8 * 2048, 1536, "rows=16384x1536"),
                             (2048, 5120, "rows=2048x5120")):
        f, b = _layer_norm_train_cases(torch, timer, gen, rows, feat, name)
        ln_fwd.append(f)
        ln_bwd.append(b)
    # the encoders' (width 1024, eps 1e-12): BERT-large's MLM steps (128 x
    # 128 and 48 x 512 tokens) in bf16, and K7 on the fp32 rows a padding
    # mask gives the scorer (32 x 512)
    for rows, name, dt in ((16384, "bert_rows=16384x1024", None),
                           (24576, "bert_rows=24576x1024", None),
                           (16384, "bert_rows=16384x1024_fp32",
                            torch.float32)):
        f, b = _layer_norm_train_cases(torch, timer, gen, rows, 1024, name,
                                       eps=1e-12, dtype=dt,
                                       backward=dt is None)
        ln_fwd.append(f)
        if b is not None:
            ln_bwd.append(b)
    return fwd_cases, bwd_cases, ln_fwd, ln_bwd


def flash_kernel_phase(torch, timer):
    """K1, K2 and K3 against their plain versions: GPT-3 Large's train
    shape (b 8, s 2048, 16 heads of 96, bf16, causal; q, k, v as views of
    one fused qkv buffer), an odd causal shape with sq > sk (rows 0..99 see
    no key) and a (2, 1, sq, sk) bias that also masks row 3 and key 5, a
    (1, 16, sq, sk) bias, the train shape in fp16, and fp32 cases (the odd
    one, and the small d = 96 model's shape). Tolerance: one step of the
    type per element (bf16 2^-7, fp16 2^-10) and a quarter of one in
    relative L2 norm, 5e-5 in fp32; the rows that see no key are exactly 0
    in out and dq, the key no row sees exactly 0 in dk and dv. Head dims
    16, 48, 112, 256, and above 256 (320 with a ragged last chunk and 512
    in bf16, 320 in fp32: the chunked kernels), at two steps a element.
    Each case reports the route it ran (K1-K3: ``mma.sync`` tensor cores
    at bf16/fp16 up to head dim 128, ``fma`` at fp32 and wider heads), its
    achieved TFLOP/s (the causal work this data needs over the kernel's
    time) and its share of its bound (bound ms over ms)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.cuda import flash_attention as k1

    gen = torch.Generator(device="cpu").manual_seed(9)
    k1_cases, k2_cases, k3_cases = [], [], []
    # name: (b, sq, sk, h, d, dtype, causal, bias (B, H) or None)
    shapes = [("train", 8, 2048, 2048, 16, 96, "bf16", True, None),
              ("train_fp16", 8, 2048, 2048, 16, 96, "fp16", True, None),
              ("odd", 2, 300, 200, 16, 96, "bf16", True, (2, 1)),
              ("head_bias", 2, 384, 384, 16, 96, "bf16", False, (1, 16)),
              ("odd_fp32", 2, 300, 200, 16, 96, "fp32", True, (2, 1)),
              ("small_fp32", 2, 1024, 1024, 2, 96, "fp32", True, None),
              # head dims run in the next instantiated width (16, 64, 128;
              # 256 on FMA with 32 x 32 tiles)
              ("d16", 2, 1024, 1024, 8, 16, "bf16", True, None),
              ("d48", 2, 1024, 1024, 8, 48, "bf16", True, None),
              ("d112", 2, 1024, 1024, 8, 112, "bf16", True, None),
              ("d256", 2, 1024, 1024, 8, 256, "bf16", True, None),
              # above 256: the head dim in 256-column chunks, the output
              # in 256-column slices (FMA in every type)
              ("d320", 2, 1024, 1024, 4, 320, "bf16", True, None),
              ("d512", 2, 1024, 1024, 2, 512, "bf16", True, None),
              ("d320_fp32", 2, 512, 512, 2, 320, "fp32", True, None)]
    types = {"bf16": (torch.bfloat16, BF16_STEP),
             "fp16": (torch.float16, FP16_STEP), "fp32": (torch.float32, None)}
    for name, b, sq, sk, h, d, dt, causal, bias_bh in shapes:
        tdt, step = types[dt]
        esz = 4 if dt == "fp32" else 2
        # fp16 has the bf16 tensor-core peak (H100 data sheet)
        peak = H100_FP32_FLOPS if dt == "fp32" else H100_BF16_FLOPS
        qkv = torch.randn(b, sq, 3, h, d, generator=gen).to("cuda", tdt)
        kv = qkv if sq == sk else torch.randn(
            b, sk, 3, h, d, generator=gen).to("cuda", tdt)
        q, k, v = qkv[:, :, 0], kv[:, :, 1], kv[:, :, 2]
        bias = None
        if bias_bh is not None:
            bias = 0.5 * torch.randn(*bias_bh, sq, sk, generator=gen)
            bias[:, :, 3] = k1.NEG_INF
            bias[:, :, :, 5] = k1.NEG_INF
            bias = bias.to("cuda")
        dout = torch.randn(b, sq, h, d, generator=gen).to("cuda", tdt)
        rel = [0.0, 0.0, 0.0]

        # the head-dim cases sum up to 1024 terms an output element whose p
        # and ds * scale round to bf16 in the kernel and in the plain
        # version from fp32 values a few last bits apart (ex2.approx against
        # exp), so an element can end a little over one step apart (1.125
        # steps measured on the H100 at d = 48): two steps a element, and
        # the quarter step in relative L2 norm of every case
        elem = 2 * step if name.startswith("d") and step else step

        def check(i, got, want):
            try:
                if dt == "fp32":
                    return _max_rel_err(got, want, "fp32")
                rel[i] = max(rel[i], _rel_l2_err(got, want, step))
                return _bf16_err(got, want, elem)
            except RuntimeError as e:
                raise RuntimeError(f"{('K1', 'K2', 'K3')[i]} {name}: {e}")

        out, lse = k1.flash_attention_fwd(q, k, v, bias, causal)
        want_out, want_lse = k1.flash_attention_fwd_plain(q, k, v, bias,
                                                          causal)
        err1 = max(check(0, out, want_out), check(0, lse, want_lse))
        del want_out, want_lse
        args = (q, k, v, out, lse, dout, bias, causal)
        dq = k1.flash_attention_bwd_dq(*args)
        err2 = check(1, dq, k1.flash_attention_bwd_dq_plain(*args))
        dk, dv = k1.flash_attention_bwd_dkv(*args)
        want_dk, want_dv = k1.flash_attention_bwd_dkv_plain(*args)
        err3 = max(check(2, dk, want_dk), check(2, dv, want_dv))
        del want_dk, want_dv
        rows = torch.zeros(sq, dtype=torch.bool, device="cuda")
        if causal and sq > sk:
            rows[:sq - sk] = True
        if bias is not None:
            rows[3] = True
            _require(bool((dk[:, 5] == 0).all()) and bool((dv[:, 5] == 0).all()),
                     f"{name}: the key no row sees gives 0 dk and dv")
        _require(bool((out[:, rows] == 0).all())
                 and bool((dq[:, rows] == 0).all()),
                 f"{name}: rows with no visible key give 0 output and dq")
        # (query, key) pairs this data needs: causal i sees 0 .. i + sk - sq
        if causal:
            pairs = b * h * sum(max(0, min(sk, i + sk - sq + 1))
                                for i in range(sq))
        else:
            pairs = b * h * sq * sk
        qb, kb = b * sq * h * d * esz, b * sk * h * d * esz
        lse_b = b * h * sq * 4
        bias_b = 0 if bias is None else bias.numel() * 4
        # K1 reads q, k, v (and the bias), writes out and lse: 2 products;
        # K2 reads q, k, v, out, dout, lse, writes dq: 3 products; K3 reads
        # the same, writes dk and dv: 4 products
        flops = (4 * d * pairs, 6 * d * pairs, 8 * d * pairs)
        b1 = _bound(qb + 2 * kb + bias_b + qb + lse_b, flops[0], peak)
        b2 = _bound(3 * qb + 2 * kb + lse_b + bias_b + qb, flops[1], peak)
        b3 = _bound(3 * qb + 2 * kb + lse_b + bias_b + 2 * kb, flops[2], peak)
        lib_f = lib_b = None
        if name == "train":
            # SDPA computes the same function here (sq = sk, causal, no
            # bias); its backward gives dq, dk and dv in one call
            ql, kl, vl = (t.detach().transpose(1, 2).requires_grad_()
                          for t in (q, k, v))
            lib_f = timer(lambda: TF.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True))
            lib_out = TF.scaled_dot_product_attention(ql, kl, vl,
                                                      is_causal=True)
            gl = dout.transpose(1, 2)
            lib_b = timer(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), gl, retain_graph=True))
            del ql, kl, vl, lib_out
        shape = {"b": b, "sq": sq, "sk": sk, "heads": h, "head_dim": d,
                 "dtype": dt, "causal": causal,
                 "bias": None if bias_bh is None else [*bias_bh, sq, sk]}
        plain_iters = 5
        # K1-K3 take the tensor cores at bf16/fp16 up to head dim 128
        route = k1.kernel_route(tdt, d)
        for cases, err, r, fn, plain, bound, lib, fl, rt in (
                (k1_cases, err1, rel[0],
                 lambda: k1.flash_attention_fwd(q, k, v, bias, causal),
                 lambda: k1.flash_attention_fwd_plain(q, k, v, bias, causal),
                 b1, lib_f, flops[0], route),
                (k2_cases, err2, rel[1],
                 lambda: k1.flash_attention_bwd_dq(*args),
                 lambda: k1.flash_attention_bwd_dq_plain(*args), b2, lib_b,
                 flops[1], route),
                (k3_cases, err3, rel[2],
                 lambda: k1.flash_attention_bwd_dkv(*args),
                 lambda: k1.flash_attention_bwd_dkv_plain(*args), b3, lib_b,
                 flops[2], route)):
            ms = timer(fn)
            cases.append({
                "case": name, "shape": shape, "route": rt,
                "max_abs_err": err, "rel_l2_err": r,
                "ms": ms, "plain_ms": timer(plain, plain_iters),
                "library_ms": lib, "bound_ms": bound[0],
                "bound_by": bound[1], "tflops": fl / ms / 1e9,
                "share_of_bound": bound[0] / ms})
        if lib_b is not None:
            k2_cases[-1]["library_computes"] = "dq, dk and dv in one call"
            k3_cases[-1]["library_computes"] = "dq, dk and dv in one call"
        del qkv, kv, q, k, v, bias, dout, out, lse, dq, dk, dv, args
        torch.cuda.empty_cache()
    return k1_cases, k2_cases, k3_cases


DROPOUT_P = 0.1
DROPOUT_SEED = (0x9E3779B9, 0x243F6A88)


def dropout_kernel_phase(torch, timer):
    """The attention kernels with in-kernel dropout against their plain
    versions on the same seed (the plain versions draw the same Philox
    bits): K5/K6 at GPT-2 124M's train shape (b 24, s 1024, 12 heads of 64)
    and K1-K3 at GPT-3 Large's (b 8, s 2048, 16 heads of 96), bf16, causal,
    p = 0.1, under the dropout-0 limits (one bf16 step a element; K1-K3 a
    quarter of one in relative L2 norm), each timed with and without
    dropout on the same inputs. The device Philox (``csrc/philox.cu``'s
    test-only launch) against ``ops/philox.py`` bit for bit on the train
    shape's mask, and the mask's keep rate within 4 sigma of 1 - p. The
    bound is the dropout-0 bound: the mask's integer work is not counted."""
    from paddle_tpu_torch.ops import philox
    from paddle_tpu_torch.ops.cuda import flash_attention as k1
    from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5

    gen = torch.Generator(device="cpu").manual_seed(17)
    p, seed = DROPOUT_P, DROPOUT_SEED
    b, s, h, d = 24, 1024, 12, 64
    dev_mask = philox.keep_mask_kernel(seed, b, h, s, s, p)
    same = bool(torch.equal(dev_mask, philox.keep_mask(seed, b, h, s, s, p,
                                                       "cuda")))
    _require(same, "the device Philox draws the plain version's mask bit "
             "for bit")
    n = dev_mask.numel()
    rate = float(dev_mask.float().mean())
    sigma = (p * (1 - p) / n) ** 0.5
    _require(abs(rate - (1 - p)) <= 4 * sigma,
             f"keep rate {rate:.6f} within 4 sigma ({sigma:.2e}) of {1 - p}")
    philox_check = {"shape": [b, h, s, s], "bit_identical": same,
                    "keep_rate": rate, "sigma": sigma}
    del dev_mask
    torch.cuda.empty_cache()

    out = {}
    # K5 / K6
    q, k, v = _packed_inputs(torch, gen, b, s, s, h, d)
    dout = torch.randn(b, s, h * d, generator=gen).to("cuda", torch.bfloat16)
    o, lse = k5.flash_attention_packed_fwd(q, k, v, h, None, True, None, p,
                                           seed)
    wo, wl = k5.flash_attention_packed_fwd_plain(q, k, v, h, None, True,
                                                 None, p, seed)
    err5 = max(_bf16_err(o, wo), _bf16_err(lse, wl))
    rel5 = _rel_l2_err(o, wo)
    del wo, wl
    grads = k5.flash_attention_packed_bwd(q, k, v, o, lse, dout, h, None,
                                          True, None, p, seed)
    want = k5.flash_attention_packed_bwd_plain(q, k, v, o, lse, dout, h,
                                               None, True, None, p, seed)
    err6 = max(_bf16_err(a, w) for a, w in zip(grads, want))
    rel6 = max(_rel_l2_err(a, w) for a, w in zip(grads, want))
    del grads, want
    o0, lse0 = k5.flash_attention_packed_fwd(q, k, v, h, None, True)
    shape = {"q": [b, s, h * d], "kv": [b, s, h * d], "heads": h, "p": p}
    out["flash_attention_packed_fwd"] = {
        "case": "train_dropout", "shape": shape, "max_abs_err": err5,
        "rel_l2_err": rel5,
        "ms": timer(lambda: k5.flash_attention_packed_fwd(
            q, k, v, h, None, True, None, p, seed)),
        "ms_dropout_0": timer(lambda: k5.flash_attention_packed_fwd(
            q, k, v, h, None, True)),
        "plain_ms": timer(lambda: k5.flash_attention_packed_fwd_plain(
            q, k, v, h, None, True, None, p, seed), 5)}
    out["flash_attention_packed_bwd"] = {
        "case": "train_dropout", "shape": shape, "max_abs_err": err6,
        "rel_l2_err": rel6,
        "ms": timer(lambda: k5.flash_attention_packed_bwd(
            q, k, v, o, lse, dout, h, None, True, None, p, seed)),
        "ms_dropout_0": timer(lambda: k5.flash_attention_packed_bwd(
            q, k, v, o0, lse0, dout, h, None, True)),
        "plain_ms": timer(lambda: k5.flash_attention_packed_bwd_plain(
            q, k, v, o, lse, dout, h, None, True, None, p, seed), 5)}
    del q, k, v, dout, o, lse, o0, lse0
    torch.cuda.empty_cache()

    # K1-K3
    b, s, h, d = 8, 2048, 16, 96
    qkv = torch.randn(b, s, 3, h, d, generator=gen).to("cuda", torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn(b, s, h, d, generator=gen).to("cuda", torch.bfloat16)
    drop = (p, seed)
    o, lse = k1.flash_attention_fwd(q, k, v, None, True, None, *drop)
    wo, wl = k1.flash_attention_fwd_plain(q, k, v, None, True, None, *drop)
    err1 = max(_bf16_err(o, wo), _bf16_err(lse, wl))
    rel1 = _rel_l2_err(o, wo)
    del wo, wl
    args = (q, k, v, o, lse, dout, None, True, None)
    dq = k1.flash_attention_bwd_dq(*args, *drop)
    want = k1.flash_attention_bwd_dq_plain(*args, *drop)
    err2, rel2 = _bf16_err(dq, want), _rel_l2_err(dq, want)
    del dq, want
    dk, dv = k1.flash_attention_bwd_dkv(*args, *drop)
    wk, wv = k1.flash_attention_bwd_dkv_plain(*args, *drop)
    err3 = max(_bf16_err(dk, wk), _bf16_err(dv, wv))
    rel3 = max(_rel_l2_err(dk, wk), _rel_l2_err(dv, wv))
    del dk, dv, wk, wv
    torch.cuda.empty_cache()
    o0, lse0 = k1.flash_attention_fwd(q, k, v, None, True)
    args0 = (q, k, v, o0, lse0, dout, None, True, None)
    shape = {"b": b, "sq": s, "sk": s, "heads": h, "head_dim": d,
             "dtype": "bf16", "causal": True, "p": p}
    for name, err, rel, fn, fn0, plain in (
            ("flash_attention_fwd", err1, rel1,
             lambda: k1.flash_attention_fwd(q, k, v, None, True, None, *drop),
             lambda: k1.flash_attention_fwd(q, k, v, None, True),
             lambda: k1.flash_attention_fwd_plain(q, k, v, None, True, None,
                                                  *drop)),
            ("flash_attention_bwd_dq", err2, rel2,
             lambda: k1.flash_attention_bwd_dq(*args, *drop),
             lambda: k1.flash_attention_bwd_dq(*args0),
             lambda: k1.flash_attention_bwd_dq_plain(*args, *drop)),
            ("flash_attention_bwd_dkv", err3, rel3,
             lambda: k1.flash_attention_bwd_dkv(*args, *drop),
             lambda: k1.flash_attention_bwd_dkv(*args0),
             lambda: k1.flash_attention_bwd_dkv_plain(*args, *drop))):
        out[name] = {"case": "train_dropout", "shape": shape,
                     "max_abs_err": err, "rel_l2_err": rel, "ms": timer(fn),
                     "ms_dropout_0": timer(fn0), "plain_ms": timer(plain, 3)}
    del qkv, q, k, v, dout, o, lse, o0, lse0, args, args0
    torch.cuda.empty_cache()
    return out, philox_check


def _max_rel_err(got, want, dtype):
    """K9-K11 against their plain versions: one step of the type (bf16
    2^-7, fp16 2^-10) of the largest reference value for 2-byte operands
    (their tile products are exact products summed in fp32 in another
    order, and 2-byte outputs round once), 5e-5 absolute for fp32 ones."""
    g, w = got.float(), want.float()
    _require(bool(g.isfinite().all()), "kernel output is finite")
    err = float((g - w).abs().max())
    step = {"bf16": BF16_STEP, "fp16": FP16_STEP}.get(dtype)
    tol = 5e-5 if step is None else step * float(w.abs().max())
    _require(err <= tol, f"kernel within {tol:.3g} of its plain version "
             f"(max err {err:.3g})")
    return err


#: K9-K11's cases: name, tokens, hidden, vocab, dtype, bias, share of the
#: labels ignored. GPT-3 Large's loss shape (batch 8 x 2048 tokens, hidden
#: 1536: K9 one vocab range, K10/K11 clusters of 4); the encoders' MLM
#: heads (hidden 1024; vocabularies off the 128- and 256-column tiles):
#: BERT-large's at 128 x 128 tokens, no bias, and ERNIE-large's at 16 x 512
#: with its bias and 85 % of the labels ignored (an MLM batch labels 15 %:
#: the router passes the others as label 0 with g = 0); and fp16 operands
FCE_CASES = (
    ("train", 24576, 768, 50304, "bf16", False, 0.0),
    ("large", 16384, 1536, 50304, "bf16", False, 0.0),
    ("bert", 16384, 1024, 30522, "bf16", False, 0.0),
    ("ernie", 8192, 1024, 18000, "bf16", True, 0.85),
    ("odd", 300, 128, 1000, "bf16", True, 0.0),
    ("odd_fp16", 300, 128, 1000, "fp16", True, 0.0),
    ("odd_fp32", 300, 128, 1000, "fp32", True, 0.0))


def fused_ce_kernel_phase(torch, timer):
    """K9, K10 and K11 against their plain versions at the train step's
    shape (24576 tokens, hidden 768, vocab 50304, bf16, no bias), GPT-3
    Large's (16384 x 1536), BERT-large's and ERNIE-large's MLM heads and
    an odd shape (300 tokens, vocab 1000, hidden 128, bias, two ignored
    labels, bf16, fp16 and fp32; ``FCE_CASES``); plus the chunked
    loop the flag replaces (``ops/fused.py::_FusedLinearCE``, cuBLAS
    products) at the train shape: forward and backward ms and peak memory;
    at the train and large shapes its forward beside K9's and the product
    alone on cuBLAS."""
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.ops.cuda import fused_ce as k9

    gen = torch.Generator(device="cpu").manual_seed(2)
    fwd, dx_cases, dw_cases = [], [], []
    chunked = None
    for name, n, h, v, dt, use_bias, ignored in FCE_CASES:
        tdt = {"bf16": torch.bfloat16, "fp16": torch.float16,
               "fp32": torch.float32}[dt]
        x = torch.randn(n, h, generator=gen).to("cuda", tdt)
        w = (0.02 * torch.randn(v, h, generator=gen)).to("cuda", tdt)
        b = ((0.1 * torch.randn(v, generator=gen)).cuda() if use_bias
             else None)
        y = torch.randint(0, v, (n,), generator=gen).cuda()
        g = torch.full((n,), 1.0 / n, device="cuda")
        if name.startswith("odd"):
            g[[5, 17]] = 0.0              # ignored labels carry g = 0
        if ignored:
            drop = (torch.rand(n, generator=gen) < ignored).cuda()
            y[drop] = 0
            g[drop] = 0.0
        # rows whose gradient the data needs (K10/K11 bounds)
        live = int((g != 0).sum())
        esz = 4 if dt == "fp32" else 2
        # fp16 has the bf16 tensor-core peak (H100 data sheet)
        peak = H100_FP32_FLOPS if dt == "fp32" else H100_BF16_FLOPS
        io_b = (n + v) * h * esz + n * 4 + (v * 4 if use_bias else 0)
        loss, lse = k9.ce_forward(x, w, b, y)
        want = k9.ce_forward_plain(x, w, b, y)
        err = max(_max_rel_err(a, c, dt) for a, c in zip((loss, lse), want))
        bound, by = _bound(io_b + 2 * n * 4, 2 * n * v * h, peak)
        shape = {"tokens": n, "hidden": h, "vocab": v, "dtype": dt,
                 "bias": use_bias, "live_rows": live}
        ms = timer(lambda: k9.ce_forward(x, w, b, y))
        fwd.append({
            "case": name, "shape": shape, "max_abs_err": err, "ms": ms,
            "plain_ms": timer(lambda: k9.ce_forward_plain(x, w, b, y), 5),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "kernel_plan": _ce_fwd_plan(torch, k9, n, v, h, tdt),
            "share_of_bound": bound / ms})
        if name in ("train", "large", "bert", "ernie"):
            # the yardstick: the same product alone as one cuBLAS call, and
            # the chunked loop's forward that K9 replaces
            fwd[-1]["cublas_product_ms"] = timer(lambda: torch.matmul(x, w.t()))
            fwd[-1]["chunked_loop_fwd_ms"] = timer(
                lambda: fused._FusedLinearCE.apply(x, w, b, y, -100, 0), 5)
        if name == "train":
            # no atomics, the ranges' partials merged in a fixed order
            loss2, lse2 = k9.ce_forward(x, w, b, y)
            _require(torch.equal(loss, loss2) and torch.equal(lse, lse2),
                     "K9 gives the same loss and lse bits on a second launch")
            fwd[-1]["same_bits_twice"] = True
            del loss2, lse2
        args = (x, w, b, y, g, lse)
        dx = k9.ce_backward_dx(*args)
        err = _max_rel_err(dx, k9.ce_backward_dx_plain(*args), dt)
        # x, w, labels, g, lse read; dx written; the logits recomputed on
        # the rows with a gradient
        bound, by = _bound(io_b + 2 * n * 4 + n * h * esz, 4 * live * v * h,
                           peak)
        ms = timer(lambda: k9.ce_backward_dx(*args))
        dx_cases.append({
            "case": name, "shape": shape, "max_abs_err": err, "ms": ms,
            "plain_ms": timer(lambda: k9.ce_backward_dx_plain(*args), 5),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "kernel_plan": _ce_plan(k9, n, v, h, tdt, 0),
            "share_of_bound": bound / ms})
        dw, db = k9.ce_backward_dw(*args)
        want_dw, want_db = k9.ce_backward_dw_plain(*args)
        err = _max_rel_err(dw, want_dw, dt)
        if use_bias:
            err = max(err, _max_rel_err(db, want_db, dt))
        bound, by = _bound(io_b + 2 * n * 4 + v * h * esz
                           + (v * 4 if use_bias else 0), 4 * live * v * h,
                           peak)
        ms = timer(lambda: k9.ce_backward_dw(*args))
        dw_cases.append({
            "case": name, "shape": shape, "max_abs_err": err, "ms": ms,
            "plain_ms": timer(lambda: k9.ce_backward_dw_plain(*args), 5),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "kernel_plan": _ce_plan(k9, n, v, h, tdt, 1),
            "share_of_bound": bound / ms})
        if name == "train":
            # no atomics, every sum in a fixed order: the same bits again
            dx2 = k9.ce_backward_dx(*args)
            dw2, db2 = k9.ce_backward_dw(*args)
            _require(torch.equal(dx, dx2) and torch.equal(dw, dw2)
                     and (db is None or torch.equal(db, db2)),
                     "K10 and K11 give the same bits on a second launch")
            dx_cases[-1]["same_bits_twice"] = True
            dw_cases[-1]["same_bits_twice"] = True
            del dx2, dw2, db2
        if name == "train":
            chunked = _chunked_loop(torch, timer, fused, x, w, y)
        del x, w, b, y, g, loss, lse, args, dx, dw, db, want, want_dw, want_db
        torch.cuda.empty_cache()
    return fwd, dx_cases, dw_cases, chunked


def _ce_fwd_plan(torch, k9, n, v, h, dtype):
    """The library's K9 plan for a case (route, vocab ranges, tile columns,
    CTAs), held to ``kernel_plan``'s on the card's SMs, with a one-line
    name."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = k9.library_plan(n, v, h, dtype, 2)
    _require(plan == k9.kernel_plan(n, v, h, dtype, 2, sms),
             f"the library's K9 plan is kernel_plan's ({plan})")
    plan["kernel"] = (f"{plan['route']} ranges {plan['ranges']} CTAs "
                      f"{plan['ctas']}")
    return plan


def _ce_plan(k9, n, v, h, dtype, mode):
    """The library's K10 (mode 0) / K11 (mode 1) plan for a case, with a
    one-line name: route, CTAs of a cluster, slice columns."""
    plan = k9.library_plan(n, v, h, dtype, mode)
    _require(plan == k9.kernel_plan(n, v, h, dtype, mode),
             f"the library's K10/K11 plan is kernel_plan's ({plan})")
    plan["kernel"] = (f"{plan['route']} C={plan['cluster']} slice "
                      f"{plan['slice']}")
    return plan


def _chunked_loop(torch, timer, fused, x, w, y):
    """The chunked loop (cuBLAS products, 2048-token fp32 logits chunks)
    at the train shape: forward ms, backward ms, peak memory of one
    forward and backward above the inputs."""
    xg = x.detach().requires_grad_()
    wg = w.detach().requires_grad_()

    def forward():
        return fused._FusedLinearCE.apply(xg, wg, None, y, -100, 0)

    gout = torch.full((x.shape[0],), 1.0 / x.shape[0], device="cuda")
    losses = forward()
    fwd_ms = timer(lambda: forward(), 5)
    bwd_ms = timer(lambda: torch.autograd.grad(losses, (xg, wg), gout,
                                               retain_graph=True), 5)
    torch.cuda.synchronize()
    del losses
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(forward(), (xg, wg), gout)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return {"forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "peak_extra_gib": peak / 2 ** 30}


@contextlib.contextmanager
def plain_versions():
    """Run the routers on the plain versions (the reference run on the card:
    the wrappers themselves never fall back). The plain versions of the
    differentiable entry points are differentiated by autograd itself."""
    from paddle_tpu_torch.ops.cuda import flash_attention as k4
    from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5
    from paddle_tpu_torch.ops.cuda import fused_ce as k9
    from paddle_tpu_torch.ops.cuda import layer_norm as k7

    saved = (k4.flash_attention_fwd, k4.flash_attention_bwd_dq,
             k4.flash_attention_bwd_dkv, k4.flash_attention_cached,
             k5.flash_attention_packed, k7.layer_norm, k9.ce_forward,
             k9.ce_backward_dx, k9.ce_backward_dw)
    # K1-K3's and the flash-CE autograd functions call their launchers by
    # their module names: the plain versions keep their custom backwards
    k4.flash_attention_fwd = k4.flash_attention_fwd_plain
    k4.flash_attention_bwd_dq = k4.flash_attention_bwd_dq_plain
    k4.flash_attention_bwd_dkv = k4.flash_attention_bwd_dkv_plain
    k4.flash_attention_cached = k4.flash_attention_cached_plain
    k5.flash_attention_packed = k5.flash_attention_packed_plain
    k7.layer_norm = k7.layer_norm_plain
    k9.ce_forward = k9.ce_forward_plain
    k9.ce_backward_dx = k9.ce_backward_dx_plain
    k9.ce_backward_dw = k9.ce_backward_dw_plain
    try:
        yield
    finally:
        (k4.flash_attention_fwd, k4.flash_attention_bwd_dq,
         k4.flash_attention_bwd_dkv, k4.flash_attention_cached,
         k5.flash_attention_packed, k7.layer_norm, k9.ce_forward,
         k9.ce_backward_dx, k9.ce_backward_dw) = saved


def _prefill_decode_logits(torch, model, prompt, max_batch, max_len):
    """Logits of one prefill (every valid position) and of the next decode
    tick over ``max_batch`` slots, through fresh cache views."""
    from paddle_tpu_torch.nn.functional import LengthMask
    from paddle_tpu_torch.serving import (DecodeView, KVCache, PrefillView,
                                          default_buckets, pick_bucket)

    cfg = model.cfg
    dev = model.device
    dt = model.gpt.embeddings.word_embeddings.weight.dtype
    cache = KVCache.alloc(cfg.num_layers, max_batch, max_len, cfg.num_heads,
                          cfg.hidden_size // cfg.num_heads, dt, device=dev)
    n = len(prompt)
    bucket = pick_bucket(n, default_buckets(max_len))
    toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    toks[0, :n] = torch.tensor(prompt, device=dev)
    with torch.inference_mode():
        i = torch.arange(bucket, dtype=torch.int32, device=dev)
        lm = LengthMask(i[None], torch.tensor([n], dtype=torch.int32,
                                              device=dev))
        lp, _ = model(toks, position_ids=i[None], attn_mask=lm,
                      cache=[PrefillView(k, v, 0)
                             for k, v in zip(cache.ks, cache.vs)])
        cache.lengths[0] = n
        feed = torch.zeros((max_batch, 1), dtype=torch.long, device=dev)
        feed[0, 0] = torch.argmax(lp[0, n - 1])
        pos = torch.clamp_max(cache.lengths, max_len - 1)
        ld, _ = model(feed, position_ids=pos[:, None],
                      attn_mask=LengthMask(pos[:, None]),
                      cache=[DecodeView(k, v, pos)
                             for k, v in zip(cache.ks, cache.vs)])
    return lp[0, :n].float(), ld[:, -1].float()


def _gpt124m(torch, seed):
    """GPT-2 124M on the card from ``torch.manual_seed(seed)``: bf16 with
    fp32 LayerNorms, dropout 0 (``bench.py``'s TPU configuration)."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import LayerNorm

    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_position_embeddings=1024,
                    hidden_dropout=0.0, attention_dropout=0.0)
    torch.manual_seed(seed)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    for mod in model.modules():
        if isinstance(mod, LayerNorm):
            mod.float()
    return model


def serving_phase(torch, np):
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.serving import (FINISH_REASONS, GenerationEngine,
                                          Request, Scheduler)

    model = _gpt124m(torch, 0)
    cfg = model.cfg
    model.eval()
    eng = GenerationEngine(model, max_batch=8, max_len=1024,
                           prefill_chunk=256, spec_k=4)
    rng = np.random.RandomState(0)
    lengths = [40, 300, 90, 520, 15, 260, 130, 610]
    budgets = [48, 40, 64, 32, 56, 48, 40, 32]

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = Scheduler(eng)
    reqs = [sched.submit(Request(prompt=rng.randint(0, cfg.vocab_size,
                                                    n).tolist(),
                                 max_new_tokens=m))
            for n, m in zip(lengths, budgets)]
    sched.run()
    gen_prompt = rng.randint(0, cfg.vocab_size, 700).tolist()
    out = eng.generate(gen_prompt, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    for r in reqs:
        _require(r.finish_reason in FINISH_REASONS,
                 f"request {r.rid} ended with a finish reason")
        _require(sum(f is r for f in sched.finished) == 1,
                 f"request {r.rid} finished exactly once")
        _require(1 <= len(r.tokens) <= r.max_new_tokens,
                 f"request {r.rid} has its tokens")
    _require(len(out) == 32 and all(0 <= t < cfg.vocab_size for t in out),
             "generate returned 32 in-vocabulary tokens")
    for name in ("flash_attention_cached", "layer_norm"):
        _require(counts[name] > 0, f"kernel {name} launched on the serving "
                 "path")
    tokens = sum(len(r.tokens) for r in reqs) + len(out)
    chunked = sum(1 for n in lengths if eng.chunked_prefill_fits(n)
                  and n > eng.prefill_chunk)

    # one prefill's and one decode tick's logits: kernels vs plain versions
    prompt = rng.randint(0, cfg.vocab_size, 700).tolist()
    kp, kd = _prefill_decode_logits(torch, model, prompt, 8, 1024)
    with plain_versions():
        pp, pd = _prefill_decode_logits(torch, model, prompt, 8, 1024)
    for got, want, what in ((kp, pp, "prefill"), (kd, pd, "decode")):
        _require(bool(got.isfinite().all()), f"{what} logits finite")
        err = float((got - want).abs().max())
        _require(err <= LOGIT_TOL, f"{what} logits within {LOGIT_TOL} of "
                 f"the plain run (max err {err:.4g})")
    logit_err = {"prefill": float((kp - pp).abs().max()),
                 "decode": float((kd - pd).abs().max())}
    return {
        "requests": len(reqs), "chunked_prefill_requests": chunked,
        "finish_reasons": sorted({r.finish_reason for r in reqs}),
        "generated_tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "decode_steps": sched.decode_steps,
        "spec_proposed": sched._spec_proposed,
        "spec_accepted": sched._spec_accepted,
        "launches": counts, "logit_max_abs_err_vs_plain": logit_err,
    }


def small_reference(torch, np):
    """A small fp32 model served on the card against the same model served
    by the port on the CPU (plain versions): same greedy tokens, logits
    within 1e-3."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = GPTConfig(vocab_size=97, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=256,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    initializer_range=0.3)
    cpu = GPTForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    gpu = GPTForCausalLM(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(1))
    prompt = np.random.RandomState(1).randint(0, 97, 150).tolist()
    want = GenerationEngine(cpu, max_batch=2, max_len=256, device="cpu",
                            prefill_chunk=64).generate(prompt, 24)
    got = GenerationEngine(gpu, max_batch=2, max_len=256,
                           prefill_chunk=64).generate(prompt, 24)
    _require(got == want, "small model: card and CPU give the same tokens")
    kp, kd = _prefill_decode_logits(torch, gpu, prompt, 2, 256)
    cp, cd = _prefill_decode_logits(torch, cpu, prompt, 2, 256)
    err = max(float((kp.cpu() - cp).abs().max()),
              float((kd.cpu() - cd).abs().max()))
    _require(err <= SMALL_LOGIT_TOL, f"small model logits within "
             f"{SMALL_LOGIT_TOL} of the CPU (max err {err:.3g})")
    return {"tokens": len(got), "logit_max_abs_err": err}


def _token_batches(np, seed, steps, batch, seq, vocab):
    """``steps`` batches of random token ids from ``RandomState(seed)``,
    each ``(ids, labels)`` with the labels a copy of the ids (as in
    ``bench.py``)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        a = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
        out.append((a, a.copy()))
    return out


def _train(torch, model, batches, lr=1e-4, multi_precision=True, events=None):
    """``bench.py``'s train step over ``batches`` fed through
    ``DeviceLoader``; returns the loss tensors. ``events`` (a list) gets
    four CUDA events a step: start, after the loss, after backward, after
    the optimizer."""
    from paddle_tpu_torch.io import DeviceLoader
    from paddle_tpu_torch.optimizer import AdamW

    model.train()
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                multi_precision=multi_precision)
    losses = []
    for ids, labels in DeviceLoader(batches, buffer_size=2,
                                    device=model.device):
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(4)]
              if events is not None else None)

        def mark(i):
            if ev is not None:
                ev[i].record()

        mark(0)
        loss = model.loss(ids, labels)
        mark(1)
        loss.backward()
        mark(2)
        opt.step()
        opt.clear_grad()
        mark(3)
        losses.append(loss.detach())
        if ev is not None:
            events.append(ev)
    return losses


def training_phase(torch, np):
    """The train step at GPT-2 124M, batch 24 x 1024: 3 warm-up and 10
    timed steps, launch counts zeroed just before and read just after."""
    from paddle_tpu_torch.ops import cuda as kernels

    batch, seq, warm, timed = 24, 1024, 3, 10
    model = _gpt124m(torch, 0)
    batches = _token_batches(np, 0, warm + timed, batch, seq,
                             model.cfg.vocab_size)
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = _train(torch, model, batches, events=events)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    _require(all(np.isfinite(losses)), "training losses are finite")
    # labels are the inputs (as in bench.py), which the tied head learns
    # to copy: the loss must fall from below ln(vocab)
    _require(losses[0] < np.log(model.cfg.vocab_size) + 0.5
             and losses[-1] < losses[0], f"training lowers the loss: {losses}")
    for name in ("flash_attention_packed_fwd", "flash_attention_packed_bwd",
                 "layer_norm", "layer_norm_bwd"):
        _require(counts[name] > 0, f"kernel {name} launched on the train step")
    _require(counts["flash_attention_cached"] == 0,
             "the train step runs no cached attention")
    steps = warm + timed
    per_step = {k: v / steps for k, v in counts.items()}
    tev = events[warm:]
    fwd = sum(e[0].elapsed_time(e[1]) for e in tev) / timed
    bwd = sum(e[1].elapsed_time(e[2]) for e in tev) / timed
    opt = sum(e[2].elapsed_time(e[3]) for e in tev) / timed
    step = sum(e[0].elapsed_time(e[3]) for e in tev) / timed
    # the timed window on the device clock, gaps between steps included
    window = tev[0][0].elapsed_time(tev[-1][3]) / 1e3
    del model
    torch.cuda.empty_cache()
    return {
        "batch": batch, "seq": seq, "warmup_steps": warm,
        "timed_steps": timed, "losses": losses,
        "tokens_per_s": batch * seq * timed / window,
        "step_ms": step, "forward_ms": fwd, "backward_ms": bwd,
        "optimizer_ms": opt, "wall_s_all_steps": wall,
        "peak_memory_gib": peak / 2 ** 30,
        "launches": counts, "launches_per_step": per_step}


def training_vs_plain(torch, np):
    """3 steps at batch 8 on the kernels against the same 3 steps on the
    plain versions, from one init and one set of batches."""
    batches = _token_batches(np, 3, 3, 8, 1024, 50304)
    runs = []
    for plain in (False, True):
        model = _gpt124m(torch, 5)
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with ctx:
            runs.append([float(x) for x in _train(torch, model, batches)])
        del model
        torch.cuda.empty_cache()
    err = max(abs(a - b) for a, b in zip(*runs))
    _require(all(np.isfinite(runs[0])), "kernel-run losses are finite")
    _require(err <= TRAIN_LOSS_TOL, f"train losses within {TRAIN_LOSS_TOL} "
             f"of the plain run: {runs[0]} vs {runs[1]}")
    return {"kernel_losses": runs[0], "plain_losses": runs[1],
            "max_abs_diff": err}


def small_training_reference(torch, np):
    """A small fp32 model (2 heads of 64, seq 1024: K5/K6 and K7/K8 run on
    the card) trained 3 steps on the card against the CPU port."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import cuda as kernels

    cfg = GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=1024,
                    hidden_dropout=0.0, attention_dropout=0.0)
    batches = _token_batches(np, 4, 3, 2, 1024, cfg.vocab_size)
    losses = []
    kernels.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(2))
        losses.append([float(x) for x in _train(
            torch, model, batches, lr=1e-3, multi_precision=False)])
    counts = kernels.launch_counts()
    _require(counts["flash_attention_packed_bwd"] > 0
             and counts["layer_norm_bwd"] > 0,
             "the small model trains through K5-K8 on the card")
    err = max(abs(a - b) for a, b in zip(*losses))
    _require(err <= SMALL_LOSS_TOL, f"small model losses within "
             f"{SMALL_LOSS_TOL} of the CPU: {losses[0]} vs {losses[1]}")
    return {"card_losses": losses[0], "cpu_losses": losses[1],
            "max_abs_diff": err}


@contextlib.contextmanager
def _port_flags(**flags):
    from paddle_tpu_torch.framework import get_flags, set_flags

    prev = get_flags(list(flags))
    set_flags(flags)
    try:
        yield
    finally:
        set_flags(prev)


@contextlib.contextmanager
def _counting_chunked_loop():
    """Counts calls of the chunked loss loop (``ops/fused.py``), which the
    flash-CE route must not reach."""
    from paddle_tpu_torch.ops import fused

    calls = [0]
    real = fused._FusedLinearCE.apply

    def counting(*args):
        calls[0] += 1
        return real(*args)

    fused._FusedLinearCE.apply = counting
    try:
        yield calls
    finally:
        del fused._FusedLinearCE.apply


def _no_decay(name):
    return name.endswith(".bias") or ".ln_" in name


def _recipe_train(torch, model, batches, decorate=True, events=None,
                  peak_lr=6e-4, flash_ce=True):
    """GPT-3's recipe (Brown et al. 2020, Table 2.1 and Appendix B) over
    ``batches`` fed through ``DeviceLoader``, with ``FLAGS_enable_flash_ce``
    set to ``flash_ce``: ``amp.decorate(O2, bf16)`` after the model is
    built in fp32, AdamW(0.9, 0.95, 1e-8, weight decay 0.1 except biases
    and LayerNorms), a 5-step linear warm-up into a cosine decay from
    ``peak_lr`` to a tenth of it (GPT-3 Small's 6e-4 by default;
    ``sched.step()`` after each step), global-norm clipping at 1.0 and a
    dynamic GradScaler from 2^15. Returns the loss tensors and the scaler. ``events`` (a list) gets five CUDA events a step: start, after
    the loss, after backward, after unscale + finite check + clip, after
    the optimizer."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.io import DeviceLoader
    from paddle_tpu_torch.optimizer import AdamW, lr

    class TimedClip(nn.ClipGradByGlobalNorm):
        event = None

        def _dygraph_clip(self, params_grads):
            out = super()._dygraph_clip(params_grads)
            if self.event is not None:
                self.event.record()
            return out

    decay = {f"param_{i}" for i, (n, _) in enumerate(model.named_parameters())
             if not _no_decay(n)}
    sched = lr.LinearWarmup(
        lr.CosineAnnealingDecay(peak_lr, T_max=8, eta_min=peak_lr / 10),
        warmup_steps=5, start_lr=0.0, end_lr=peak_lr)
    clip = TimedClip(1.0)
    opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-8,
                weight_decay=0.1, parameters=model.parameters(),
                apply_decay_param_fun=decay.__contains__, grad_clip=clip)
    if decorate:
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    model.train()
    losses = []
    with _port_flags(enable_flash_ce=flash_ce):
        for ids, labels in DeviceLoader(batches, buffer_size=2,
                                        device=model.device):
            ev = ([torch.cuda.Event(enable_timing=True) for _ in range(5)]
                  if events is not None else None)
            clip.event = None if ev is None else ev[3]

            def mark(i):
                if ev is not None:
                    ev[i].record()

            mark(0)
            loss = model.loss(ids, labels)
            mark(1)
            scaler.scale(loss).backward()
            mark(2)
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            sched.step()
            mark(4)
            losses.append(loss.detach())
            if ev is not None:
                events.append(ev)
    return losses, scaler


def _gpt124m_fp32(torch, seed):
    """GPT-2 124M on the card in fp32 from ``torch.manual_seed(seed)``,
    dropout 0: the recipe decorates it."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_position_embeddings=1024,
                    hidden_dropout=0.0, attention_dropout=0.0)
    torch.manual_seed(seed)
    return GPTForCausalLM(cfg, device="cuda")


def recipe_phase(torch, np):
    """The pretraining recipe at GPT-2 124M, batch 24 x 1024: 3 warm-up
    and 10 timed steps, launch counts zeroed just before and read just
    after; K9, K10 and K11 once a step each and no chunked-loop call."""
    from paddle_tpu_torch.ops import cuda as kernels

    batch, seq, warm, timed = 24, 1024, 3, 10
    steps = warm + timed
    model = _gpt124m_fp32(torch, 0)
    batches = _token_batches(np, 0, steps, batch, seq, model.cfg.vocab_size)
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _counting_chunked_loop() as loop_calls:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses, scaler = _recipe_train(torch, model, batches, events=events)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    _require(all(np.isfinite(losses)), "recipe losses are finite")
    _require(losses[0] < np.log(model.cfg.vocab_size) + 0.5
             and losses[-1] < losses[0], f"the recipe lowers the loss: {losses}")
    for name in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw"):
        _require(counts[name] == steps,
                 f"kernel {name} launched once a step ({counts[name]} in "
                 f"{steps} steps)")
    for name in ("flash_attention_packed_fwd", "flash_attention_packed_bwd",
                 "layer_norm", "layer_norm_bwd"):
        _require(counts[name] > 0, f"kernel {name} launched in the recipe")
    _require(loop_calls[0] == 0, "the flag never reaches the chunked loop")
    _require(scaler.state_dict()["bad_steps"] == 0, "no step was skipped")
    tev = events[warm:]

    def span(i, j):
        return sum(e[i].elapsed_time(e[j]) for e in tev) / timed

    window = tev[0][0].elapsed_time(tev[-1][4]) / 1e3
    del model
    torch.cuda.empty_cache()
    return {
        "batch": batch, "seq": seq, "warmup_steps": warm,
        "timed_steps": timed, "losses": losses,
        "tokens_per_s": batch * seq * timed / window,
        "step_ms": span(0, 4), "forward_ms": span(0, 1),
        "backward_ms": span(1, 2), "scaler_clip_ms": span(2, 3),
        "optimizer_ms": span(3, 4), "wall_s_all_steps": wall,
        "peak_memory_gib": peak / 2 ** 30, "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "chunked_loop_calls": loop_calls[0], "scaler": scaler.state_dict()}


def recipe_vs_plain(torch, np):
    """3 recipe steps at batch 8 on the kernels against the same 3 steps on
    the plain versions (K9-K11 included), from one init and one set of
    batches."""
    batches = _token_batches(np, 6, 3, 8, 1024, 50304)
    runs = []
    for plain in (False, True):
        model = _gpt124m_fp32(torch, 7)
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with ctx:
            losses, _ = _recipe_train(torch, model, batches)
            runs.append([float(x) for x in losses])
        del model
        torch.cuda.empty_cache()
    err = max(abs(a - b) for a, b in zip(*runs))
    _require(all(np.isfinite(runs[0])), "kernel-run recipe losses are finite")
    _require(err <= TRAIN_LOSS_TOL, f"recipe losses within {TRAIN_LOSS_TOL} "
             f"of the plain run: {runs[0]} vs {runs[1]}")
    return {"kernel_losses": runs[0], "plain_losses": runs[1],
            "max_abs_diff": err}


def small_recipe_reference(torch, np):
    """A small fp32 model (2 heads of 64, seq 1024, vocab 1024, hidden 128:
    K5-K8 and the fp32 K9-K11 run on the card) trained 3 recipe steps,
    without decorate, on the card against the CPU port."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import cuda as kernels

    cfg = GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=1024,
                    hidden_dropout=0.0, attention_dropout=0.0)
    batches = _token_batches(np, 8, 3, 2, 1024, cfg.vocab_size)
    losses = []
    kernels.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(3))
        out, _ = _recipe_train(torch, model, batches, decorate=False)
        losses.append([float(x) for x in out])
    counts = kernels.launch_counts()
    _require(all(counts[k] == 3 for k in
                 ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw")),
             "the small model's loss runs the fp32 K9-K11 on the card")
    err = max(abs(a - b) for a, b in zip(*losses))
    _require(err <= SMALL_LOSS_TOL, f"small recipe losses within "
             f"{SMALL_LOSS_TOL} of the CPU: {losses[0]} vs {losses[1]}")
    return {"card_losses": losses[0], "cpu_losses": losses[1],
            "max_abs_diff": err}


def _gpt124m_default(torch, seed):
    """GPT-2 124M on the card in fp32 from ``torch.manual_seed(seed)`` at
    ``GPTConfig``'s defaults: hidden and attention dropout 0.1."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_position_embeddings=1024)
    _require(cfg.hidden_dropout == cfg.attention_dropout == 0.1,
             "GPTConfig's defaults drop 0.1")
    torch.manual_seed(seed)
    return GPTForCausalLM(cfg, device="cuda")


def gpt2_dropout_phase(torch, np):
    """The pretraining recipe at GPT-2 124M's default config (hidden and
    attention dropout 0.1), batch 24 x 1024 through ``DeviceLoader``, 2
    warm-up and 5 timed steps, ``FLAGS_enable_flash_ce``; launch counts
    zeroed just before and read just after: K5 and K6 12 times a step, each
    with in-kernel dropout, K9-K11 once a step, no chunked-loop call, the
    loss falling and no skipped step."""
    from paddle_tpu_torch.framework import random as rnd
    from paddle_tpu_torch.ops import cuda as kernels

    batch, seq, warm, timed = 24, 1024, 2, 5
    steps = warm + timed
    model = _gpt124m_default(torch, 0)
    cfg = model.cfg
    batches = _token_batches(np, 20, steps, batch, seq, cfg.vocab_size)
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _counting_chunked_loop() as loop_calls:
        kernels.reset_launch_counts()
        rnd.seed(21)
        t0 = time.perf_counter()
        losses, scaler = _recipe_train(torch, model, batches, events=events)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        drops = kernels.dropout_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    _require(all(np.isfinite(losses)), "default-config losses are finite")
    _require(losses[0] < np.log(cfg.vocab_size) + 0.5
             and losses[-1] < losses[0],
             f"the default-config recipe lowers the loss: {losses}")
    for name in ("flash_attention_packed_fwd", "flash_attention_packed_bwd"):
        _require(counts[name] == drops[name] == cfg.num_layers * steps,
                 f"kernel {name} launched {cfg.num_layers} times a step, "
                 f"each with dropout ({counts[name]}, {drops[name]} in "
                 f"{steps} steps)")
    for name in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw"):
        _require(counts[name] == steps, f"kernel {name} launched once a step")
    _require(loop_calls[0] == 0, "the flag never reaches the chunked loop")
    _require(scaler.state_dict()["bad_steps"] == 0, "no step was skipped")
    tev = events[warm:]

    def span(i, j):
        return sum(e[i].elapsed_time(e[j]) for e in tev) / timed

    window = tev[0][0].elapsed_time(tev[-1][4]) / 1e3
    del model
    torch.cuda.empty_cache()
    return {
        "batch": batch, "seq": seq, "warmup_steps": warm,
        "timed_steps": timed, "hidden_dropout": cfg.hidden_dropout,
        "attention_dropout": cfg.attention_dropout, "losses": losses,
        "tokens_per_s": batch * seq * timed / window,
        "step_ms": span(0, 4), "forward_ms": span(0, 1),
        "backward_ms": span(1, 2), "scaler_clip_ms": span(2, 3),
        "optimizer_ms": span(3, 4), "wall_s_all_steps": wall,
        "peak_memory_gib": peak / 2 ** 30, "launches": counts,
        "dropout_launches": drops,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "chunked_loop_calls": loop_calls[0], "scaler": scaler.state_dict()}


def gpt2_dropout_vs_plain(torch, np):
    """3 default-config recipe steps at batch 8 on the kernels against the
    same 3 steps on the plain versions, from one init, one set of batches
    and one seed (``framework.random.seed``: the plain versions draw the
    kernels' Philox bits and ``nn.Dropout`` the same CUDA generator's, so
    both runs drop the same elements): losses within 2e-3. A second kernel
    run from the same seed gives the first forward loss bit for bit."""
    from paddle_tpu_torch.framework import random as rnd

    batches = _token_batches(np, 22, 3, 8, 1024, 50304)
    runs = []
    for plain, steps in ((False, 3), (False, 1), (True, 3)):
        model = _gpt124m_default(torch, 23)
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with ctx:
            rnd.seed(24)
            losses, _ = _recipe_train(torch, model, batches[:steps])
            runs.append([float(x) for x in losses])
        del model
        torch.cuda.empty_cache()
    kernel, replay, plain = runs
    _require(kernel[0] == replay[0], f"the first forward loss replays bit "
             f"for bit from one seed: {kernel[0]!r} vs {replay[0]!r}")
    err = max(abs(a - b) for a, b in zip(kernel, plain))
    _require(all(np.isfinite(kernel)), "kernel-run losses are finite")
    _require(err <= TRAIN_LOSS_TOL, f"default-config losses within "
             f"{TRAIN_LOSS_TOL} of the plain run: {kernel} vs {plain}")
    return {"kernel_losses": kernel, "replay_first_loss": replay[0],
            "plain_losses": plain, "max_abs_diff": err}


#: GPT-3 Large (Brown et al. 2020, Table 2.1): 760M parameters, 24 layers,
#: d_model 1536, 16 heads of 96, context 2048, learning rate 2.5e-4; the
#: vocabulary is the repo's padded GPT-2 one (bench.py:97-102)
GPT3_LARGE = dict(vocab_size=50304, hidden_size=1536, num_layers=24,
                  num_heads=16, max_position_embeddings=2048,
                  hidden_dropout=0.0, attention_dropout=0.0)
GPT3_LARGE_LR = 2.5e-4
_K1_K3 = ("flash_attention_fwd", "flash_attention_bwd_dq",
          "flash_attention_bwd_dkv")


def _gpt3_large_fp32(torch, seed):
    """GPT-3 Large on the card in fp32 from ``torch.manual_seed(seed)``:
    the recipe decorates it."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    torch.manual_seed(seed)
    return GPTForCausalLM(GPTConfig(**GPT3_LARGE), device="cuda")


def gpt3_large_phase(torch, np):
    """GPT-3 Large's pretraining step on the card: the recipe with its peak
    learning rate 2.5e-4 (cosine to 2.5e-5), the chunked loss
    (``FLAGS_enable_flash_ce`` off, the default), batch 8 x 2048 through
    ``DeviceLoader``, 2 warm-up and 5 timed steps; launch counts zeroed
    just before and read just after. Head dim 96 does not pack, so every
    attention call takes K1, K2 and K3 (24 a step each) and none K5/K6;
    K7 and K8 run 49 times a step (two LayerNorms a layer and the final
    one). Returns the report and the trained (decorated) model."""
    from paddle_tpu_torch.ops import cuda as kernels

    batch, seq, warm, timed = 8, 2048, 2, 5
    steps = warm + timed
    model = _gpt3_large_fp32(torch, 0)
    cfg = model.cfg
    batches = _token_batches(np, 10, steps, batch, seq, cfg.vocab_size)
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses, scaler = _recipe_train(torch, model, batches, events=events,
                                   peak_lr=GPT3_LARGE_LR, flash_ce=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    _require(all(np.isfinite(losses)), "GPT-3 Large losses are finite")
    _require(losses[0] < np.log(cfg.vocab_size) + 0.5
             and losses[-1] < losses[0],
             f"GPT-3 Large's recipe lowers the loss: {losses}")
    want = {name: cfg.num_layers * steps for name in _K1_K3}
    want.update(layer_norm=(2 * cfg.num_layers + 1) * steps,
                layer_norm_bwd=(2 * cfg.num_layers + 1) * steps,
                flash_attention_packed_fwd=0, flash_attention_packed_bwd=0,
                flash_attention_cached=0, fused_ce_fwd=0, fused_ce_dx=0,
                fused_ce_dw=0)
    for name, n in want.items():
        _require(counts[name] == n, f"kernel {name} launched {n} times in "
                 f"{steps} GPT-3 Large steps ({counts[name]})")
    _require(scaler.state_dict()["bad_steps"] == 0, "no step was skipped")
    tev = events[warm:]

    def span(i, j):
        return sum(e[i].elapsed_time(e[j]) for e in tev) / timed

    window = tev[0][0].elapsed_time(tev[-1][4]) / 1e3
    params = sum(p.numel() for p in model.parameters())
    return {
        "config": GPT3_LARGE, "parameters": params, "batch": batch,
        "seq": seq, "warmup_steps": warm, "timed_steps": timed,
        "peak_lr": GPT3_LARGE_LR, "losses": losses,
        "tokens_per_s": batch * seq * timed / window,
        "step_ms": span(0, 4), "forward_ms": span(0, 1),
        "backward_ms": span(1, 2), "scaler_clip_ms": span(2, 3),
        "optimizer_ms": span(3, 4), "wall_s_all_steps": wall,
        "peak_memory_gib": peak / 2 ** 30, "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "scaler": scaler.state_dict()}, model


def gpt3_large_generate(torch, np, model):
    """One 64-token greedy ``generate`` of the trained GPT-3 Large model (a
    300-token prompt, ``max_len`` 2048) with launch counts zeroed just
    before and read just after (K4 at head dim 96, K7; no K1-K3); then one
    prefill's and one decode tick's logits against the plain versions."""
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.serving import GenerationEngine

    model.eval()
    prompt = np.random.RandomState(11).randint(
        0, model.cfg.vocab_size, 300).tolist()
    eng = GenerationEngine(model, max_batch=2, max_len=2048)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompt, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    _require(len(out) == 64 and all(0 <= t < model.cfg.vocab_size
                                    for t in out),
             "generate returned 64 in-vocabulary tokens")
    _require(counts["flash_attention_cached"] > 0 and counts["layer_norm"] > 0,
             "GPT-3 Large generates through K4 and K7")
    _require(all(counts[k] == 0 for k in _K1_K3),
             "generation runs no uncached attention")
    del eng
    torch.cuda.empty_cache()
    kp, kd = _prefill_decode_logits(torch, model, prompt, 2, 2048)
    with plain_versions():
        pp, pd = _prefill_decode_logits(torch, model, prompt, 2, 2048)
    err = {}
    for got, want, what in ((kp, pp, "prefill"), (kd, pd, "decode")):
        _require(bool(got.isfinite().all()), f"{what} logits finite")
        err[what] = float((got - want).abs().max())
        _require(err[what] <= LOGIT_TOL, f"GPT-3 Large {what} logits within "
                 f"{LOGIT_TOL} of the plain run (max err {err[what]:.4g})")
    return {"prompt_tokens": len(prompt), "generated_tokens": len(out),
            "wall_s": wall, "tokens_per_s": len(out) / wall,
            "launches": counts, "logit_max_abs_err_vs_plain": err,
            "logit_abs_max": float(kp.abs().max())}


def gpt3_large_vs_plain(torch, np):
    """3 GPT-3 Large recipe steps at batch 2 x 2048 on the kernels against
    the same 3 steps on the plain versions, from one init and one set of
    batches."""
    batches = _token_batches(np, 12, 3, 2, 2048, GPT3_LARGE["vocab_size"])
    runs = []
    for plain in (False, True):
        model = _gpt3_large_fp32(torch, 13)
        ctx = plain_versions() if plain else contextlib.nullcontext()
        with ctx:
            losses, _ = _recipe_train(torch, model, batches,
                                      peak_lr=GPT3_LARGE_LR, flash_ce=False)
            runs.append([float(x) for x in losses])
        del model
        torch.cuda.empty_cache()
    err = max(abs(a - b) for a, b in zip(*runs))
    _require(all(np.isfinite(runs[0])), "kernel-run losses are finite")
    _require(err <= TRAIN_LOSS_TOL, f"GPT-3 Large losses within "
             f"{TRAIN_LOSS_TOL} of the plain run: {runs[0]} vs {runs[1]}")
    return {"kernel_losses": runs[0], "plain_losses": runs[1],
            "max_abs_diff": err}


def small_d96_reference(torch, np):
    """A small fp32 model with GPT-3 Large's head dim (2 heads of 96, 2
    layers, seq 1024, vocab 1024: K1-K3 and K7/K8 run on the card) trained
    3 recipe steps, without decorate and with the chunked loss, on the card
    against the CPU port."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops import cuda as kernels

    cfg = GPTConfig(vocab_size=1024, hidden_size=192, num_layers=2,
                    num_heads=2, max_position_embeddings=1024,
                    hidden_dropout=0.0, attention_dropout=0.0)
    batches = _token_batches(np, 14, 3, 2, 1024, cfg.vocab_size)
    losses = []
    kernels.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(15))
        out, _ = _recipe_train(torch, model, batches, decorate=False,
                               peak_lr=GPT3_LARGE_LR, flash_ce=False)
        losses.append([float(x) for x in out])
    counts = kernels.launch_counts()
    _require(all(counts[k] == 2 * 3 for k in _K1_K3),
             "the small d = 96 model trains through K1-K3 on the card")
    err = max(abs(a - b) for a, b in zip(*losses))
    _require(err <= SMALL_LOSS_TOL, f"small d = 96 losses within "
             f"{SMALL_LOSS_TOL} of the CPU: {losses[0]} vs {losses[1]}")
    return {"card_losses": losses[0], "cpu_losses": losses[1],
            "max_abs_diff": err}


#: the tensor-core kernels whose SASS must hold HMMA (or HGMMA)
#: instructions: K1 (which also runs K5), K2, K3, K4's prefill, K6, and
#: the wgmma kernels (HGMMA): K10/K11's cluster kernel and K9's
# ---------------------------------------------------------------------------
# the encoder family: BERT-large scoring and MLM pretraining, ERNIE-large
# ---------------------------------------------------------------------------
def _bert_large(torch, seed, cls, no_dropout=False, **kw):
    """A BERT-large model of ``cls`` on the card from
    ``torch.manual_seed(seed)``: bf16 with fp32 LayerNorms (``bench_bert``'s
    TPU configuration), dropout 0 for the pretraining runs; ``kw``: the
    classifier's ``num_classes``."""
    from paddle_tpu_torch.models import bert_large
    from paddle_tpu_torch.nn import LayerNorm

    cfg = bert_large()
    if no_dropout:
        cfg.hidden_dropout = cfg.attention_dropout = 0.0
    torch.manual_seed(seed)
    model = cls(cfg, device="cuda", dtype=torch.bfloat16, **kw)
    for mod in model.modules():
        if isinstance(mod, LayerNorm):
            mod.float()
    return model


def _score_lengths(np, seed, n):
    """``n`` request lengths in 16..512, log-uniform from
    ``RandomState(seed)``, in ascending order (the scorer takes requests in
    order: the shortest 32 fit the 128 bucket, the rest take 512)."""
    rng = np.random.RandomState(seed)
    return np.sort(np.exp(rng.uniform(np.log(16), np.log(512), n))
                   .astype(np.int64))


def bert_score_phase(torch, np):
    """BERT-large scoring: ``BertForSequenceClassification(bert_large(),
    num_classes=2)`` behind ``model.scorer(max_batch=32, seq_buckets=(128,
    512))``, 96 requests, one warm-up ``score`` and one counted and timed
    (launch counts zeroed just before, read just after); the logits held
    within 0.125 of the same scorer on the plain versions and of each
    request's own unpadded call."""
    from paddle_tpu_torch.models import BertForSequenceClassification
    from paddle_tpu_torch.ops import cuda as kernels

    model = _bert_large(torch, 0, BertForSequenceClassification,
                        num_classes=2)
    model.eval()
    vocab = model.bert.cfg.vocab_size
    lengths = _score_lengths(np, 30, 96)
    rng = np.random.RandomState(31)
    seqs = [rng.randint(1, vocab, int(n)) for n in lengths]
    scorer = model.scorer(max_batch=32, seq_buckets=(128, 512))
    scorer.score(seqs)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = scorer.score(seqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    _require(got.shape == (96, 2) and bool(np.isfinite(got).all()),
             "the scorer gives finite [96, 2] logits")
    _require(scorer.padded_shapes == [(32, 128), (32, 512)],
             f"one padded shape a bucket, both buckets used "
             f"({scorer.padded_shapes})")
    _require(counts["layer_norm"] > 0, "K7 launched on the scoring path")
    with plain_versions():
        plain = model.scorer(max_batch=32,
                             seq_buckets=(128, 512)).score(seqs)
    err_plain = float(np.abs(got - plain).max())
    _require(err_plain <= LOGIT_TOL, f"scorer logits within {LOGIT_TOL} of "
             f"the plain run (max err {err_plain:.4g})")
    # each request alone, unpadded; its keep-mask of ones takes it through
    # the same fp32 promotion as the padded batch (without a mask it would
    # stay bf16, and the distance would measure bf16 against fp32)
    alone, bare = [], []
    with torch.inference_mode():
        for s in seqs:
            ids = torch.from_numpy(s[None]).cuda()
            alone.append(model(ids, attention_mask=torch.ones(
                ids.shape, device="cuda")).float().cpu().numpy()[0])
            bare.append(model(ids).float().cpu().numpy()[0])
    err_alone = float(np.abs(got - np.stack(alone)).max())
    _require(err_alone <= LOGIT_TOL, f"padded logits within {LOGIT_TOL} of "
             f"each request alone (max err {err_alone:.4g})")
    tokens = int(lengths.sum())
    out = {
        "requests": len(seqs), "max_batch": 32, "buckets": [128, 512],
        "padded_shapes": [list(t) for t in scorer.padded_shapes],
        "tokens": tokens, "padded_tokens": sum(32 * b for _, b in
                                               scorer.padded_shapes),
        "wall_s": wall, "sequences_per_s": len(seqs) / wall,
        "tokens_per_s": tokens / wall,
        "ms_per_batch_of_32": 1e3 * wall / -(-len(seqs) // 32),
        "logit_max_abs_err_vs_plain": err_plain,
        "logit_max_abs_err_vs_alone": err_alone,
        "logit_max_abs_diff_vs_alone_without_mask": float(
            np.abs(got - np.stack(bare)).max()),
        "output_dtype_with_mask": "float32", "launches": counts}
    del model, scorer
    torch.cuda.empty_cache()
    return out


def _mlm_batches(np, seed, steps, batch, seq, vocab):
    """``tools/bench_bert.py``'s MLM batches: random ids, and labels on 15 %
    of the positions (random ids), -100 elsewhere."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
        labels = np.where(rng.rand(batch, seq) < 0.15,
                          rng.randint(0, vocab, (batch, seq)),
                          -100).astype(np.int64)
        out.append((ids, labels))
    return out


def _step_split(events, warm, timed, batch, seq):
    """Mean forward / backward / optimizer ms of the timed steps (``_train``'s
    four events a step) and tokens/s over their window on the device
    clock."""
    tev = events[warm:]

    def span(i, j):
        return sum(e[i].elapsed_time(e[j]) for e in tev) / timed

    window = tev[0][0].elapsed_time(tev[-1][3]) / 1e3
    return {"tokens_per_s": batch * seq * timed / window,
            "step_ms": span(0, 3), "forward_ms": span(0, 1),
            "backward_ms": span(1, 2), "optimizer_ms": span(2, 3)}


#: BERT-large MLM shapes: ``tools/bench_bert.py``'s ``DEFAULT_BATCH``
BERT_MLM_SHAPES = ((128, 128), (512, 48))


def bert_mlm_phase(torch, np):
    """BERT-large MLM pretraining, ``tools/bench_bert.py``'s recipe:
    ``BertForPretraining(bert_large())`` at dropout 0, bf16 with fp32
    LayerNorms, ``AdamW(lr=1e-4, multi_precision=True)``, the chunked MLM
    loss (flag off), at s128 x 128 and s512 x 48 through ``DeviceLoader``:
    2 warm-up and 5 timed steps each, launch counts zeroed before each
    shape's 7 steps and read after; K7 and K8 launch, attention takes the
    dense path."""
    from paddle_tpu_torch.models import BertForPretraining
    from paddle_tpu_torch.ops import cuda as kernels

    warm, timed = 2, 5
    out = {}
    for seq, batch in BERT_MLM_SHAPES:
        model = _bert_large(torch, 0, BertForPretraining, no_dropout=True)
        cfg = model.cfg
        batches = _mlm_batches(np, seq, warm + timed, batch, seq,
                               cfg.vocab_size)
        events = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses = _train(torch, model, batches, events=events)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x) for x in losses]
        _require(all(np.isfinite(losses))
                 and losses[0] < np.log(cfg.vocab_size) + 1.0,
                 f"BERT-large MLM losses finite, from about ln(vocab): "
                 f"{losses}")
        per_step = 2 * cfg.num_layers + 2   # embeddings + 2 a layer + head
        for name in ("layer_norm", "layer_norm_bwd"):
            _require(counts[name] == per_step * (warm + timed),
                     f"kernel {name} launched {per_step} times a step "
                     f"({counts[name]})")
        _require(sum(v for k, v in counts.items()
                     if k.startswith("flash_attention")) == 0,
                 "BERT-large at s <= 512 takes the dense attention path")
        out[f"s{seq}"] = {
            "batch": batch, "seq": seq, "warmup_steps": warm,
            "timed_steps": timed, "losses": losses,
            **_step_split(events, warm, timed, batch, seq),
            "wall_s_all_steps": wall, "peak_memory_gib": peak / 2 ** 30,
            "launches": counts,
            "launches_per_step": {k: v / (warm + timed)
                                  for k, v in counts.items()}}
        del model, batches
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(out[f"s{s}"]["launches"][k]
                              for s, _ in BERT_MLM_SHAPES)
                       for k in out["s128"]["launches"]}
    return out


def bert_mlm_vs_plain(torch, np):
    """3 BERT-large MLM steps at the phase's s128 x 128 shape on the kernels
    against the same 3 steps on the plain versions, from one init and one
    set of batches. The loss is a mean over the labelled 15 % (~2,460
    tokens a step): bf16 roundings that K7 and its plain version place
    differently (one bf16 step here and there, through 24 layers) average
    out over them; at s128 x 16 (~300 labelled tokens) the gap measured on
    an H100 was 1.6e-3 of the 2e-3 limit."""
    from paddle_tpu_torch.models import BertForPretraining

    batches = _mlm_batches(np, 40, 3, 128, 128, 30522)
    runs = []
    for plain in (False, True):
        model = _bert_large(torch, 1, BertForPretraining, no_dropout=True)
        with plain_versions() if plain else contextlib.nullcontext():
            runs.append([float(x) for x in _train(torch, model, batches)])
        del model
        torch.cuda.empty_cache()
    err = max(abs(a - b) for a, b in zip(*runs))
    _require(all(np.isfinite(runs[0])), "kernel-run MLM losses are finite")
    _require(err <= TRAIN_LOSS_TOL, f"MLM losses within {TRAIN_LOSS_TOL} of "
             f"the plain run: {runs[0]} vs {runs[1]}")
    return {"kernel_losses": runs[0], "plain_losses": runs[1],
            "max_abs_diff": err}


def _ernie_large(torch, seed):
    """ERNIE-large at ``ernie_large()``'s defaults (dropout 0.1, task ids,
    vocab 18000) on the card in fp32 from ``torch.manual_seed(seed)``: the
    run decorates it."""
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_large

    cfg = ernie_large()
    _require(cfg.hidden_dropout == cfg.attention_dropout == 0.1
             and cfg.use_task_id and cfg.vocab_size == 18000,
             "ernie_large's defaults: dropout 0.1, task ids, vocab 18000")
    torch.manual_seed(seed)
    return ErnieForPretraining(cfg, device="cuda")


def _ernie_batches(np, seed, steps, batch, seq, vocab):
    """ERNIE pretraining batches: random ids through ``ErnieDataCollator``
    (span masking, 15 %), sentence ids (0 for the first half, 1 after), a
    task id a sequence and NSP labels, from ``RandomState(seed)``."""
    from paddle_tpu_torch.models import ErnieDataCollator

    rng = np.random.RandomState(seed)
    collate = ErnieDataCollator(vocab, seed=seed)
    out = []
    for _ in range(steps):
        ids, labels = collate(rng.randint(5, vocab, (batch, seq)))
        sent = np.zeros_like(ids)
        sent[:, seq // 2:] = 1
        task = np.repeat(rng.randint(0, 3, (batch, 1)), seq, 1)
        nsp = rng.randint(0, 2, (batch,)).astype(np.int64)
        out.append((ids, labels, sent, task, nsp))
    return out


def _ernie_step(model, batch):
    ids, labels, sent, task, nsp = batch
    return model.loss(ids, labels, nsp_labels=nsp, token_type_ids=sent,
                      task_type_ids=task)


def _ernie_optimizer(model):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    return amp.decorate(model, opt, level="O2", dtype="bfloat16")


def ernie_large_phase(torch, np):
    """ERNIE-large pretraining: built fp32, ``amp.decorate(O2, bf16)``,
    AdamW, ``FLAGS_enable_flash_ce`` (the biased MLM loss on K9-K11), the
    MLM + NSP loss at batch 16 x 512 through ``DeviceLoader``, 2 warm-up
    and 3 timed steps, launch counts zeroed just before and read just
    after; then the same steps on the plain versions from the same seed
    (both runs drop the same elements): the first losses agree."""
    from paddle_tpu_torch.framework import random as rnd
    from paddle_tpu_torch.io import DeviceLoader
    from paddle_tpu_torch.ops import cuda as kernels

    batch, seq, warm, timed = 16, 512, 2, 3
    steps = warm + timed
    model, opt = _ernie_optimizer(_ernie_large(torch, 0))
    cfg = model.cfg
    batches = _ernie_batches(np, 50, steps, batch, seq, cfg.vocab_size)
    live = [int((b[1] != -100).sum()) for b in batches]
    model.train()
    events, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _counting_chunked_loop() as loop_calls, \
            _port_flags(enable_flash_ce=True):
        kernels.reset_launch_counts()
        rnd.seed(51)
        t0 = time.perf_counter()
        for b in DeviceLoader(batches, buffer_size=2, device=model.device):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss = _ernie_step(model, b)
            ev[1].record()
            loss.backward()
            ev[2].record()
            opt.step()
            opt.clear_grad()
            ev[3].record()
            events.append(ev)
            losses.append(loss.detach())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    _require(all(np.isfinite(losses)), f"ERNIE-large losses finite: {losses}")
    for name in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw"):
        _require(counts[name] == steps, f"kernel {name} launched once a "
                 f"step ({counts[name]} in {steps} steps)")
    for name in ("layer_norm", "layer_norm_bwd"):
        _require(counts[name] > 0, f"kernel {name} launched on ERNIE-large")
    _require(loop_calls[0] == 0, "the flag never reaches the chunked loop")
    del model, opt
    torch.cuda.empty_cache()
    # the same steps on the plain versions, same init, batches and seed:
    # the first loss is gated; the later ones are printed (each step's bf16
    # roundings differ, and the runs drift apart)
    model, opt = _ernie_optimizer(_ernie_large(torch, 0))
    model.train()
    plain_losses = []
    with plain_versions(), _port_flags(enable_flash_ce=True):
        rnd.seed(51)
        for b in DeviceLoader(batches, buffer_size=2, device=model.device):
            loss = _ernie_step(model, b)
            loss.backward()
            opt.step()
            opt.clear_grad()
            plain_losses.append(float(loss.detach()))
    del model, opt
    torch.cuda.empty_cache()
    plain_first = plain_losses[0]
    err = abs(losses[0] - plain_first)
    _require(err <= TRAIN_LOSS_TOL, f"ERNIE-large's first loss within "
             f"{TRAIN_LOSS_TOL} of the plain run: {losses[0]} vs "
             f"{plain_first}")
    return {"batch": batch, "seq": seq, "warmup_steps": warm,
            "timed_steps": timed, "losses": losses,
            "labelled_tokens": live,
            **_step_split(events, warm, timed, batch, seq),
            "wall_s_all_steps": wall, "peak_memory_gib": peak / 2 ** 30,
            "plain_losses": plain_losses, "first_loss_abs_diff": err,
            "launches": counts,
            "launches_per_step": {k: v / steps for k, v in counts.items()},
            "chunked_loop_calls": loop_calls[0]}


#: ``tools/bench_resnet.py``'s train step: ResNet-50, 1000 classes, batch
#: 128 of 224 x 224 images
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 128, 224, 1000
#: ResNet-50's forward at 224 x 224: 4.089 G multiply-adds an image
#: (``bench_resnet.py:104-106``); a train step is about 3 forwards
RESNET_TRAIN_FLOP = 3 * 2 * 4.089e9
RESNET_FWD_FLOP = 2 * 4.089e9


@contextlib.contextmanager
def _vision_setup(torch, layout=True):
    """Layout autotune (``incubate.autotune``) and cuDNN's algorithm search
    (``torch.backends.cudnn.benchmark``, the counterpart of XLA's
    compile-time conv autotuning) for the block; both restored after. TF32
    stays off (``main``)."""
    from paddle_tpu_torch.incubate import autotune

    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    autotune.set_config({"layout": {"enable": layout}})
    try:
        yield
    finally:
        autotune.set_config({"layout": {"enable": False}})
        torch.backends.cudnn.benchmark = prev


def _resnet50(torch, seed, bf16=True):
    """``bench_resnet.py``'s model: ``resnet50(num_classes=1000)`` from
    ``torch.manual_seed(seed)``, in bf16 with the batch norms kept fp32
    (``bench_resnet.py:60-66``), or fp32. Built under the caller's layout
    setting (layout autotune builds the conv weights channels-last)."""
    from paddle_tpu_torch.vision.models import resnet50

    torch.manual_seed(seed)
    model = resnet50(num_classes=RESNET_CLASSES, device="cuda")
    if bf16:
        model.to(torch.bfloat16)
        for m in model.modules():
            if type(m).__name__.startswith("BatchNorm"):
                m.float()
    return model


def _image_batches(torch, seed, steps, batch, size, classes, channels=3,
                   dtype=None):
    """Seeded synthetic images (standard normal) and labels ``[batch, 1]``,
    as ``bench_resnet.py`` makes them, drawn on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = dtype or torch.bfloat16
    return [(torch.randn(batch, channels, size, size, generator=gen,
                         device="cuda").to(dtype),
             torch.randint(0, classes, (batch, 1), generator=gen,
                           device="cuda"))
            for _ in range(steps)]


def _momentum(model):
    """``bench_resnet.py``'s optimizer."""
    from paddle_tpu_torch.optimizer import Momentum

    return Momentum(learning_rate=0.1, momentum=0.9,
                    parameters=model.parameters(), weight_decay=1e-4,
                    use_nesterov=False, multi_precision=True)


def _vision_step(model, opt, images, labels, ev=None):
    """``bench_resnet.py``'s train step: cross entropy on fp32 logits,
    backward, the optimizer. ``ev``: four CUDA events to record (start,
    after the loss, after backward, after the optimizer)."""
    from paddle_tpu_torch.nn import functional as F

    def mark(i):
        if ev is not None:
            ev[i].record()

    mark(0)
    logits = model(images)
    loss = F.cross_entropy(logits.float(), labels, reduction="mean")
    mark(1)
    loss.backward()
    mark(2)
    opt.step()
    opt.clear_grad()
    mark(3)
    return logits.detach(), loss.detach()


def _no_kernel_launched(counts, path):
    _require(sum(counts.values()) == 0,
             f"{path} launches none of K1-K11 ({counts})")


def resnet50_train_phase(torch, np):
    """``tools/bench_resnet.py``'s train step on ResNet-50 at batch 128 x 3 x
    224 x 224: bf16 with fp32 batch norms, layout autotune on (channels-last
    convolutions), cuDNN's algorithm search, ``Momentum(0.1, 0.9, weight
    decay 1e-4, multi_precision)``, ``cross_entropy`` on fp32 logits; 3
    warm-up and 10 timed steps, launch counts zeroed just before and read
    just after. Fails without cuDNN, unless a block's conv output is
    channels-last, the batch norm's output bf16 and its running statistics
    fp32 and moved, and the losses finite."""
    from paddle_tpu_torch.ops import cuda as kernels

    _require(torch.backends.cudnn.is_available(), "cuDNN is available")
    warm, timed = 3, 10
    with _vision_setup(torch):
        model = _resnet50(torch, 0)
        opt = _momentum(model)
        batches = _image_batches(torch, 60, warm + timed, RESNET_BATCH,
                                 RESNET_SIZE, RESNET_CLASSES)
        seen = {}
        conv = model.layer1[0].conv2
        hooks = [conv.register_forward_hook(
                     lambda m, i, o: seen.setdefault("conv", o)),
                 model.layer1[0].bn2.register_forward_hook(
                     lambda m, i, o: seen.setdefault("bn", o))]
        mean0 = model.layer1[0].bn2._mean.clone()
        model.train()
        events, losses = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for images, labels in batches:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            _, loss = _vision_step(model, opt, images, labels, ev)
            events.append(ev)
            losses.append(loss)
            for h in hooks:
                h.remove()
            hooks = []
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    _require(all(np.isfinite(losses)), f"ResNet-50 losses finite: {losses}")
    cl = seen["conv"].is_contiguous(memory_format=torch.channels_last)
    _require(cl and conv.weight.is_contiguous(
        memory_format=torch.channels_last),
        "layer1.0.conv2's weight and output are channels-last")
    bn = model.layer1[0].bn2
    _require(seen["bn"].dtype == torch.bfloat16
             and bn._mean.dtype == bn._variance.dtype == torch.float32
             and bn.weight.dtype == torch.float32
             and not torch.equal(bn._mean, mean0),
             "batch norm: bf16 output, fp32 parameters and running "
             "statistics that the steps moved")
    _no_kernel_launched(counts, "resnet50_train")
    split = _step_split(events, warm, timed, RESNET_BATCH, 1)
    images_per_s = split.pop("tokens_per_s")
    del model, opt, batches, seen
    torch.cuda.empty_cache()
    return {"batch": RESNET_BATCH, "image_size": RESNET_SIZE,
            "classes": RESNET_CLASSES, "warmup_steps": warm,
            "timed_steps": timed, "losses": losses,
            "images_per_s": images_per_s, **split,
            "optimizer_share_of_step": split["optimizer_ms"]
            / split["step_ms"],
            "model_flop_share": RESNET_TRAIN_FLOP * images_per_s
            / H100_BF16_FLOPS,
            "model_flop_share_basis": "3 x 2 x 4.089e9 FLOP an image "
            "(bench_resnet.py) against 989e12 FLOP/s, the H100 SXM data "
            "sheet's dense bf16 peak",
            "wall_s_all_steps": wall, "peak_memory_gib": peak / 2 ** 30,
            "conv_output_channels_last": cl, "launches": counts}


#: the vision gates, in bf16 steps (2^-7) of the logits' largest magnitude.
#: The bf16 channels-last forward against the fp32 NCHW one rounds every
#: conv output and activation to bf16 through 53 convolutions and batch
#: norms of a random-init ResNet-50: 15.3 steps and a first-loss gap of
#: 0.030 measured on an H100 (PERF.md), held to about twice and three
#: times that. The two layouts in bf16 differ only in cuDNN's and the batch
#: norms' summation orders, each output rounded once at places a rounding
#: apart: 0.31 of a step measured.
VS_FP32_STEPS = 32
VS_FP32_LOSS_TOL = 0.1
LAYOUT_STEPS = 4


def resnet50_vs_plain(torch, np):
    """The same weights (``torch.manual_seed(1)``) and batches (batch 32)
    through 3 train steps twice: the bf16 channels-last run of the phase
    and an fp32 NCHW run (layout autotune off). The first step's logits
    within ``VS_FP32_STEPS`` bf16 steps of the largest fp32 logit and the
    first loss within ``VS_FP32_LOSS_TOL``; then, after the steps, the bf16
    model's eval logits (the running statistics) channels-last against the
    same model run NCHW within ``LAYOUT_STEPS`` steps: the layout route
    alone."""
    import copy

    batch, steps = 32, 3
    batches = _image_batches(torch, 61, steps, batch, RESNET_SIZE,
                             RESNET_CLASSES, dtype=torch.float32)
    runs = {}
    for name, layout, bf16 in (("bf16_channels_last", True, True),
                               ("fp32_nchw", False, False)):
        with _vision_setup(torch, layout=layout):
            model = _resnet50(torch, 1, bf16=bf16)
            opt = _momentum(model)
            model.train()
            dt = torch.bfloat16 if bf16 else torch.float32
            logits, losses = None, []
            for images, labels in batches:
                out, loss = _vision_step(model, opt, images.to(dt), labels)
                logits = out.float() if logits is None else logits
                losses.append(float(loss))
            runs[name] = (model, logits, losses)
    model, logits, losses = runs["bf16_channels_last"]
    _, ref, ref_losses = runs.pop("fp32_nchw")
    _require(all(np.isfinite(losses + ref_losses)),
             f"losses finite: {losses} {ref_losses}")
    scale = max(1.0, float(ref.abs().max()))
    logit_err = float((logits - ref).abs().max())
    logit_rel_l2 = float((logits - ref).norm() / ref.norm())
    _require(logit_err <= VS_FP32_STEPS * BF16_STEP * scale,
             f"step-1 logits within {VS_FP32_STEPS} bf16 steps of the fp32 "
             f"NCHW run ({logit_err:.3g}, largest {scale:.3g})")
    loss_err = abs(losses[0] - ref_losses[0])
    _require(loss_err <= VS_FP32_LOSS_TOL, f"first loss within "
             f"{VS_FP32_LOSS_TOL} of the fp32 NCHW run ({losses[0]} vs "
             f"{ref_losses[0]})")
    model.eval()
    nchw = copy.deepcopy(model).to(memory_format=torch.contiguous_format)
    images = batches[0][0].to(torch.bfloat16)
    with torch.no_grad():
        with _vision_setup(torch, layout=True):
            cl_logits = model(images).float()
        with _vision_setup(torch, layout=False):
            nchw_logits = nchw(images).float()
    _require(not nchw.conv1.weight.is_contiguous(
        memory_format=torch.channels_last), "the NCHW copy is NCHW")
    scale_eval = max(1.0, float(nchw_logits.abs().max()))
    layout_err = float((cl_logits - nchw_logits).abs().max())
    _require(layout_err <= LAYOUT_STEPS * BF16_STEP * scale_eval,
             f"eval logits channels-last within {LAYOUT_STEPS} bf16 steps "
             f"of NCHW ({layout_err:.3g}, largest {scale_eval:.3g})")
    del runs, model, nchw
    torch.cuda.empty_cache()
    return {"batch": batch, "steps": steps,
            "losses_bf16_channels_last": losses,
            "losses_fp32_nchw": ref_losses,
            "step1_logits_max_abs_diff": logit_err,
            "step1_logits_largest": scale,
            "step1_logits_rel_l2": logit_rel_l2,
            "first_loss_abs_diff": loss_err,
            "eval_logits_layout_max_abs_diff": layout_err,
            "eval_logits_largest": scale_eval}


def resnet50_eval_phase(torch, np):
    """Images/s of ResNet-50's eval forward at batch 128 x 224 x 224, bf16
    with fp32 batch norms, channels-last: 3 warm-up and 10 timed forwards
    under ``no_grad``, launch counts zeroed just before and read just
    after."""
    from paddle_tpu_torch.ops import cuda as kernels

    warm, timed = 3, 10
    with _vision_setup(torch):
        model = _resnet50(torch, 2)
        model.eval()
        (images, _), = _image_batches(torch, 62, 1, RESNET_BATCH,
                                      RESNET_SIZE, RESNET_CLASSES)
        kernels.reset_launch_counts()
        with torch.no_grad():
            for _ in range(warm):
                model(images)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(timed):
                logits = model(images)
            e.record()
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
    _require(bool(logits.isfinite().all()) and logits.dtype == torch.bfloat16
             and tuple(logits.shape) == (RESNET_BATCH, RESNET_CLASSES),
             "eval logits finite, bf16, [128, 1000]")
    _no_kernel_launched(counts, "resnet50_eval")
    ms = s.elapsed_time(e) / timed
    images_per_s = RESNET_BATCH / ms * 1e3
    del model, images
    torch.cuda.empty_cache()
    return {"batch": RESNET_BATCH, "timed_forwards": timed,
            "ms_per_forward": ms, "images_per_s": images_per_s,
            "model_flop_share": RESNET_FWD_FLOP * images_per_s
            / H100_BF16_FLOPS, "launches": counts}


def lenet_phase(torch, np):
    """LeNet (``BASELINE.json`` config 1) on the card: fp32, 5 Adam(1e-3)
    steps on one seeded batch of 64 x 1 x 28 x 28 images: the loss falls;
    launch counts zeroed just before and read just after."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet

    torch.manual_seed(3)
    model = LeNet(num_classes=10)
    opt = Adam(learning_rate=1e-3, parameters=model.parameters())
    (images, labels), = _image_batches(torch, 63, 1, 64, 28, 10, channels=1,
                                       dtype=torch.float32)
    kernels.reset_launch_counts()
    losses = []
    for _ in range(5):
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    counts = kernels.launch_counts()
    _require(all(np.isfinite(losses)) and losses[-1] < losses[0],
             f"LeNet's loss falls: {losses}")
    _no_kernel_launched(counts, "lenet")
    return {"batch": 64, "steps": 5, "losses": losses,
            "device": str(model.parameters()[0].device),
            "launches": counts}


#: the paddle_api phase: warm-up and timed steps of each run
API_STEPS = (3, 5)
#: the card's op sweep: inputs grow ``k`` times per axis from the table's
#: (3 x 4 -> 1152 x 1536), bf16 at a third of that (the CPU reference runs
#: bf16 products slowly) and order ops in bf16 at 16 (bf16 holds 4096
#: distinct values to draw from); linalg at 255 x 255 (``op_table.K_LINALG``)
SWEEP_K, SWEEP_K_BF16 = 384, 128
#: the sweep's limits, a share of the largest magnitude of the CPU port's
#: result: fp32 forward 1e-4 (CUDA's and the host's libm, reduction
#: orders), gradients 1e-3 (a product and a sum over the whole output on
#: top), linalg 1e-2 (cuSOLVER against LAPACK at 255 x 255), bf16 four
#: bf16 steps (2^-5: a product, then rounding to bf16, in other orders)
SWEEP_FWD_TOL, SWEEP_GRAD_TOL, SWEEP_LINALG_TOL = 1e-4, 1e-3, 1e-2
SWEEP_BF16_TOL = 2.0 ** -5
#: outputs compared (the rest are eigenvectors: defined up to sign)
SWEEP_OUTPUTS = {"ops.eigh": (0,)}


def _api_gpt124m(paddle, seed):
    """GPT-2 124M as a Paddle user builds it: ``paddle.seed``, no
    ``device`` (the current place, ``gpu``), bf16 with fp32 LayerNorms
    (the training phase's model, ``_gpt124m``)."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_position_embeddings=1024,
                    hidden_dropout=0.0, attention_dropout=0.0)
    paddle.seed(seed)
    model = GPTForCausalLM(cfg, dtype="bfloat16")
    for layer in model.sublayers():
        if isinstance(layer, paddle.nn.LayerNorm):
            layer.float()
    return model


def _api_train(torch, paddle, model, batches, events):
    """The train step written against the API: ``to_tensor`` batches,
    ``loss = model.loss(...)``, ``loss.backward()``, ``opt.step()``,
    ``opt.clear_grad()``, ``float(loss)``; two CUDA events a step."""
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    model.train()
    losses = []
    for ids, labels in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss = model.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        ev[1].record()
        losses.append(float(loss))
        events.append(ev)
    _require(isinstance(loss, paddle.Tensor) and not loss.stop_gradient,
             "model.loss gives a Paddle Tensor on the graph")
    return losses


def _step_ms(events, warm):
    timed = events[warm:]
    return sum(e[0].elapsed_time(e[-1]) for e in timed) / len(timed)


def paddle_api_train_phase(torch, np):
    """GPT-2 124M's train step written against the Paddle API, batch
    24 x 1024, beside the same steps through plain tensors (the training
    phase's calls) from the same seed and batches: plain, API, plain, so
    both orders are timed in one call. The API's losses must be the plain
    runs' bits; K5-K8's launches are counted over the API run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import cuda as kernels

    warm, timed = API_STEPS
    batches = _token_batches(np, 0, warm + timed, 24, 1024, 50304)
    paddle.set_device("gpu")
    runs, counts = [], None
    for kind in ("plain", "api", "plain"):
        events = []
        if kind == "plain":
            model = _gpt124m(torch, 0)
            losses = [float(x) for x in _train(torch, model, batches,
                                               events=events)]
        else:
            model = _api_gpt124m(paddle, 0)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            losses = _api_train(torch, paddle, model, batches, events)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            api_model = model
        torch.cuda.synchronize()
        runs.append({"kind": kind, "losses": losses,
                     "step_ms": _step_ms(events, warm)})
        if kind == "plain":
            del model
            torch.cuda.empty_cache()
    _require(all(np.isfinite(runs[1]["losses"])), "API losses finite")
    # the first step is a forward from one init on one batch: the same bits
    firsts = {r["losses"][0] for r in runs}
    _require(len(firsts) == 1, f"the first step's loss is the same bits "
             f"through the API and through plain tensors: {firsts}")
    # later steps follow K6's dq, summed with atomics: any two runs differ
    # by its rounding (the two plain runs' spread, printed); the API's are
    # held within TRAIN_LOSS_TOL of both
    spread = max(abs(a - b) for a, b in zip(runs[0]["losses"],
                                            runs[2]["losses"]))
    api_gap = max(abs(a - b) for r in (runs[0], runs[2])
                  for a, b in zip(runs[1]["losses"], r["losses"]))
    _require(api_gap <= TRAIN_LOSS_TOL, f"API losses within "
             f"{TRAIN_LOSS_TOL} of the plain runs: {runs}")
    # the same weights, the same batch, forward only: the API adds no
    # arithmetic, bit for bit
    model = api_model
    with paddle.no_grad():
        for ids, labels in batches[:2]:
            a = model.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
            b = model.loss(torch.from_numpy(ids).cuda(),
                           torch.from_numpy(labels).cuda())
            _require(type(a) is paddle.Tensor and type(b) is torch.Tensor
                     and torch.equal(a, b), "a forward through the API "
                     "gives the plain tensors' bits")
    for name in ("flash_attention_packed_fwd", "flash_attention_packed_bwd",
                 "layer_norm", "layer_norm_bwd"):
        _require(counts[name] > 0, f"kernel {name} launched on the API path")
    return api_model, batches, {
        "batch": 24, "seq": 1024, "warmup_steps": warm, "timed_steps": timed,
        "losses": runs[1]["losses"],
        "plain_losses": [runs[0]["losses"], runs[2]["losses"]],
        "first_loss_same_bits": True, "forward_same_bits": True,
        "plain_run_to_run_spread": spread, "api_gap_to_plain": api_gap,
        "step_ms": {"plain_before": runs[0]["step_ms"],
                    "api": runs[1]["step_ms"],
                    "plain_after": runs[2]["step_ms"]},
        "launches": counts}


def paddle_api_checkpoint_phase(torch, np, model, batches):
    """``paddle.save(model.state_dict())`` then a fresh model's
    ``set_state_dict(paddle.load(...))``: the same eval logits bit for bit,
    for the API run's GPT-2 124M (bf16 saved as fp32, cast back) and for
    ResNet-50 at batch 32 after a train-mode forward moved its batch-norm
    buffers."""
    import tempfile

    import paddle_tpu_torch as paddle

    out = {}
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/gpt.pdparams"
        t0 = time.perf_counter()
        paddle.save(model.state_dict(), path)
        save_s = time.perf_counter() - t0
        fresh = _api_gpt124m(paddle, 99)
        t0 = time.perf_counter()
        missing, unexpected = fresh.set_state_dict(paddle.load(path))
        load_s = time.perf_counter() - t0
        _require(not missing and not unexpected, "GPT state names match")
        ids = paddle.to_tensor(batches[0][0][:4])
        model.eval()
        fresh.eval()
        with paddle.no_grad():
            a, b = model(ids), fresh(ids)
        _require(a.dtype == torch.bfloat16 and torch.equal(a, b),
                 "GPT-2 124M's eval logits are the same bits after the "
                 "round trip")
        out["gpt2_124m"] = {"params": len(model.state_dict()),
                            "save_s": save_s, "load_s": load_s,
                            "same_bits": True}
        del fresh, a, b
        torch.cuda.empty_cache()
        with _vision_setup(torch):
            from paddle_tpu_torch.vision.models import resnet50

            def build(seed):
                paddle.seed(seed)
                m = resnet50(num_classes=RESNET_CLASSES)
                m.to(dtype="bfloat16")
                for layer in m.sublayers():
                    if type(layer).__name__.startswith("BatchNorm"):
                        layer.float()
                return m

            net = build(2)
            (images, _), = _image_batches(torch, 64, 1, 32, RESNET_SIZE,
                                          RESNET_CLASSES)
            x = paddle.to_tensor(images)
            with paddle.no_grad():
                net.train()
                net(x)
            _require(float(net.bn1._mean.abs().sum()) > 0,
                     "the train-mode forward moved the running mean")
            path = f"{d}/resnet.pdparams"
            paddle.save(net.state_dict(), path)
            other = build(3)
            missing, unexpected = other.set_state_dict(paddle.load(path))
            _require(not missing and not unexpected,
                     "ResNet-50 state names match")
            net.eval()
            other.eval()
            with paddle.no_grad():
                a, b = net(x), other(x)
            _require(torch.equal(a, b) and torch.equal(
                net.bn1._variance, other.bn1._variance),
                "ResNet-50's eval logits and buffers are the same bits "
                "after the round trip")
            out["resnet50"] = {"batch": 32, "entries": len(net.state_dict()),
                               "same_bits": True}
            del net, other, a, b
    torch.cuda.empty_cache()
    return out


def _sweep_close(got, want, tol):
    """None, or why ``got`` is not within ``tol`` of the largest magnitude
    of ``want`` (exact for integers and booleans, Inf/NaN where ``want``
    has them)."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return f"shape {got.shape} vs {want.shape}"
    if want.dtype.kind in "biu":
        return None if np.array_equal(got, want) else "integers differ"
    got, want = got.astype(np.float64), want.astype(np.float64)
    fin = np.isfinite(want)
    if not (np.array_equal(np.isfinite(got), fin)
            and np.array_equal(got[~fin], want[~fin])):
        return "Inf/NaN placed otherwise"
    if not fin.any():
        return None
    scale = max(np.abs(want[fin]).max(), 1e-30)
    err = np.abs(got[fin] - want[fin]).max()
    return None if err <= tol * scale else f"{err:.3g} > {tol} x {scale:.3g}"


def paddle_api_op_sweep(torch, np):
    """Every op of the port's registry on CUDA against the port on the CPU
    (``paddle_tpu_torch/ops/op_table.py``'s differentiable and
    non-differentiable tables, scaled up): fp32, and bf16 where the op takes
    floats and is not one of the JAX table's fp32-only decompositions;
    forward and the gradient of ``sum(out * c)``. A case that raises on
    CUDA (a refused dtype) fails the phase as one that disagrees does."""
    import zlib

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import dispatch, op_table as T

    t0 = time.perf_counter()
    on_card, held, failed, times = set(), 0, [], []
    cases = 0
    for entry in T.OPS + T.NONDIFF:
        has_float = any(d not in ("bool", "sign") and not d.startswith("int:")
                        for _, d in entry["inputs"]) or not entry["inputs"]
        dtypes = [None] + (["bfloat16"] if has_float and entry["inputs"]
                           and entry["api"] not in T.LOWP else [])
        for dt in dtypes:
            cases += 1
            unique = any(d == "funique" for _, d in entry["inputs"])
            # bf16 has 4096 distinct values to spare: order ops (whose
            # indices and gradients follow ties) run at 16 x there
            k = (SWEEP_K if dt is None else 16 if unique
                 else SWEEP_K_BF16)
            e = T.scaled(entry, k)
            rng = np.random.RandomState(zlib.crc32(entry["api"].encode())
                                        % 2 ** 31)
            arrays = [T.draw(s, "funique_bf16" if dt and d == "funique"
                             else d, rng) for s, d in e["inputs"]]
            tc = time.perf_counter()
            if dt is not None:
                arrays = [torch.from_numpy(a).bfloat16().float().numpy()
                          if a.dtype == np.float32 else a for a in arrays]
            what = f"{entry['api']} [{dt or 'float32'}, k {e['k']}]"
            try:
                paddle.set_device("gpu")
                with T.registry_ops_called() as called:
                    got = T.run(e, arrays, paddle, "gpu", dtype=dt)
                on_card |= called
                paddle.set_device("cpu")
                want = T.run(e, arrays, paddle, "cpu", dtype=dt)
            except Exception as exc:  # noqa: BLE001 - reported, then fails
                failed.append(f"{what}: {type(exc).__name__}: "
                              f"{str(exc)[:200]}")
                continue
            finally:
                paddle.set_device("gpu")
            lin = entry["api"] in T.LINALG
            ftol = (SWEEP_BF16_TOL if dt else SWEEP_LINALG_TOL if lin
                    else SWEEP_FWD_TOL)
            gtol = (SWEEP_BF16_TOL if dt else SWEEP_LINALG_TOL if lin
                    else SWEEP_GRAD_TOL)
            keep = SWEEP_OUTPUTS.get(entry["api"], range(len(want[0])))
            why = [f"output {i}: {r}" for i in keep
                   for r in [_sweep_close(got[0][i], want[0][i], ftol)]
                   if r is not None and not (
                       dt and np.asarray(want[0][i]).dtype.kind in "biu")]
            if (got[1] is None) != (want[1] is None):
                why.append("a gradient on one side only")
            for i, (g, w) in enumerate(zip(got[1] or [], want[1] or [])):
                if (g is None) != (w is None):
                    why.append(f"grad {i} on one side only")
                elif g is not None:
                    r = _sweep_close(g, w, gtol)
                    if r is not None:
                        why.append(f"grad {i}: {r}")
            times.append((time.perf_counter() - tc, what))
            if why:
                failed.append(f"{what}: {'; '.join(why)}")
            else:
                held += 1
    torch.cuda.empty_cache()
    registry = set(dispatch.OP_REGISTRY)
    missed = sorted(registry - on_card)
    seconds = time.perf_counter() - t0
    result = {"cases": cases, "held": held, "failed": failed,
              "registry_ops": len(registry),
              "registry_ops_on_card": len(registry & on_card),
              "registry_ops_not_run": missed, "seconds": seconds,
              "k": SWEEP_K, "k_bf16": SWEEP_K_BF16,
              "k_linalg": T.K_LINALG,
              "slowest_s": [[round(t, 3), w] for t, w in sorted(
                  times, reverse=True)[:8]]}
    print(f"paddle_api ops held {held}/{cases} ({len(registry & on_card)}"
          f"/{len(registry)} registry ops on the card) in {seconds:.1f} s")
    for f in failed:
        print(f"paddle_api op failed: {f}")
    _require(not failed, f"{len(failed)} op sweep cases failed")
    _require(not missed, f"registry ops not run on the card: {missed}")
    return result


#: the hapi_gpt2 phase: warm-up and timed steps, batch, sequence length,
#: fence cadence (``fit``'s ``log_freq``) and the share of the loops' step
#: time hapi's may differ by (reported, not enforced)
HAPI_STEPS = (3, 10)
HAPI_BATCH, HAPI_SEQ, HAPI_LOG_FREQ = 24, 1024, 5
HAPI_STEP_TOL = 0.03
#: the hapi_resume phase: batch, sequence, steps of its one epoch, the
#: checkpoint cadence and the step SIGTERM lands after
RESUME_BATCH, RESUME_STEPS, RESUME_CKPT_FREQ, RESUME_KILL_AT = 8, 12, 4, 6
#: the hapi_lenet phase: images of the synthetic MNIST, batch, and the eval
#: top-1 accuracy one epoch must reach: the CPU test's epoch of 1,280 images
#: (20 steps) reaches it
#: (tests/test_torch_hapi.py::test_synthetic_mnist_is_learnable_in_one_epoch)
LENET_TRAIN, LENET_TEST, LENET_BATCH = 60000, 10000, 64
LENET_MIN_ACC = 0.9
#: the synthetic MNIST's noise against its unit class templates
MNIST_NOISE = 1.0


def synthetic_mnist(np, seed, n, classes=10):
    """``n`` MNIST-shaped images (``[n, 1, 28, 28]`` fp32) and labels
    (``[n, 1]`` int64) from ``seed``: each image is its class's template
    (standard normal, drawn from ``seed`` too) plus ``MNIST_NOISE`` times
    standard normal noise, so one epoch can learn the classes."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(12345).standard_normal(
        (classes, 1, 28, 28), dtype=np.float32)
    labels = rng.integers(0, classes, (n, 1), dtype=np.int64)
    images = rng.standard_normal((n, 1, 28, 28), dtype=np.float32)
    images *= MNIST_NOISE
    images += templates[labels[:, 0]]
    return images, labels


def _token_sequences(np, seed, n, seq, vocab):
    """``n`` sequences of ``seq + 1`` random ids; inputs ``ids[:-1]``,
    labels ``ids[1:]``."""
    ids = np.random.RandomState(seed).randint(0, vocab, (n, seq + 1))
    return ids[:, :-1].copy(), ids[:, 1:].copy()


class _SyncLog:
    """Counts the synchronising CUDA calls ``set_sync_debug_mode("warn")``
    reports, by Python call site, while it is on (``on()`` / ``off()``
    inside one ``warnings.catch_warnings`` block)."""

    def __init__(self, torch):
        import collections
        import warnings

        self.torch = torch
        self.sites = collections.Counter()
        self._catch = warnings.catch_warnings(record=True)
        self._records = None
        self._warnings = warnings


    def __enter__(self):
        self._records = self._catch.__enter__()
        self._warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        self.off()
        self._catch.__exit__(*exc)
        return False

    def on(self):
        self._records.clear()
        self.torch.cuda.set_sync_debug_mode("warn")

    def off(self):
        if self.torch.cuda.get_sync_debug_mode() == 0:
            return
        self.torch.cuda.set_sync_debug_mode(0)
        for w in self._records:
            if "synchroniz" in str(w.message):
                site = w.filename.replace("\\", "/").split("/repo/")[-1]
                self.sites[f"{site}:{w.lineno}"] += 1
        self._records.clear()


def _hapi_loop(torch, model, loader, events, syncs, warm):
    """The hand-written loop of the hapi_gpt2 phase over ``loader`` (the
    same kind of ``DataLoader`` as ``fit``'s): forward, ``F.cross_entropy``,
    backward, step, clear_grad, the loss read back where ``fit`` fences (the
    first step and every ``HAPI_LOG_FREQ``-th: a user's loop logging at
    that cadence); an event after each step; the timed steps' syncs
    counted."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    losses = []
    for step, (ids, labels) in enumerate(loader):
        if step == warm:
            syncs.on()
        loss = F.cross_entropy(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
        if step == 0 or (step + 1) % HAPI_LOG_FREQ == 0:
            float(losses[-1])  # the loop's log line
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((ev, time.perf_counter()))
    syncs.off()
    return [float(x) for x in losses]


def _window_ms(events, warm):
    """ms a step over the timed steps: from the end of the last warm-up
    step to the end of the last step, on the device clock."""
    return events[warm - 1].elapsed_time(events[-1]) / (len(events) - warm)


def hapi_gpt2_phase(torch, np):
    """GPT-2 124M trained through ``paddle.Model``: ``prepare(AdamW(1e-4,
    multi_precision), nn.CrossEntropyLoss())`` then ``fit`` over an
    in-memory ``io.TensorDataset`` of 13 x 24 sequences of 1025 ids through
    a process-worker ``DataLoader`` (2 workers, shuffled), between two
    hand-written loops over the same kind of ``DataLoader`` (the same
    batches in the same order) from the same init. Launch counts are
    zeroed just before ``fit`` and read just after it; the timed steps'
    synchronising calls are counted by site."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import cuda as kernels

    warm, timed = HAPI_STEPS
    steps = warm + timed
    n = steps * HAPI_BATCH
    inputs, labels = _token_sequences(np, 15, n, HAPI_SEQ, 50304)
    data = paddle.io.TensorDataset([inputs, labels])
    # the DataLoader's RandomSampler draws np.random.permutation(n) at the
    # start of the epoch: every run seeds numpy alike, so all take the same
    # batches in the same order
    order_seed = 1234
    paddle.set_device("gpu")
    runs = []
    for kind in ("loop", "hapi", "loop"):
        model = _gpt124m(torch, 0)
        loader = paddle.io.DataLoader(data, batch_size=HAPI_BATCH,
                                      shuffle=True, num_workers=2,
                                      use_process=True)
        events, syncs = [], _SyncLog(torch)
        torch.cuda.synchronize()
        with syncs:
            if kind == "loop":
                np.random.seed(order_seed)
                losses = _hapi_loop(torch, model, loader, events, syncs,
                                    warm)
                fence_losses = None
            else:
                hapi = paddle.Model(model)
                hapi.prepare(paddle.optimizer.AdamW(
                    learning_rate=1e-4, parameters=model.parameters(),
                    multi_precision=True), paddle.nn.CrossEntropyLoss())
                fences = {}

                class Timer(paddle.callbacks.Callback):
                    def on_train_batch_begin(self, step, logs=None):
                        if step == warm:
                            syncs.on()

                    def on_train_batch_end(self, step, logs=None):
                        ev = torch.cuda.Event(enable_timing=True)
                        ev.record()
                        events.append((ev, time.perf_counter()))
                        if step == 0 or (step + 1) % HAPI_LOG_FREQ == 0:
                            fences[step] = logs["loss"]

                    def on_train_end(self, logs=None):
                        syncs.off()
                        fences[steps - 1] = logs["loss"]

                np.random.seed(order_seed)
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                hapi.fit(loader, epochs=1, log_freq=HAPI_LOG_FREQ,
                         verbose=0, callbacks=[Timer()])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = kernels.launch_counts()
                peak = torch.cuda.max_memory_allocated()
                fence_losses = fences
                losses = None
        torch.cuda.synchronize()
        runs.append({"kind": kind, "losses": losses, "fences": fence_losses,
                     "step_ms": _window_ms([e for e, _ in events], warm),
                     "steps_ms": [a.elapsed_time(b) for (a, _), (b, _) in
                                  zip(events[warm - 1:], events[warm:])],
                     "host_steps_ms": [1e3 * (b - a) for (_, a), (_, b) in
                                       zip(events[warm - 1:], events[warm:])],
                     "steps": len(events), "syncs": dict(syncs.sites),
                     "model": model if kind == "hapi" else None,
                     "hapi": hapi if kind == "hapi" else None})
        if kind == "loop":
            del model
            torch.cuda.empty_cache()
    before, run, after = runs
    loop_ms = (before["step_ms"], after["step_ms"])
    _require(all(r["steps"] == steps for r in runs),
             f"every run took {steps} steps: {[r['steps'] for r in runs]}")
    fences = run["fences"]
    _require(sorted(fences) == [0, 4, 9, 12], f"fences at {sorted(fences)}")
    _require(all(np.isfinite(list(fences.values()))), "hapi losses finite")
    # the first step is a forward from one init on one batch: the same bits
    firsts = {fences[0], before["losses"][0], after["losses"][0]}
    _require(len(firsts) == 1, f"the first loss is the same bits through "
             f"hapi and the hand-written loops: {firsts}")
    # later steps follow K6's dq, summed with atomics: hapi's losses at the
    # fences stay within the two loops' own spread
    spread = max(abs(a - b) for a, b in zip(before["losses"],
                                            after["losses"]))
    for s, v in fences.items():
        lo = min(before["losses"][s], after["losses"][s]) - spread
        hi = max(before["losses"][s], after["losses"][s]) + spread
        _require(lo <= v <= hi, f"hapi's loss at step {s} ({v}) within the "
                 f"loops' spread [{lo}, {hi}]")
    # K5-K8 at GPT-2's 12 layers: 12 attention forwards and backwards, 25
    # LayerNorms (2 a block and the final one) a step
    per_step = {"flash_attention_packed_fwd": 12,
                "flash_attention_packed_bwd": 12,
                "layer_norm": 25, "layer_norm_bwd": 25}
    for name, k in per_step.items():
        _require(counts[name] == k * steps, f"{name} launched {counts[name]}"
                 f" times in {steps} hapi steps (want {k} a step)")
    # no synchronising call between fences over the hand-written loop's:
    # the fences (the AsyncMetricBuffer's one read back) are the only sync
    # sites hapi may add
    drains = {s: c for s, c in run["syncs"].items()
              if "metric/async_buffer.py" in s}
    extra = {s: c for s, c in run["syncs"].items()
             if s not in drains and c > max(before["syncs"].get(s, 0),
                                            after["syncs"].get(s, 0))}
    _require(not extra, f"hapi's timed steps sync where the loops do not: "
             f"{extra}")
    # the step-time comparison is a measurement, not a correctness check:
    # these steps are host-paced, and whole runs of the same loop differ by
    # up to ~8 % on the card, so it is printed with its verdict and does not
    # fail the run. The median of the timed steps leaves out the one stall
    # of the process DataLoader (its last task issued) and fence outliers
    medians = [float(np.median(r["steps_ms"])) for r in runs]
    lo, hi = min(medians[0], medians[2]), max(medians[0], medians[2])
    gate = {"statistic": "median ms of the timed steps",
            "loop_before": medians[0], "hapi": medians[1],
            "loop_after": medians[2],
            "within": lo * (1 - HAPI_STEP_TOL) <= medians[1]
            <= hi * (1 + HAPI_STEP_TOL),
            "tolerance": HAPI_STEP_TOL}
    # evaluate on 2 batches: the logged loss is the last batch's, the bits
    # of a forward of the same weights
    hapi, model = run["hapi"], run["model"]
    ev_loader = paddle.io.DataLoader(
        paddle.io.TensorDataset([inputs[:2 * HAPI_BATCH],
                                 labels[:2 * HAPI_BATCH]]),
        batch_size=HAPI_BATCH)
    t0 = time.perf_counter()
    ev = hapi.evaluate(ev_loader, verbose=0)
    eval_s = time.perf_counter() - t0
    model.eval()
    with torch.no_grad():
        x = torch.from_numpy(inputs[HAPI_BATCH:2 * HAPI_BATCH]).cuda()
        y = torch.from_numpy(labels[HAPI_BATCH:2 * HAPI_BATCH]).cuda()
        want = float(F.cross_entropy(model(x), y))
    _require(ev["loss"] == want and ev["eval_samples"] == 2 * HAPI_BATCH,
             f"evaluate's loss {ev} is a forward's {want}")
    # predict 4 sequences of 128, stacked: a forward of the same weights
    short = inputs[:4, :128]
    pred = hapi.predict(paddle.io.TensorDataset([short]), batch_size=4,
                        stack_outputs=True, verbose=0)
    with torch.no_grad():
        want = model(torch.from_numpy(short).cuda()).float().cpu().numpy()
    _require(len(pred) == 1 and pred[0].shape == (4, 128, 50304)
             and pred[0].dtype == np.float32
             and np.array_equal(pred[0], want),
             "predict stacks a forward's logits (bf16 as fp32)")
    tokens = HAPI_BATCH * HAPI_SEQ
    out = {
        "batch": HAPI_BATCH, "seq": HAPI_SEQ, "warmup_steps": warm,
        "timed_steps": timed, "log_freq": HAPI_LOG_FREQ,
        "dataloader": "process workers 2, shuffled, forkserver",
        "step_ms": {"loop_before": loop_ms[0], "hapi": run["step_ms"],
                    "loop_after": loop_ms[1]},
        "step_gate": gate,
        "timed_steps_ms": {k: r["steps_ms"] for k, r in zip(
            ("loop_before", "hapi", "loop_after"), runs)},
        "timed_steps_host_ms": {k: r["host_steps_ms"] for k, r in zip(
            ("loop_before", "hapi", "loop_after"), runs)},
        "tokens_per_s": {"loop_before": tokens * 1e3 / loop_ms[0],
                         "hapi": tokens * 1e3 / run["step_ms"],
                         "loop_after": tokens * 1e3 / loop_ms[1]},
        "fit_wall_s": wall,
        "hapi_fence_losses": {str(k): v for k, v in sorted(fences.items())},
        "loop_losses": [before["losses"], after["losses"]],
        "first_loss_same_bits": True, "loop_run_to_run_spread": spread,
        "syncs_per_step": {k: sum(r["syncs"].values()) / timed
                           for k, r in zip(("loop_before", "hapi",
                                            "loop_after"), runs)},
        "sync_sites": {k: r["syncs"] for k, r in zip(
            ("loop_before", "hapi", "loop_after"), runs)},
        "fence_syncs": drains,
        "peak_memory_gib": peak / 2 ** 30,
        "evaluate": {"loss": ev["loss"], "samples": ev["eval_samples"],
                     "seconds": eval_s},
        "predict_shape": list(pred[0].shape),
        "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()}}
    for r in runs:
        r.clear()
    del hapi, model, run, runs
    torch.cuda.empty_cache()
    return out


def _rng_states(torch):
    """Every generator ``fault.TrainState`` keeps, as host copies."""
    from paddle_tpu_torch.framework import random as prandom

    return {"seed": prandom._seed,
            "port_cpu": prandom.get_rng_state().clone(),
            "port_cuda": prandom.get_cuda_rng_state().clone(),
            "torch_cpu": torch.get_rng_state(),
            "torch_cuda": [s.clone() for s in torch.cuda.get_rng_state_all()]}


def _host_state(torch, hapi):
    """Host copies of a training pair's live state: parameters, the
    optimizer's ``state_dict`` (masters and moments), its LR scheduler,
    every torch generator and numpy's."""
    def host(v):
        return v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v

    opt = hapi._optimizer
    return {"params": {k: host(v)
                       for k, v in hapi.network.state_dict().items()},
            "optimizer": {k: host(v) for k, v in opt.state_dict().items()},
            "scheduler": dict(opt._learning_rate.state_dict()),
            "rng": _rng_states(torch)}


def _same_state(torch, got, want):
    """Names of the entries of two ``_host_state`` that differ in a bit."""
    bad = []

    def same(a, b):
        if isinstance(a, torch.Tensor):
            if not isinstance(b, torch.Tensor) or a.shape != b.shape:
                return False
            if a.dtype != b.dtype:
                # a checkpoint holds a bf16 tensor as fp32 (exact), and an
                # accumulator not made yet keeps the fp32 it was read as
                if {a.dtype, b.dtype} != {torch.bfloat16, torch.float32}:
                    return False
                a, b = a.float(), b.float()
            return torch.equal(a, b)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return a == b

    for part in ("params", "optimizer", "scheduler", "rng"):
        for k in want[part]:
            if k not in got[part] or not same(got[part][k], want[part][k]):
                bad.append(f"{part}.{k}")
    return bad


def hapi_resume_phase(torch, np):
    """GPT-2 124M through ``fit`` at batch 8 x 1024, one shuffled epoch of
    12 steps (AdamW multi_precision on a cosine schedule): two uninterrupted
    runs; a run with ``fit(resume=dir, ckpt_freq=4)`` stopped by an injected
    SIGTERM after step 6; a fresh model and optimizer resuming from the
    directory. The resumed state must be the stopped run's at step 6 bit for
    bit, steps 7-12 must see run 1's input ids and stay within the two
    uninterrupted runs' spread."""
    import hashlib
    import os
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.fault import TrainingPreempted, inject
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.profiler import telemetry

    n = RESUME_BATCH * RESUME_STEPS
    inputs, labels = _token_sequences(np, 16, n, HAPI_SEQ, 50304)
    data = paddle.io.TensorDataset([inputs, labels])
    ckpt = tempfile.mkdtemp(prefix="hapi_resume_")

    def make():
        net = _gpt124m(torch, 0)
        hapi = paddle.Model(net)
        sched = paddle.optimizer.lr.CosineAnnealingDecay(
            learning_rate=1e-4, T_max=RESUME_STEPS)
        hapi.prepare(paddle.optimizer.AdamW(
            learning_rate=sched, parameters=net.parameters(),
            multi_precision=True), paddle.nn.CrossEntropyLoss())
        seen = []
        net.register_forward_pre_hook(lambda layer, args: seen.append(
            hashlib.sha1(args[0].cpu().numpy().tobytes()).hexdigest()[:12]))
        return hapi, seen

    class Record(paddle.callbacks.Callback):
        def __init__(self, keep_at=None):
            super().__init__()
            self.losses, self.first_step = [], None
            self.keep_at, self.kept, self.begin = keep_at, None, None
            self.epoch_np = None

        def on_train_begin(self, logs=None):
            self.begin = (time.perf_counter(),
                          _host_state(torch, self.model))

        def on_epoch_begin(self, epoch, logs=None):
            self.epoch_np = np.random.get_state()[1].copy()

        def on_train_batch_begin(self, step, logs=None):
            if self.first_step is None:
                self.first_step = step

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            if step + 1 == self.keep_at:
                self.kept = _host_state(torch, self.model)

    def fit(hapi, cb, seed=77, **kw):
        # the epoch's shuffle draws from numpy; a resumed run is seeded
        # otherwise, and its checkpoint must bring the order back
        np.random.seed(seed)
        hapi.fit(data, batch_size=RESUME_BATCH, epochs=1, shuffle=True,
                 log_freq=1, verbose=0, callbacks=[cb], **kw)

    try:
        kernels.reset_launch_counts()
        full = []
        for _ in range(2):
            hapi, seen = make()
            cb = Record()
            fit(hapi, cb)
            full.append((cb.losses, seen))
            del hapi
            torch.cuda.empty_cache()
        # run 2: SIGTERM lands after step 6; the checkpoint is flushed then
        hapi, seen2 = make()
        stopped = Record(keep_at=RESUME_KILL_AT)
        telemetry.reset()
        telemetry.enable()
        inject.arm("sigterm", "train.step", at=RESUME_KILL_AT)
        try:
            fit(hapi, stopped, resume=ckpt, ckpt_freq=RESUME_CKPT_FREQ,
                keep_last_n=1)
            raise AssertionError("fit ran past the injected SIGTERM")
        except TrainingPreempted:
            pass
        finally:
            inject.disarm_all()
            telemetry.disable()
        tm = telemetry.get_telemetry()
        saves = {"count": tm.stat("fault.ckpt_save_s", "count"),
                 "mean_s": tm.stat("fault.ckpt_save_s", "mean"),
                 "max_s": tm.stat("fault.ckpt_save_s", "max")}
        telemetry.reset()
        step_dir = os.path.join(ckpt, f"step_{RESUME_KILL_AT:08d}")
        ckpt_bytes = {f: os.path.getsize(os.path.join(step_dir, f))
                      for f in sorted(os.listdir(step_dir))}
        del hapi
        torch.cuda.empty_cache()
        # run 3: a fresh model and optimizer from the directory
        hapi, seen3 = make()
        resumed = Record()
        t0 = time.perf_counter()
        fit(hapi, resumed, seed=99, resume=ckpt, keep_last_n=1)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        restore_s = resumed.begin[0] - t0
        del hapi
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    bad = _same_state(torch, resumed.begin[1], stopped.kept)
    _require(not bad, f"the resumed state differs from the stopped run's "
             f"at step {RESUME_KILL_AT}: {bad}")
    _require(resumed.epoch_np is not None
             and np.array_equal(resumed.epoch_np, stopped.epoch_np),
             "numpy's state is the stopped run's at its epoch's start")
    _require(resumed.first_step == RESUME_KILL_AT,
             f"the resumed run starts at step {resumed.first_step}")
    (l1, s1), (l2, s2) = full
    _require(s1 == s2 and seen2 == s1[:RESUME_KILL_AT]
             and seen3 == s1[RESUME_KILL_AT:],
             "every run sees run 1's input ids at every step")
    losses = stopped.losses + resumed.losses
    spread = max(abs(a - b) for a, b in zip(l1, l2))
    for s in range(RESUME_STEPS):
        lo, hi = min(l1[s], l2[s]) - spread, max(l1[s], l2[s]) + spread
        _require(lo <= losses[s] <= hi, f"step {s + 1}'s loss {losses[s]} "
                 f"within the uninterrupted runs' spread [{lo}, {hi}]")
    _require(counts["flash_attention_packed_fwd"] > 0
             and counts["layer_norm_bwd"] > 0, "K5-K8 launched")
    return {"batch": RESUME_BATCH, "seq": HAPI_SEQ, "steps": RESUME_STEPS,
            "ckpt_freq": RESUME_CKPT_FREQ, "sigterm_after": RESUME_KILL_AT,
            "restored_bit_for_bit": ["params", "optimizer (fp32 masters, "
                                     "moments, @step)", "LR scheduler",
                                     "port and torch generators", "numpy",
                                     "cursor"],
            "losses_uninterrupted": [l1, l2], "losses_resumed": losses,
            "uninterrupted_spread": spread,
            "input_hashes_replayed": True,
            "checkpoint_bytes": ckpt_bytes,
            "checkpoint_bytes_total": sum(ckpt_bytes.values()),
            "save_s": saves, "restore_s": restore_s,
            "launches": counts}


def hapi_lenet_phase(torch, np):
    """LeNet (``BASELINE.json`` config 1) through ``paddle.Model``:
    ``prepare(Adam(1e-3), CrossEntropyLoss(), Accuracy(topk=(1, 2)))``, one
    epoch of ``fit`` at batch 64 over 60,000 synthetic MNIST images built on
    the host, then ``evaluate`` and ``predict`` over 10,000: images/s
    (host clock around work that ends in a synchronize), the metric line,
    and the eval accuracy against ``LENET_MIN_ACC``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import cuda as kernels
    from paddle_tpu_torch.vision.models import LeNet

    t0 = time.perf_counter()
    x, y = synthetic_mnist(np, 0, LENET_TRAIN)
    tx, ty = synthetic_mnist(np, 1, LENET_TEST)
    build_s = time.perf_counter() - t0
    torch.manual_seed(3)
    net = LeNet(num_classes=10)
    hapi = paddle.Model(net)
    hapi.prepare(paddle.optimizer.Adam(learning_rate=1e-3,
                                       parameters=net.parameters()),
                 paddle.nn.CrossEntropyLoss(),
                 paddle.metric.Accuracy(topk=(1, 2)))
    kernels.reset_launch_counts()
    np.random.seed(5)
    t0 = time.perf_counter()
    logs = hapi.fit(paddle.io.TensorDataset([x, y]), batch_size=LENET_BATCH,
                    epochs=1, log_freq=100, verbose=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = hapi.evaluate(paddle.io.TensorDataset([tx, ty]),
                       batch_size=LENET_BATCH, verbose=0)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = hapi.predict(paddle.io.TensorDataset([tx]), batch_size=LENET_BATCH,
                        stack_outputs=True, verbose=0)
    predict_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    acc = float((pred[0].argmax(-1) == ty[:, 0]).mean())
    _require(pred[0].shape == (LENET_TEST, 10), "predict's stacked logits")
    _require(abs(acc - ev["acc_top1"]) < 1e-9,
             f"predict's accuracy {acc} is evaluate's {ev['acc_top1']}")
    _require(ev["acc_top1"] >= LENET_MIN_ACC, f"LeNet's eval top-1 accuracy "
             f"{ev['acc_top1']} reaches {LENET_MIN_ACC} after one epoch")
    _no_kernel_launched(counts, "hapi_lenet")
    return {"train_images": LENET_TRAIN, "test_images": LENET_TEST,
            "batch": LENET_BATCH, "host_data_bytes": int(
                x.nbytes + y.nbytes + tx.nbytes + ty.nbytes),
            "data_build_s": build_s,
            "train_images_per_s": LENET_TRAIN / train_s,
            "eval_images_per_s": LENET_TEST / eval_s,
            "predict_images_per_s": LENET_TEST / predict_s,
            "train_logs": logs, "eval_logs": ev,
            "min_accuracy": LENET_MIN_ACC, "launches": counts}


_TC_KERNELS = ("fwd_tc_kernel", "dq_tc_kernel", "dkv_tc_kernel",
               "cached_tc_kernel", "packed_bwd_tc_kernel",
               "ce_bwd_cluster_kernel", "ce_fwd_wgmma_kernel")
#: the kernels counted by HGMMA alone
_WGMMA_KERNELS = ("ce_bwd_cluster_kernel", "ce_fwd_wgmma_kernel")


def _tc_instantiations():
    """``{kernel: bf16 instantiations}``: K1-K3 one a tensor-core width
    (16..128) and dropout switch, K4's prefill one a width, K6 one a packed
    head dim and dropout switch."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as k1
    from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5

    widths = sum(1 for w in k1.FLASH_WIDTHS
                 if k1.kernel_route(torch.bfloat16, w) == "mma.sync")
    from paddle_tpu_torch.ops.cuda import fused_ce as k9

    return {"fwd_tc_kernel": 2 * widths, "dq_tc_kernel": 2 * widths,
            "dkv_tc_kernel": 2 * widths, "cached_tc_kernel": widths,
            "packed_bwd_tc_kernel": 2 * len(k5.HEAD_DIMS),
            "ce_bwd_cluster_kernel": len(k9.SLICE_CHUNKS),
            "ce_fwd_wgmma_kernel": 1}


def tensor_core_sass(path):
    """HMMA (mma.sync) or HGMMA (wgmma) instructions in each bf16
    tensor-core function (K1, K2, K3, K4's prefill, K6) of the built
    library, from ``cuobjdump -sass``; fails if an instantiation has
    none."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            cur = (name if any(k in name for k in _TC_KERNELS)
                   and "bfloat16" in name else None)
            if cur is not None:
                counts[cur] = 0
        elif cur is not None and (
                "HGMMA" in line
                or "HMMA" in line
                and not any(k in cur for k in _WGMMA_KERNELS)):
            counts[cur] += 1
    for kern, want in _tc_instantiations().items():
        found = {n: c for n, c in counts.items() if kern in n}
        _require(len(found) == want, f"{want} bf16 {kern} instantiations in "
                 f"the SASS ({len(found)})")
        _require(all(c > 0 for c in found.values()),
                 f"tensor-core instructions in every bf16 {kern}: {found}")
    return counts


#: the attention kernels whose ptxas registers and spills are reported
_PTXAS_KERNELS = _TC_KERNELS + ("fwd_wide_kernel", "dq_wide_kernel",
                                "dkv_wide_kernel", "cached_fwd_kernel",
                                "cached_split_kernel", "cached_merge_kernel")
#: K9's kernels: the bf16/fp16 wgmma kernel, its range merge, the fp32 FMA
#: kernels
_K9_KERNELS = ("ce_fwd_wgmma_kernel", "ce_fwd_merge_kernel", "ce_fwd_kernel",
               "ce_fwd_stream_kernel")
#: K7's and K8's kernels (row kernels <type, accesses a lane, vectors>,
#: general kernels <type, vectors>, K8's reduction <gamma's type>)
_LN_KERNELS = ("ln_fwd_rows", "ln_bwd_rows", "ln_fwd_general",
               "ln_bwd_general", "ln_bwd_reduce")


def _ln_on_paths(name):
    """K7/K8 instantiations the paths run: bf16 x on 16-byte vectors, 3
    (width 768) or 6 (1536) a lane in the row kernels, the general
    kernels (K7 at decode, width 5120), and the reduction into fp32
    gamma."""
    return "ln_bwd_reduceIf" in name or "bfloat16" in name and (
        "Li3ELb1E" in name or "Li6ELb1E" in name
        or "generalI13__nv_bfloat16Lb1E" in name)


def ptxas_report(log, kernels=_PTXAS_KERNELS,
                 keep=lambda name: "bfloat16" in name):
    """``{kernel<type,widths,switches>: [registers, spill store bytes]}``
    of the ``kernels`` instantiations that ``keep`` takes (the bf16
    attention kernels by default), from the build's ``-Xptxas -v``
    report."""
    import re

    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kern = next((k for k in kernels if k in name), None)
            cur = None
            if kern is not None and keep(name):
                args = name.split(kern, 1)[1]
                ints = re.findall(r"Li(\d+)E", args)
                flags = re.findall(r"Lb([01])E", args)
                dt = ("bf16" if "bfloat16" in name else
                      "fp16" if "__half" in name else
                      "fp32" if "If" in args[:4] else "")
                cur = f"{kern}<{','.join(([dt] if dt else []) + ints + flags)}>"
        elif cur is not None and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur is not None and "registers" in line and "Used" in line:
            out[cur] = [int(line.split("Used")[1].split("registers")[0]), spill]
            cur = None
    return out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = _card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from paddle_tpu_torch.ops.cuda import build_info, library

    t0 = time.perf_counter()
    library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s (nvcc {build_info()['seconds']:.1f} s)")
    hmma = tensor_core_sass(build_info()["path"])
    print(f"tensor-core SASS (HMMA/HGMMA a bf16 K1/K2/K3/K4/K6 function, "
          f"HGMMA a bf16 K10/K11 cluster function and the bf16 K9 wgmma "
          f"function): {json.dumps(hmma)}")
    ptxas = ptxas_report(build_info().get("log", ""))
    print(f"ptxas [registers, spill bytes] of the bf16 attention, K10/K11 "
          f"cluster and K9 wgmma kernels: {json.dumps(ptxas)}")
    ptxas_k9 = ptxas_report(build_info().get("log", ""), _K9_KERNELS,
                            lambda name: True)
    print(f"ptxas [registers, spill bytes] of the K9 instantiations "
          f"(registers at launch; the wgmma kernel's consumers raise to 232 "
          f"with setmaxnreg): {json.dumps(ptxas_k9)}")
    ptxas_ln = ptxas_report(build_info().get("log", ""), _LN_KERNELS,
                            _ln_on_paths)
    print(f"ptxas [registers, spill bytes] of the K7/K8 kernels on the "
          f"paths (<type, accesses a lane, 16-byte vectors>): "
          f"{json.dumps(ptxas_ln)}")
    timer = _Timer(torch)
    # bring the clocks up before the first timing: half a second of work
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        timer.flush.add_(1)
    torch.cuda.synchronize()
    ln_cases, fa_cases = kernel_phase(torch, timer)
    k5_cases, k6_cases, ln_train, k8_cases = training_kernel_phase(torch,
                                                                   timer)
    ln_cases += ln_train
    k9_cases, k10_cases, k11_cases, chunked = fused_ce_kernel_phase(torch,
                                                                    timer)
    k1_cases, k2_cases, k3_cases = flash_kernel_phase(torch, timer)
    dropout_cases, philox_check = dropout_kernel_phase(torch, timer)
    for c in (ln_cases + fa_cases + k5_cases + k6_cases + k8_cases
              + k9_cases + k10_cases + k11_cases + k1_cases + k2_cases
              + k3_cases):
        lib = ("none" if c["library_ms"] is None
               else f"{c['library_ms']:.4f}")
        rel = (f", relative L2 {c['rel_l2_err']:.3g}" if "rel_l2_err" in c
               else "")
        route = (f" [{c['route']}, {c['tflops']:.1f} TFLOP/s, "
                 f"{100 * c['share_of_bound']:.1f} % of bound]"
                 if "tflops" in c else
                 f" [{c['route']}]" if "route" in c else
                 f" [{c['kernel_plan']['kernel']}, "
                 f"{100 * c['share_of_bound']:.1f} % of bound]"
                 if "kernel_plan" in c else "")
        print(f"kernel {c['case']}: {c['ms']:.4f} ms (plain "
              f"{c['plain_ms']:.4f}, library {lib}, bound "
              f"{c['bound_ms']:.4f} by {c['bound_by']}) err "
              f"{c['max_abs_err']:.3g}{rel}{route}")
    for name, c in dropout_cases.items():
        rel = (f", relative L2 {c['rel_l2_err']:.3g}" if "rel_l2_err" in c
               else "")
        print(f"kernel {name} p = {DROPOUT_P}: {c['ms']:.4f} ms (dropout 0 "
              f"{c['ms_dropout_0']:.4f}, plain {c['plain_ms']:.4f}) err "
              f"{c['max_abs_err']:.3g}{rel}")
    print(f"philox: {json.dumps(philox_check)}")
    print(f"chunked loss loop at the train shape: {json.dumps(chunked)}")
    k10_k11 = sum(next(c["ms"] for c in cases if c["case"] == "train")
                  for cases in (k10_cases, k11_cases))
    print(f"K10 + K11 at the train shape: {k10_k11:.4f} ms; the chunked "
          f"loop's backward: {chunked['backward_ms']:.4f} ms")
    for c in k9_cases:
        if "cublas_product_ms" in c:
            print(f"K9 at {c['case']} ({c['shape']['tokens']} x "
                  f"{c['shape']['hidden']} x {c['shape']['vocab']}): "
                  f"{c['ms']:.4f} ms, {100 * c['share_of_bound']:.1f} % of "
                  f"bound; the same product alone on cuBLAS: "
                  f"{c['cublas_product_ms']:.4f} ms; the chunked loop's "
                  f"forward: {c['chunked_loop_fwd_ms']:.4f} ms")
    print(f"build seconds a source: {json.dumps(build_info().get('per_source', {}))}")
    serve = serving_phase(torch, np)
    print(f"serving: {json.dumps(serve)}")
    print(f"serving: {serve['tokens_per_s']:.1f} tokens/s on {card}")
    small = small_reference(torch, np)
    print(f"small reference: {json.dumps(small)}")
    train = training_phase(torch, np)
    per_step = train["launches_per_step"]
    share = {}
    for name, cases, case in (
            ("flash_attention_packed_fwd", k5_cases, "train"),
            ("flash_attention_packed_bwd", k6_cases, "train"),
            ("layer_norm", ln_cases, "rows=24576"),
            ("layer_norm_bwd", k8_cases, "rows=24576")):
        ms = next(c["ms"] for c in cases if c["case"] == case)
        share[name] = per_step[name] * ms / train["step_ms"]
    train["kernel_share_of_step"] = share
    print(f"training: {json.dumps(train)}")
    print(f"training: {train['tokens_per_s']:.1f} tokens/s, step "
          f"{train['step_ms']:.1f} ms (forward {train['forward_ms']:.1f}, "
          f"backward {train['backward_ms']:.1f}, optimizer "
          f"{train['optimizer_ms']:.1f}), peak "
          f"{train['peak_memory_gib']:.2f} GiB on {card}")
    vs_plain = training_vs_plain(torch, np)
    print(f"training vs plain: {json.dumps(vs_plain)}")
    small_train = small_training_reference(torch, np)
    print(f"small training reference: {json.dumps(small_train)}")
    recipe = recipe_phase(torch, np)
    recipe["chunked_loop_at_train_shape"] = chunked
    print(f"recipe: {json.dumps(recipe)}")
    print(f"recipe: {recipe['tokens_per_s']:.1f} tokens/s, step "
          f"{recipe['step_ms']:.1f} ms (forward {recipe['forward_ms']:.1f}, "
          f"backward {recipe['backward_ms']:.1f}, scaler+clip "
          f"{recipe['scaler_clip_ms']:.1f}, optimizer "
          f"{recipe['optimizer_ms']:.1f}), peak "
          f"{recipe['peak_memory_gib']:.2f} GiB on {card}")
    recipe_plain = recipe_vs_plain(torch, np)
    print(f"recipe vs plain: {json.dumps(recipe_plain)}")
    small_recipe = small_recipe_reference(torch, np)
    print(f"small recipe reference: {json.dumps(small_recipe)}")
    drop = gpt2_dropout_phase(torch, np)
    print(f"gpt2_dropout: {json.dumps(drop)}")
    print(f"gpt2_dropout: {drop['tokens_per_s']:.1f} tokens/s (recipe at "
          f"dropout 0: {recipe['tokens_per_s']:.1f}), step "
          f"{drop['step_ms']:.1f} ms (forward {drop['forward_ms']:.1f}, "
          f"backward {drop['backward_ms']:.1f}, scaler+clip "
          f"{drop['scaler_clip_ms']:.1f}, optimizer "
          f"{drop['optimizer_ms']:.1f}), peak "
          f"{drop['peak_memory_gib']:.2f} GiB on {card}")
    drop_plain = gpt2_dropout_vs_plain(torch, np)
    print(f"gpt2_dropout vs plain: {json.dumps(drop_plain)}")
    large, model = gpt3_large_phase(torch, np)
    per_step = large["launches_per_step"]
    large["kernel_share_of_step"] = {
        name: per_step[name] * next(c["ms"] for c in cases
                                    if c["case"] == case) / large["step_ms"]
        for name, cases, case in (
            *((n, c, "train") for n, c in zip(
                _K1_K3, (k1_cases, k2_cases, k3_cases))),
            ("layer_norm", ln_cases, "rows=16384x1536"),
            ("layer_norm_bwd", k8_cases, "rows=16384x1536"))}
    print(f"gpt3_large: {json.dumps(large)}")
    print(f"gpt3_large: {large['tokens_per_s']:.1f} tokens/s, step "
          f"{large['step_ms']:.1f} ms (forward {large['forward_ms']:.1f}, "
          f"backward {large['backward_ms']:.1f}, scaler+clip "
          f"{large['scaler_clip_ms']:.1f}, optimizer "
          f"{large['optimizer_ms']:.1f}), peak "
          f"{large['peak_memory_gib']:.2f} GiB on {card}")
    large_gen = gpt3_large_generate(torch, np, model)
    print(f"gpt3_large generate: {json.dumps(large_gen)}")
    del model
    torch.cuda.empty_cache()
    large_plain = gpt3_large_vs_plain(torch, np)
    print(f"gpt3_large vs plain: {json.dumps(large_plain)}")
    small_d96 = small_d96_reference(torch, np)
    print(f"small d96 reference: {json.dumps(small_d96)}")
    score = bert_score_phase(torch, np)
    print(f"bert_score: {json.dumps(score)}")
    print(f"bert_score: {score['sequences_per_s']:.1f} sequences/s, "
          f"{score['tokens_per_s']:.1f} tokens/s, a scorer call of 96 "
          f"{1e3 * score['wall_s']:.1f} ms "
          f"({score['ms_per_batch_of_32']:.1f} ms a padded batch of 32) "
          f"on {card}")
    mlm = bert_mlm_phase(torch, np)
    for seq, _ in BERT_MLM_SHAPES:
        r = mlm[f"s{seq}"]
        per_step = r["launches_per_step"]
        r["kernel_share_of_step"] = {
            name: per_step[name] * next(
                c["ms"] for c in cases
                if c["case"] == f"bert_rows={r['batch'] * seq}x1024")
            / r["step_ms"]
            for name, cases in (("layer_norm", ln_cases),
                                ("layer_norm_bwd", k8_cases))}
        print(f"bert_large_mlm s{seq}: {json.dumps(r)}")
        print(f"bert_large_mlm s{seq} x {r['batch']}: "
              f"{r['tokens_per_s']:.1f} tokens/s, step {r['step_ms']:.1f} "
              f"ms (forward {r['forward_ms']:.1f}, backward "
              f"{r['backward_ms']:.1f}, optimizer {r['optimizer_ms']:.1f}), "
              f"peak {r['peak_memory_gib']:.2f} GiB on {card}")
    mlm_plain = bert_mlm_vs_plain(torch, np)
    print(f"bert_large_mlm vs plain: {json.dumps(mlm_plain)}")
    ernie = ernie_large_phase(torch, np)
    print(f"ernie_large: {json.dumps(ernie)}")
    print(f"ernie_large: {ernie['tokens_per_s']:.1f} tokens/s, step "
          f"{ernie['step_ms']:.1f} ms (forward {ernie['forward_ms']:.1f}, "
          f"backward {ernie['backward_ms']:.1f}, optimizer "
          f"{ernie['optimizer_ms']:.1f}), peak "
          f"{ernie['peak_memory_gib']:.2f} GiB on {card}")
    vision = resnet50_train_phase(torch, np)
    print(f"resnet50_train: {json.dumps(vision)}")
    print(f"resnet50_train: {vision['images_per_s']:.1f} images/s, step "
          f"{vision['step_ms']:.1f} ms (forward {vision['forward_ms']:.1f}, "
          f"backward {vision['backward_ms']:.1f}, optimizer "
          f"{vision['optimizer_ms']:.1f}), peak "
          f"{vision['peak_memory_gib']:.2f} GiB, model FLOP share "
          f"{100 * vision['model_flop_share']:.1f} % of the dense bf16 peak "
          f"on {card}")
    vision_plain = resnet50_vs_plain(torch, np)
    print(f"resnet50_vs_plain: {json.dumps(vision_plain)}")
    vision_eval = resnet50_eval_phase(torch, np)
    print(f"resnet50_eval: {json.dumps(vision_eval)}")
    print(f"resnet50_eval: {vision_eval['images_per_s']:.1f} images/s "
          f"({vision_eval['ms_per_forward']:.2f} ms a forward of "
          f"{RESNET_BATCH}) on {card}")
    lenet = lenet_phase(torch, np)
    print(f"lenet: {json.dumps(lenet)}")
    api_model, api_batches, api = paddle_api_train_phase(torch, np)
    print(f"paddle_api: {json.dumps(api)}")
    print(f"paddle_api: GPT-2 124M step {api['step_ms']['api']:.1f} ms "
          f"through the API, the plain tensors' {api['step_ms']['plain_before']:.1f} "
          f"ms before it and {api['step_ms']['plain_after']:.1f} ms after "
          f"it, the first loss and a forward the same bits, on {card}")
    ckpt = paddle_api_checkpoint_phase(torch, np, api_model, api_batches)
    del api_model
    torch.cuda.empty_cache()
    print(f"paddle_api checkpoint: {json.dumps(ckpt)}")
    sweep = paddle_api_op_sweep(torch, np)
    print(f"paddle_api op sweep: {json.dumps(sweep)}")
    hapi = hapi_gpt2_phase(torch, np)
    print(f"hapi_gpt2: {json.dumps(hapi)}")
    ms, tps = hapi["step_ms"], hapi["tokens_per_s"]
    gate = hapi["step_gate"]
    print(f"hapi_gpt2: GPT-2 124M step {ms['hapi']:.2f} ms through "
          f"Model.fit ({tps['hapi']:.1f} tokens/s), the hand-written loop's "
          f"{ms['loop_before']:.2f} ms before it and {ms['loop_after']:.2f} "
          f"ms after it; medians {gate['loop_before']:.2f} / "
          f"{gate['hapi']:.2f} / {gate['loop_after']:.2f} ms, within "
          f"{100 * gate['tolerance']:.0f} %: {gate['within']}; syncs a timed "
          f"step {json.dumps(hapi['syncs_per_step'])}; peak "
          f"{hapi['peak_memory_gib']:.2f} GiB on {card}")
    resume = hapi_resume_phase(torch, np)
    print(f"hapi_resume: {json.dumps(resume)}")
    print(f"hapi_resume: checkpoint {resume['checkpoint_bytes_total'] / 2 ** 30:.2f}"
          f" GiB, save {resume['save_s']['mean_s']:.2f} s, restore "
          f"{resume['restore_s']:.2f} s, every state restored bit for bit "
          f"on {card}")
    lenet_fit = hapi_lenet_phase(torch, np)
    print(f"hapi_lenet: {json.dumps(lenet_fit)}")
    print(f"hapi_lenet: {lenet_fit['train_images_per_s']:.1f} images/s "
          f"training, {lenet_fit['eval_images_per_s']:.1f} evaluating, eval "
          f"top-1 {lenet_fit['eval_logs']['acc_top1']:.4f} (at least "
          f"{LENET_MIN_ACC}) on {card}")
    for c in k8_cases:
        c.update(_k8_launches_apart(torch, timer, c.pop("_split")))
    print("K8's launches apart (torch.profiler, device ms): " + json.dumps(
        {c["case"]: [c["row_kernel_ms"], c["reduce_ms"]] for c in k8_cases}))

    def entry(name, source, replaces, cases, main_case, launches):
        top = next(c for c in cases if c["case"] == main_case)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"], "main_case": main_case,
                "cases": cases}

    def paths(name):
        return {"serving": serve["launches"][name],
                "training": train["launches"][name],
                "recipe": recipe["launches"][name],
                "gpt2_dropout": drop["launches"][name],
                "gpt3_large": large["launches"][name],
                "gpt3_large_generate": large_gen["launches"][name],
                "bert_score": score["launches"][name],
                "bert_large_mlm": mlm["launches"][name],
                "ernie_large": ernie["launches"][name],
                "resnet50_train": vision["launches"][name],
                "resnet50_eval": vision_eval["launches"][name],
                "lenet": lenet["launches"][name],
                "paddle_api": api["launches"][name],
                "hapi_gpt2": hapi["launches"][name],
                "hapi_resume": resume["launches"][name],
                "hapi_lenet": lenet_fit["launches"][name]}

    vision_paths = ("resnet50_train", "resnet50_eval", "lenet", "hapi_lenet")

    def only(name, *keys):
        # the vision paths launch none of K1-K11: every entry says so
        return {k: v for k, v in paths(name).items()
                if k in keys + vision_paths}

    packed = "paddle_tpu_torch/csrc/flash_attention_packed.cu"
    flash = "paddle_tpu_torch/csrc/flash_attention.cu"
    ln_src = "paddle_tpu_torch/csrc/layer_norm.cu"
    ce_src = "paddle_tpu_torch/csrc/fused_ce.cu"
    k1_paths = ("gpt3_large",)
    kernels = [
        entry("flash_attention_fwd", flash,
              "paddle_tpu/ops/pallas/flash_attention.py:127", k1_cases,
              "train", only("flash_attention_fwd", *k1_paths)),
        entry("flash_attention_bwd_dq",
              "paddle_tpu_torch/csrc/flash_attention_dq.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:173", k2_cases,
              "train", only("flash_attention_bwd_dq", *k1_paths)),
        entry("flash_attention_bwd_dkv",
              "paddle_tpu_torch/csrc/flash_attention_dkv.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:218", k3_cases,
              "train", only("flash_attention_bwd_dkv", *k1_paths)),
        entry("flash_attention_cached",
              "paddle_tpu_torch/csrc/flash_attention_cached.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:547", fa_cases,
              "decode", only("flash_attention_cached", "serving",
                             "gpt3_large_generate")),
        entry("flash_attention_packed_fwd", flash,
              "paddle_tpu/ops/pallas/flash_attention_packed.py:127", k5_cases,
              "train", only("flash_attention_packed_fwd", "serving",
                            "training", "recipe", "gpt2_dropout",
                            "paddle_api", "hapi_gpt2", "hapi_resume")),
        entry("flash_attention_packed_bwd", packed,
              "paddle_tpu/ops/pallas/flash_attention_packed.py:236", k6_cases,
              "train", only("flash_attention_packed_bwd", "serving",
                            "training", "recipe", "gpt2_dropout",
                            "paddle_api", "hapi_gpt2", "hapi_resume")),
        entry("layer_norm", ln_src, "paddle_tpu/ops/pallas/layer_norm.py:34",
              ln_cases, "rows=8", paths("layer_norm")),
        entry("layer_norm_bwd", ln_src,
              "paddle_tpu/ops/pallas/layer_norm.py:41", k8_cases,
              "rows=24576", paths("layer_norm_bwd")),
        entry("fused_ce_fwd", ce_src, "paddle_tpu/ops/pallas/fused_ce.py:71",
              k9_cases, "train", only("fused_ce_fwd", "recipe",
                                       "gpt2_dropout", "ernie_large")),
        entry("fused_ce_dx", ce_src, "paddle_tpu/ops/pallas/fused_ce.py:107",
              k10_cases, "train", only("fused_ce_dx", "recipe",
                                       "gpt2_dropout", "ernie_large")),
        entry("fused_ce_dw", ce_src, "paddle_tpu/ops/pallas/fused_ce.py:128",
              k11_cases, "train", only("fused_ce_dw", "recipe",
                                       "gpt2_dropout", "ernie_large")),
    ]
    # K1-K3's routes by input type (up to head dim 128; FMA above), their
    # bf16 SASS's tensor-core instructions (one function a head dim and
    # dropout switch) and ptxas's registers and spills; K5 runs K1's
    # forward on its packed strides
    from paddle_tpu_torch.ops.cuda import flash_attention as k1

    routes = {n: k1.kernel_route(t) for n, t in (
        ("bf16", torch.bfloat16), ("fp16", torch.float16),
        ("fp32", torch.float32))}
    for k, kern, wide in ((kernels[0], "fwd_tc_kernel", "fwd_wide_kernel"),
                          (kernels[1], "dq_tc_kernel", "dq_wide_kernel"),
                          (kernels[2], "dkv_tc_kernel", "dkv_wide_kernel")):
        k["kernel_route"] = routes
        k["hmma_bf16"] = {n: c for n, c in hmma.items() if kern in n}
        k["ptxas_bf16"] = {n: r for n, r in ptxas.items()
                           if kern in n or wide in n}
    # K4: its routes, the bf16 prefill's HMMA counts, every K4 function's
    # registers and spills; the key parts of its split-key cases are in
    # their cases
    kernels[3]["kernel_route"] = {
        "sq > 8, bf16/fp16, head dim <= 128": "mma.sync (cached_tc_kernel)",
        "sq <= 8, head dim <= 256": "split (cached_split_kernel, "
                                    "cached_merge_kernel)",
        "fp32 at sq > 8, head dim 129-256 at sq > 8, above 256": "fma "
                                                                 "(cached_fwd_kernel)"}
    kernels[3]["hmma_bf16"] = {n: c for n, c in hmma.items()
                               if "cached_tc_kernel" in n}
    kernels[3]["ptxas_bf16"] = {n: r for n, r in ptxas.items()
                                if "cached_" in n}
    kernels[3]["parts_at_decode"] = {
        c["case"]: [c["parts_live"], c["parts_launched"]]
        for c in kernels[3]["cases"] if "parts_live" in c}
    # K6: its routes, HMMA counts and registers, and the K2 + K3 witness
    kernels[5]["kernel_route"] = {
        "bf16": "mma.sync (packed_bwd_tc_kernel)",
        "fp16": "mma.sync (packed_bwd_tc_kernel)",
        "fp32": "fma (packed_bwd_kernel)"}
    kernels[5]["hmma_bf16"] = {n: c for n, c in hmma.items()
                               if "packed_bwd_tc_kernel" in n}
    kernels[5]["ptxas_bf16"] = {n: r for n, r in ptxas.items()
                                if "packed_bwd_tc_kernel" in n}
    kernels[5]["witness_k2_k3"] = next(
        c["witness_k2_k3"] for c in k6_cases if "witness_k2_k3" in c)
    kernels[4]["kernel_route"] = routes
    # K7/K8: the library's kernel for each width (cases' kernel_plan) and
    # the registers and spills of the instantiations on the paths
    kernels[6]["ptxas_bf16"] = {n: r for n, r in ptxas_ln.items()
                                if "ln_fwd" in n}
    kernels[7]["ptxas_bf16"] = {n: r for n, r in ptxas_ln.items()
                                if "ln_bwd" in n}
    for k in kernels[6:8]:
        k["kernel_route"] = {c["case"]: c["kernel_plan"]["kernel"]
                             for c in k["cases"]}
    kernels[4]["runs"] = ("K1's fwd_tc_kernel (bf16, fp16) or fwd_kernel "
                          "(fp32), csrc/flash_attention.cu")
    # with in-kernel dropout (p = 0.1): time, dropout-0 time on the same
    # inputs, error against the plain version on the same seed, and the
    # launches with dropout on the gpt2_dropout path (K5/K6)
    for k in kernels:
        c = dropout_cases.get(k["name"])
        if c is not None:
            k["dropout"] = dict(c, bound_ms=k["bound_ms"],
                                bound_by=k["bound_by"],
                                launches=drop["dropout_launches"][k["name"]])
    kernels[4]["dropout"]["philox"] = philox_check
    # K9: the library's plan for each case, the bf16 wgmma kernel's HGMMA
    # count, every K9 instantiation's registers and spills, the cuBLAS
    # product and the chunked loop's forward at the train and large shapes
    k9_entry = kernels[-3]
    k9_entry["kernel_route"] = {c["case"]: c["kernel_plan"]["kernel"]
                                for c in k9_entry["cases"]}
    k9_entry["hgmma_bf16"] = {n: c for n, c in hmma.items()
                              if "ce_fwd_wgmma_kernel" in n}
    k9_entry["ptxas"] = ptxas_k9
    k9_entry["cublas_product_ms"] = {
        c["case"]: c["cublas_product_ms"] for c in k9_entry["cases"]
        if "cublas_product_ms" in c}
    k9_entry["chunked_loop_fwd_ms"] = {
        c["case"]: c["chunked_loop_fwd_ms"] for c in k9_entry["cases"]
        if "chunked_loop_fwd_ms" in c}
    # K10/K11: the library's plan for each case, the bf16 cluster
    # instantiations' HGMMA counts and registers and spills
    for k in kernels[-2:]:
        k["kernel_route"] = {c["case"]: c["kernel_plan"]["kernel"]
                             for c in k["cases"]}
        k["hgmma_bf16"] = {n: c for n, c in hmma.items()
                           if "ce_bwd_cluster_kernel" in n}
        k["ptxas_bf16"] = {n: r for n, r in ptxas.items()
                           if "ce_bwd_cluster_kernel" in n}
    # the loop the flag replaces (cuBLAS products), at the train shape
    kernels[-3]["chunked_loop_ms"] = chunked["forward_ms"]
    kernels[-2]["chunked_loop_ms"] = chunked["backward_ms"]
    kernels[-1]["chunked_loop_ms"] = chunked["backward_ms"]
    for k in kernels:
        _require(k["launches"] > 0, f"kernel {k['name']} launched on its path")
    # every process a phase started has ended: the DataLoader's workers,
    # their forkserver and multiprocessing's resource tracker are stopped
    # and waited for (the library also does this at exit)
    from paddle_tpu_torch.io.worker import shutdown_workers

    shutdown_workers()
    left = _descendants()
    _require(not left, f"no process left running at the end (pids {left})")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
          f"{build_s:.1f} s of it")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
