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
   largest reference value for bf16, 5e-5 absolute for fp32. Beside them,
   the chunked loop the flag replaces, forward and backward ms and peak
   memory.
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
   K4-prefill and K6 tensor-core function, and ptxas's registers and
   spills of the bf16 attention kernels are printed.
   K7 and K8 at GPT-3 Large's LayerNorm shape (16384 rows of 1536, bf16 x,
   fp32 gamma and beta) within one bf16 step, beside ``F.layer_norm`` and
   ``native_layer_norm_backward``.
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
12. Prints the ``kernels`` JSON line (K1-K11; K1-K6 with their routes,
    K1-K4 and K6 with their bf16 HMMA counts and ptxas registers and
    spills, K4 with its key parts at decode, K6 with the K2 + K3 witness,
    K1-K3 and K5/K6 with a ``dropout`` entry), then the result line last.

Any failure raises and exits non-zero; nothing is printed as a result then.
"""
from __future__ import annotations

import contextlib
import json
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
            "bound_ms": bound, "bound_by": by})

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


def _layer_norm_train_cases(torch, timer, gen, rows, feat, name):
    """K7 and K8 against their plain versions at a train step's shape (bf16
    x and dy, fp32 gamma and beta), beside ``F.layer_norm`` and
    ``native_layer_norm_backward`` on bf16 copies of gamma and beta."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.cuda import layer_norm as k7

    x = (torch.randn(rows, feat, generator=gen) * 2).to("cuda", torch.bfloat16)
    g = (1 + 0.1 * torch.randn(feat, generator=gen)).to("cuda")
    bt = (0.1 * torch.randn(feat, generator=gen)).to("cuda")
    dy = torch.randn(rows, feat, generator=gen).to("cuda", torch.bfloat16)
    gl, bl = g.to(x.dtype), bt.to(x.dtype)
    err = _bf16_err(k7.layer_norm(x, g, bt), k7.layer_norm_plain(x, g, bt))
    bound, by = _bound(rows * feat * 2 * 2 + 2 * feat * 4, rows * feat * 8,
                       H100_FP32_FLOPS)
    fwd = {
        "case": name, "shape": [rows, feat], "max_abs_err": err,
        "ms": timer(lambda: k7.layer_norm(x, g, bt)),
        "plain_ms": timer(lambda: k7.layer_norm_plain(x, g, bt)),
        "library_ms": timer(lambda: TF.layer_norm(x, (feat,), gl, bl)),
        "bound_ms": bound, "bound_by": by}
    got = k7.layer_norm_bwd(x, g, dy)
    want = k7.layer_norm_bwd_plain(x, g, dy)
    err = max(_bf16_err(a, w) for a, w in zip(got, want))
    # x and dy read, dx written, gamma read, dgamma and dbeta written
    bound, by = _bound(rows * feat * 2 * 3 + 3 * feat * 4, rows * feat * 20,
                       H100_FP32_FLOPS)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [feat], gl, bl, 1e-5)
    bwd = {
        "case": name, "shape": [rows, feat], "max_abs_err": err,
        "ms": timer(lambda: k7.layer_norm_bwd(x, g, dy)),
        "plain_ms": timer(lambda: k7.layer_norm_bwd_plain(x, g, dy)),
        "library_ms": timer(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [feat], mean, rstd, gl, bl, [True, True, True])),
        "bound_ms": bound, "bound_by": by}
    return fwd, bwd


def training_kernel_phase(torch, timer):
    """K5, K6 and K8 (and K7 at the training shapes) against their plain
    versions at GPT-2 124M's train-step shapes (batch 24 x 1024: 24576
    rows, 12 heads of 64), bf16, plus one small packed-attention case with
    sq > sk and a bias that masks a row (zero output and gradients); K7
    and K8 also at GPT-3 Large's (16384 rows of 1536)."""
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
    # 1536): 49 launches each a step on its path
    for rows, feat, name in ((24 * 1024, 768, "rows=24576"),
                             (8 * 2048, 1536, "rows=16384x1536")):
        f, b = _layer_norm_train_cases(torch, timer, gen, rows, feat, name)
        ln_fwd.append(f)
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


def fused_ce_kernel_phase(torch, timer):
    """K9, K10 and K11 against their plain versions at the train step's
    shape (24576 tokens, hidden 768, vocab 50304, bf16, no bias) and at an
    odd shape (300 tokens, vocab 1000, hidden 128, bias, two ignored
    labels, bf16 and fp32); plus the chunked loop the flag replaces
    (``ops/fused.py::_FusedLinearCE``, cuBLAS products) at the train shape:
    forward and backward ms and peak memory."""
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.ops.cuda import fused_ce as k9

    gen = torch.Generator(device="cpu").manual_seed(2)
    fwd, dx_cases, dw_cases = [], [], []
    chunked = None
    # GPT-3 Large's loss shape (batch 8 x 2048 tokens, hidden 1536): the
    # hidden width streamed through shared memory; and fp16 operands
    for name, n, h, v, dt, use_bias in (
            ("train", 24576, 768, 50304, "bf16", False),
            ("large", 16384, 1536, 50304, "bf16", False),
            ("odd", 300, 128, 1000, "bf16", True),
            ("odd_fp16", 300, 128, 1000, "fp16", True),
            ("odd_fp32", 300, 128, 1000, "fp32", True)):
        tdt = {"bf16": torch.bfloat16, "fp16": torch.float16,
               "fp32": torch.float32}[dt]
        x = torch.randn(n, h, generator=gen).to("cuda", tdt)
        w = (0.02 * torch.randn(v, h, generator=gen)).to("cuda", tdt)
        b = ((0.1 * torch.randn(v, generator=gen)).cuda() if use_bias
             else None)
        y = torch.randint(0, v, (n,), generator=gen).cuda()
        g = torch.full((n,), 1.0 / n, device="cuda")
        if use_bias:
            g[[5, 17]] = 0.0              # ignored labels carry g = 0
        esz = 4 if dt == "fp32" else 2
        # fp16 has the bf16 tensor-core peak (H100 data sheet)
        peak = H100_FP32_FLOPS if dt == "fp32" else H100_BF16_FLOPS
        io_b = (n + v) * h * esz + n * 4 + (v * 4 if use_bias else 0)
        loss, lse = k9.ce_forward(x, w, b, y)
        want = k9.ce_forward_plain(x, w, b, y)
        err = max(_max_rel_err(a, c, dt) for a, c in zip((loss, lse), want))
        bound, by = _bound(io_b + 2 * n * 4, 2 * n * v * h, peak)
        shape = {"tokens": n, "hidden": h, "vocab": v, "dtype": dt,
                 "bias": use_bias}
        fwd.append({
            "case": name, "shape": shape, "max_abs_err": err,
            "ms": timer(lambda: k9.ce_forward(x, w, b, y)),
            "plain_ms": timer(lambda: k9.ce_forward_plain(x, w, b, y), 5),
            "library_ms": None, "bound_ms": bound, "bound_by": by})
        args = (x, w, b, y, g, lse)
        err = _max_rel_err(k9.ce_backward_dx(*args),
                           k9.ce_backward_dx_plain(*args), dt)
        # x, w, labels, g, lse read; dx written; the logits recomputed
        bound, by = _bound(io_b + 2 * n * 4 + n * h * esz, 4 * n * v * h,
                           peak)
        dx_cases.append({
            "case": name, "shape": shape, "max_abs_err": err,
            "ms": timer(lambda: k9.ce_backward_dx(*args)),
            "plain_ms": timer(lambda: k9.ce_backward_dx_plain(*args), 5),
            "library_ms": None, "bound_ms": bound, "bound_by": by})
        dw, db = k9.ce_backward_dw(*args)
        want_dw, want_db = k9.ce_backward_dw_plain(*args)
        err = _max_rel_err(dw, want_dw, dt)
        if use_bias:
            err = max(err, _max_rel_err(db, want_db, dt))
        bound, by = _bound(io_b + 2 * n * 4 + v * h * esz
                           + (v * 4 if use_bias else 0), 4 * n * v * h, peak)
        dw_cases.append({
            "case": name, "shape": shape, "max_abs_err": err,
            "ms": timer(lambda: k9.ce_backward_dw(*args)),
            "plain_ms": timer(lambda: k9.ce_backward_dw_plain(*args), 5),
            "library_ms": None, "bound_ms": bound, "bound_by": by})
        if name == "train":
            chunked = _chunked_loop(torch, timer, fused, x, w, y)
        del x, w, b, y, g, loss, lse, args, dw, db, want, want_dw, want_db
        torch.cuda.empty_cache()
    return fwd, dx_cases, dw_cases, chunked


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


#: the tensor-core kernels whose SASS must hold HMMA instructions: K1
#: (which also runs K5), K2, K3, K4's prefill, K6
_TC_KERNELS = ("fwd_tc_kernel", "dq_tc_kernel", "dkv_tc_kernel",
               "cached_tc_kernel", "packed_bwd_tc_kernel")


def _tc_instantiations():
    """``{kernel: bf16 instantiations}``: K1-K3 one a tensor-core width
    (16..128) and dropout switch, K4's prefill one a width, K6 one a packed
    head dim and dropout switch."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as k1
    from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5

    widths = sum(1 for w in k1.FLASH_WIDTHS
                 if k1.kernel_route(torch.bfloat16, w) == "mma.sync")
    return {"fwd_tc_kernel": 2 * widths, "dq_tc_kernel": 2 * widths,
            "dkv_tc_kernel": 2 * widths, "cached_tc_kernel": widths,
            "packed_bwd_tc_kernel": 2 * len(k5.HEAD_DIMS)}


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
        elif cur is not None and ("HMMA" in line or "HGMMA" in line):
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


def ptxas_report(log):
    """``{kernel<type,widths,switches>: [registers, spill store bytes]}``
    of the bf16 instantiations of the attention kernels, from the build's
    ``-Xptxas -v`` report."""
    import re

    out, cur, spill = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kern = next((k for k in _PTXAS_KERNELS if k in name), None)
            cur = None
            if kern is not None and "bfloat16" in name:
                args = name.split(kern, 1)[1]
                ints = re.findall(r"Li(\d+)E", args)
                flags = re.findall(r"Lb([01])E", args)
                cur = f"{kern}<bf16,{','.join(ints + flags)}>"
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
    print(f"tensor-core SASS (HMMA/HGMMA a bf16 K1/K2/K3/K4/K6 function): "
          f"{json.dumps(hmma)}")
    ptxas = ptxas_report(build_info().get("log", ""))
    print(f"ptxas [registers, spill bytes] of the bf16 attention kernels: "
          f"{json.dumps(ptxas)}")
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
                 f" [{c['route']}]" if "route" in c else "")
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
                "gpt3_large_generate": large_gen["launches"][name]}

    def only(name, *keys):
        return {k: v for k, v in paths(name).items() if k in keys}

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
                            "training", "recipe", "gpt2_dropout")),
        entry("flash_attention_packed_bwd", packed,
              "paddle_tpu/ops/pallas/flash_attention_packed.py:236", k6_cases,
              "train", only("flash_attention_packed_bwd", "serving",
                            "training", "recipe", "gpt2_dropout")),
        entry("layer_norm", ln_src, "paddle_tpu/ops/pallas/layer_norm.py:34",
              ln_cases, "rows=8", paths("layer_norm")),
        entry("layer_norm_bwd", ln_src,
              "paddle_tpu/ops/pallas/layer_norm.py:41", k8_cases,
              "rows=24576", paths("layer_norm_bwd")),
        entry("fused_ce_fwd", ce_src, "paddle_tpu/ops/pallas/fused_ce.py:71",
              k9_cases, "train", only("fused_ce_fwd", "recipe",
                                       "gpt2_dropout")),
        entry("fused_ce_dx", ce_src, "paddle_tpu/ops/pallas/fused_ce.py:107",
              k10_cases, "train", only("fused_ce_dx", "recipe",
                                       "gpt2_dropout")),
        entry("fused_ce_dw", ce_src, "paddle_tpu/ops/pallas/fused_ce.py:128",
              k11_cases, "train", only("fused_ce_dw", "recipe",
                                       "gpt2_dropout")),
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
    # the loop the flag replaces (cuBLAS products), at the train shape
    kernels[-3]["chunked_loop_ms"] = chunked["forward_ms"]
    kernels[-2]["chunked_loop_ms"] = chunked["backward_ms"]
    kernels[-1]["chunked_loop_ms"] = chunked["backward_ms"]
    for k in kernels:
        _require(k["launches"] > 0, f"kernel {k['name']} launched on its path")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
          f"{build_s:.1f} s of it")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
