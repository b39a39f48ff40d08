#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Requires CUDA (exits non-zero without a card) and prints the card's name
   and power limit as ``nvidia-smi`` reports them.
2. Builds the kernels from ``paddle_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` (timed).
3. Kernel phase: every kernel of the serving and training paths against its
   plain PyTorch version at the shapes GPT-2 124M gives it (serving: K4,
   K7; training at batch 24 x 1024: K5, K6, K7, K8; K9-K11 in 6), in bf16, with the
   kernel's, the plain version's and one library call's time (CUDA events,
   L2 flushed before every launch) beside the kernel's bound.
   Tolerance: kernel and plain version compute in fp32 and round once to
   bf16, so they agree to one bf16 step, |Δ| <= 2^-7 · max(1, |ref|) (K6's
   dq is summed with atomics, K8's dgamma/dbeta over 24576 rows, both in
   fp32: orders that differ far below a bf16 step).
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
8. Prints the ``kernels`` JSON line (K4-K11), then the result line last.

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


def _bf16_err(got, want):
    g, w = got.float(), want.float()
    _require(bool(g.isfinite().all()), "kernel output is finite")
    err = (g - w).abs()
    _require(bool((err <= BF16_STEP * w.abs().clamp_min(1.0)).all()),
             f"kernel within one bf16 step of its plain version "
             f"(max err {err.max().item():.3g})")
    return float(err.max())


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
    for name, (q, k, v, qp, kl) in cases.items():
        qp = qp.to(dev)
        kl = None if kl is None else kl.to(dev)
        b, sq, _, _ = q.shape
        sk = k.shape[1]
        err = _bf16_err(k4.flash_attention_cached(q, k, v, qp, kl),
                        k4.flash_attention_cached_plain(q, k, v, qp, kl))
        col = torch.arange(sk, device=dev)
        ok = col[None, None, :] <= qp[:, :, None]
        if kl is not None:
            ok = ok & (col[None, None, :] < kl[:, None, None])
        pairs = int(ok.sum()) * h
        # K/V rows this data needs: each slot's prefix up to its last
        # visible key
        vis = ok.any(1)                                       # [b, sk]
        keys = int((torch.where(vis, col, -1).amax(-1) + 1).sum())
        nbytes = (2 * q.numel() * 2 + 2 * keys * h * d * 2
                  + qp.numel() * 4 + (0 if kl is None else kl.numel() * 4))
        bound, by = _bound(nbytes, 4 * d * pairs, H100_BF16_FLOPS)
        mask = ok[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fa_cases.append({
            "case": name, "shape": {"q": list(q.shape), "kv": list(k.shape)},
            "max_abs_err": err,
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


def training_kernel_phase(torch, timer):
    """K5, K6 and K8 (and K7 at the training shape) against their plain
    versions at GPT-2 124M's train-step shapes (batch 24 x 1024: 24576
    rows, 12 heads of 64), bf16, plus one small packed-attention case with
    sq > sk and a bias that masks a row (zero output and gradients)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5
    from paddle_tpu_torch.ops.cuda import layer_norm as k7

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
        dout = torch.randn(b, sq, h * d, generator=gen).to("cuda",
                                                            torch.bfloat16)
        grads = k5.flash_attention_packed_bwd(q, k, v, out, lse, dout, h,
                                              bias, True)
        want = k5.flash_attention_packed_bwd_plain(q, k, v, out, lse, dout, h,
                                                   bias, True)
        berr = max(_bf16_err(g, w) for g, w in zip(grads, want))
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
        fwd_cases.append({
            "case": name, "shape": shape, "max_abs_err": err,
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
        bwd_cases.append({
            "case": name, "shape": shape, "max_abs_err": berr,
            "ms": timer(lambda: k5.flash_attention_packed_bwd(
                q, k, v, out, lse, dout, h, bias, True)),
            "plain_ms": timer(lambda: k5.flash_attention_packed_bwd_plain(
                q, k, v, out, lse, dout, h, bias, True)),
            "library_ms": timer(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), gl, retain_graph=True)),
            "bound_ms": bb_, "bound_by": bby})
        del ql, kl, vl, lib_out

    rows, feat = 24 * 1024, 768
    x = (torch.randn(rows, feat, generator=gen) * 2).to("cuda", torch.bfloat16)
    g = (1 + 0.1 * torch.randn(feat, generator=gen)).to("cuda")
    bt = (0.1 * torch.randn(feat, generator=gen)).to("cuda")
    dy = torch.randn(rows, feat, generator=gen).to("cuda", torch.bfloat16)
    gl, bl = g.to(x.dtype), bt.to(x.dtype)
    err = _bf16_err(k7.layer_norm(x, g, bt), k7.layer_norm_plain(x, g, bt))
    bound, by = _bound(rows * feat * 2 * 2 + 2 * feat * 4, rows * feat * 8,
                       H100_FP32_FLOPS)
    ln_fwd.append({
        "case": f"rows={rows}", "shape": [rows, feat], "max_abs_err": err,
        "ms": timer(lambda: k7.layer_norm(x, g, bt)),
        "plain_ms": timer(lambda: k7.layer_norm_plain(x, g, bt)),
        "library_ms": timer(lambda: TF.layer_norm(x, (feat,), gl, bl)),
        "bound_ms": bound, "bound_by": by})
    got = k7.layer_norm_bwd(x, g, dy)
    want = k7.layer_norm_bwd_plain(x, g, dy)
    err = max(_bf16_err(a, w) for a, w in zip(got, want))
    # x and dy read, dx written, gamma read, dgamma and dbeta written
    bound, by = _bound(rows * feat * 2 * 3 + 3 * feat * 4, rows * feat * 20,
                       H100_FP32_FLOPS)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [feat], gl, bl, 1e-5)
    ln_bwd.append({
        "case": f"rows={rows}", "shape": [rows, feat], "max_abs_err": err,
        "ms": timer(lambda: k7.layer_norm_bwd(x, g, dy)),
        "plain_ms": timer(lambda: k7.layer_norm_bwd_plain(x, g, dy)),
        "library_ms": timer(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [feat], mean, rstd, gl, bl, [True, True, True])),
        "bound_ms": bound, "bound_by": by})
    return fwd_cases, bwd_cases, ln_fwd, ln_bwd


def _max_rel_err(got, want, dtype):
    """K9-K11 against their plain versions: one bf16 step of the largest
    reference value for bf16 operands (their tile products are exact
    products summed in fp32 in another order, and bf16 outputs round once),
    5e-5 absolute for fp32 ones."""
    g, w = got.float(), want.float()
    _require(bool(g.isfinite().all()), "kernel output is finite")
    err = float((g - w).abs().max())
    tol = BF16_STEP * float(w.abs().max()) if dtype == "bf16" else 5e-5
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
    for name, n, h, v, dt, use_bias in (
            ("train", 24576, 768, 50304, "bf16", False),
            ("odd", 300, 128, 1000, "bf16", True),
            ("odd_fp32", 300, 128, 1000, "fp32", True)):
        tdt = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn(n, h, generator=gen).to("cuda", tdt)
        w = (0.02 * torch.randn(v, h, generator=gen)).to("cuda", tdt)
        b = ((0.1 * torch.randn(v, generator=gen)).cuda() if use_bias
             else None)
        y = torch.randint(0, v, (n,), generator=gen).cuda()
        g = torch.full((n,), 1.0 / n, device="cuda")
        if use_bias:
            g[[5, 17]] = 0.0              # ignored labels carry g = 0
        esz = 2 if dt == "bf16" else 4
        peak = H100_BF16_FLOPS if dt == "bf16" else H100_FP32_FLOPS
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

    saved = (k4.flash_attention_cached, k5.flash_attention_packed,
             k7.layer_norm, k9.ce_forward, k9.ce_backward_dx,
             k9.ce_backward_dw)
    k4.flash_attention_cached = k4.flash_attention_cached_plain
    k5.flash_attention_packed = k5.flash_attention_packed_plain
    k7.layer_norm = k7.layer_norm_plain
    # the flash-CE autograd function calls these by their module names
    k9.ce_forward = k9.ce_forward_plain
    k9.ce_backward_dx = k9.ce_backward_dx_plain
    k9.ce_backward_dw = k9.ce_backward_dw_plain
    try:
        yield
    finally:
        (k4.flash_attention_cached, k5.flash_attention_packed,
         k7.layer_norm, k9.ce_forward, k9.ce_backward_dx,
         k9.ce_backward_dw) = saved


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
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(warm + timed):
        a = rng.randint(0, model.cfg.vocab_size, (batch, seq)).astype(np.int64)
        batches.append((a, a.copy()))
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
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(3):
        a = rng.randint(0, 50304, (8, 1024)).astype(np.int64)
        batches.append((a, a.copy()))
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
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(3):
        a = rng.randint(0, cfg.vocab_size, (2, 1024)).astype(np.int64)
        batches.append((a, a.copy()))
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


def _recipe_train(torch, model, batches, decorate=True, events=None):
    """GPT-3 Small's recipe (Brown et al. 2020, Table 2.1 and Appendix B)
    over ``batches`` fed through ``DeviceLoader``, with
    ``FLAGS_enable_flash_ce``: ``amp.decorate(O2, bf16)`` after the model
    is built in fp32, AdamW(0.9, 0.95, 1e-8, weight decay 0.1 except biases
    and LayerNorms), a 5-step linear warm-up into a cosine decay from 6e-4
    to 6e-5 (``sched.step()`` after each step), global-norm clipping at 1.0
    and a dynamic GradScaler from 2^15. Returns the loss tensors and the
    scaler. ``events`` (a list) gets five CUDA events a step: start, after
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
        lr.CosineAnnealingDecay(6e-4, T_max=8, eta_min=6e-5),
        warmup_steps=5, start_lr=0.0, end_lr=6e-4)
    clip = TimedClip(1.0)
    opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-8,
                weight_decay=0.1, parameters=model.parameters(),
                apply_decay_param_fun=decay.__contains__, grad_clip=clip)
    if decorate:
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    model.train()
    losses = []
    with _port_flags(enable_flash_ce=True):
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
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(steps):
        a = rng.randint(0, model.cfg.vocab_size, (batch, seq)).astype(np.int64)
        batches.append((a, a.copy()))
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
    rng = np.random.RandomState(6)
    batches = []
    for _ in range(3):
        a = rng.randint(0, 50304, (8, 1024)).astype(np.int64)
        batches.append((a, a.copy()))
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
    rng = np.random.RandomState(8)
    batches = []
    for _ in range(3):
        a = rng.randint(0, cfg.vocab_size, (2, 1024)).astype(np.int64)
        batches.append((a, a.copy()))
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


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = _card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from paddle_tpu_torch.ops.cuda import build_info, library

    t0 = time.perf_counter()
    library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build_info()['seconds']:.1f} s)")
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
    for c in (ln_cases + fa_cases + k5_cases + k6_cases + k8_cases
              + k9_cases + k10_cases + k11_cases):
        lib = ("none" if c["library_ms"] is None
               else f"{c['library_ms']:.4f}")
        print(f"kernel {c['case']}: {c['ms']:.4f} ms (plain "
              f"{c['plain_ms']:.4f}, library {lib}, bound "
              f"{c['bound_ms']:.4f} by {c['bound_by']}) err "
              f"{c['max_abs_err']:.3g}")
    print(f"chunked loss loop at the train shape: {json.dumps(chunked)}")
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
                "recipe": recipe["launches"][name]}

    packed = "paddle_tpu_torch/csrc/flash_attention_packed.cu"
    ln_src = "paddle_tpu_torch/csrc/layer_norm.cu"
    ce_src = "paddle_tpu_torch/csrc/fused_ce.cu"
    kernels = [
        entry("flash_attention_cached",
              "paddle_tpu_torch/csrc/flash_attention_cached.cu",
              "paddle_tpu/ops/pallas/flash_attention.py:547", fa_cases,
              "decode", {"serving": serve["launches"]["flash_attention_cached"]}),
        entry("flash_attention_packed_fwd", packed,
              "paddle_tpu/ops/pallas/flash_attention_packed.py:127", k5_cases,
              "train", paths("flash_attention_packed_fwd")),
        entry("flash_attention_packed_bwd", packed,
              "paddle_tpu/ops/pallas/flash_attention_packed.py:236", k6_cases,
              "train", paths("flash_attention_packed_bwd")),
        entry("layer_norm", ln_src, "paddle_tpu/ops/pallas/layer_norm.py:34",
              ln_cases, "rows=8", paths("layer_norm")),
        entry("layer_norm_bwd", ln_src,
              "paddle_tpu/ops/pallas/layer_norm.py:41", k8_cases,
              "rows=24576", paths("layer_norm_bwd")),
        entry("fused_ce_fwd", ce_src, "paddle_tpu/ops/pallas/fused_ce.py:71",
              k9_cases, "train", {"recipe": recipe["launches"]["fused_ce_fwd"]}),
        entry("fused_ce_dx", ce_src, "paddle_tpu/ops/pallas/fused_ce.py:107",
              k10_cases, "train", {"recipe": recipe["launches"]["fused_ce_dx"]}),
        entry("fused_ce_dw", ce_src, "paddle_tpu/ops/pallas/fused_ce.py:128",
              k11_cases, "train", {"recipe": recipe["launches"]["fused_ce_dw"]}),
    ]
    # the loop the flag replaces (cuBLAS products), at the train shape
    kernels[-3]["chunked_loop_ms"] = chunked["forward_ms"]
    kernels[-2]["chunked_loop_ms"] = chunked["backward_ms"]
    kernels[-1]["chunked_loop_ms"] = chunked["backward_ms"]
    for k in kernels:
        _require(k["launches"] > 0, f"kernel {k['name']} launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
