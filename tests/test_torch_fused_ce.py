"""The port's ``fused_linear_cross_entropy`` against the JAX package's, on the
CPU, fp32: value and gradients (hidden, weight, bias), ``ignore_index``,
the three reductions, and token counts that are not a multiple of the
chunk. The JAX side runs both of its routes: the chunked scan
(``_FORCE_PALLAS = False``, its default on hardware) and the Pallas
flash-CE kernels K9–K11 in interpret mode (its default there); the port
always runs its chunked loop.

Tolerance: values to 1e-5 relative, gradients to 2e-5 absolute
(``tests/test_fused_ce.py``'s: the same fp32 arithmetic in another order).

The flash-CE route (``FLAGS_enable_flash_ce``): the plain versions of K9-K11
against the Pallas kernels in interpret mode at tokens 300, hidden 128,
vocab 1000 (padded on the TPU side in both tokens and vocab), with and
without bias, two labels ignored, at ``tests/test_fused_ce_pallas.py``'s
tolerances (loss 1e-5; dh, dw, db 1e-4 of the largest); and the port's
``fused_linear_cross_entropy`` under the flag against JAX's ``_flce``
under ``interpret_mode()``. At bf16 the plain K9-K11 are held to the Pallas
kernels in interpret mode at hidden 128, 384 and 1152 within one bf16 step
(2^-7) of the largest value: both round dl to bf16 before the products and
round dx and dw once (measured: at most 2.4e-3 of it).

``kernel_plan`` (the Python copy of the library's ``ptt_fused_ce_plan``)
names K10/K11's route: the cluster kernel at bf16/fp16 where the hidden
width splits into slices of 384, 256 or 128 over at most 8 CTAs, the
streamed kernel where it does not, and FMA kernels at fp32; and K9's
(mode 2): the wgmma kernel at bf16/fp16 for every width, its vocab ranges
and persistent CTAs on an H100's 132 SMs, FMA kernels at fp32.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.ops import fused as jax_fused
from paddle_tpu.ops.pallas import interpret_mode

import jax.numpy as jnp
from paddle_tpu.ops.pallas import fused_ce as jax_fce

import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.ops import fused as port_fused
from paddle_tpu_torch.ops.cuda import fused_ce as k9
from tests.torch_port_util import no_persistent_compile_cache, port_flags  # noqa: F401

VALUE_RTOL = 1e-5
GRAD_ATOL = 2e-5

# tokens, vocab, chunk, bias, every 5th label ignored, reduction; one
# (tokens, vocab) shape, so the JAX side compiles each route once
_CASES = [
    (300, 97, 128, False, True, "mean"),    # 300 = 2 chunks of 128 + 44
    (300, 97, 0, True, False, "sum"),       # auto chunk: 256 + 44
    (300, 97, 128, True, True, "none"),
]
HIDDEN = 128  # a multiple of 128, so interpret mode reaches K9-K11


def _inputs(tokens, vocab, ignore, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(tokens, HIDDEN).astype(np.float32)
    w = (rng.randn(vocab, HIDDEN) * 0.05).astype(np.float32)
    b = (rng.randn(vocab) * 0.1).astype(np.float32)
    y = rng.randint(0, vocab, (tokens,)).astype(np.int64)
    if ignore:
        y[::5] = -100
    co = rng.randn(tokens).astype(np.float32)
    return h, w, b, y, co


@pytest.mark.parametrize("route", ["scan", "pallas"])
@pytest.mark.parametrize("tokens,vocab,chunk,use_bias,ignore,reduction",
                         _CASES)
def test_value_and_grads_match_jax(route, tokens, vocab, chunk, use_bias,
                                   ignore, reduction, monkeypatch,
                                   no_persistent_compile_cache):
    h, w, b, y, co = _inputs(tokens, vocab, ignore)
    if route == "scan":
        monkeypatch.setattr(jax_fused, "_FORCE_PALLAS", False)
        ctx = contextlib.nullcontext()
    else:
        ctx = interpret_mode()
    with ctx:
        jh, jw = (Tensor(a, stop_gradient=False) for a in (h, w))
        jb = Tensor(b, stop_gradient=False) if use_bias else None
        out = JF.fused_linear_cross_entropy(jh, jw, Tensor(y), jb,
                                            reduction=reduction, chunk=chunk)
        want = np.asarray(out._value)
        (out * Tensor(co) if reduction == "none" else out).sum().backward()
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    tb = torch.from_numpy(b).requires_grad_() if use_bias else None
    got = PF.fused_linear_cross_entropy(th, tw, torch.from_numpy(y), tb,
                                        reduction=reduction, chunk=chunk)
    (got * torch.from_numpy(co) if reduction == "none" else got).sum().backward()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=VALUE_RTOL,
                               atol=VALUE_RTOL)
    pairs = [(th, jh), (tw, jw)] + ([(tb, jb)] if use_bias else [])
    for t, j in pairs:
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad._value),
                                   atol=GRAD_ATOL, rtol=0)
    if ignore:
        ignored = y == -100
        assert np.all(th.grad.numpy()[ignored] == 0.0)
        if reduction == "none":
            assert np.all(got.detach().numpy()[ignored] == 0.0)


def test_all_ignored_mean_is_zero():
    h, w, _, y, _ = _inputs(20, 16, False)
    loss = PF.fused_linear_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(w),
        torch.full((20,), -100, dtype=torch.int64))
    assert float(loss) == 0.0


def test_flash_ce_flag_takes_the_loop_on_the_cpu(monkeypatch):
    """``FLAGS_enable_flash_ce`` with a hidden size of 128 sends the loss
    through the plain K9-K11 on the CPU (the chunked loop is never called);
    with a hidden size the kernels do not take (96), the chunked loop runs,
    as in JAX. Without the flag the chunked loop runs."""
    calls = {"loop": 0, "flash": 0}
    real_loop = port_fused._FusedLinearCE.apply
    real_flash = k9.flash_linear_cross_entropy

    def loop(*a):
        calls["loop"] += 1
        return real_loop(*a)

    def flash(*a):
        calls["flash"] += 1
        return real_flash(*a)

    monkeypatch.setattr(port_fused._FusedLinearCE, "apply", loop)
    monkeypatch.setattr(k9, "flash_linear_cross_entropy", flash)
    h, w, _, y, _ = _inputs(40, 16, False)
    args = (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y))
    want = PF.fused_linear_cross_entropy(*args)
    assert calls == {"loop": 1, "flash": 0}
    with port_flags(enable_flash_ce=True):
        got = PF.fused_linear_cross_entropy(*args)
        assert calls == {"loop": 1, "flash": 1}
        PF.fused_linear_cross_entropy(args[0][:, :96], args[1][:, :96],
                                      args[2])
        assert calls == {"loop": 2, "flash": 1}
    np.testing.assert_allclose(float(got), float(want), rtol=VALUE_RTOL)


_N, _V = 300, 1000


def _flash_inputs():
    rng = np.random.RandomState(7)
    h = rng.randn(_N, HIDDEN).astype(np.float32)
    w = (rng.randn(_V, HIDDEN) * 0.05).astype(np.float32)
    b = (rng.randn(_V) * 0.1).astype(np.float32)
    y = rng.randint(0, _V, (_N,)).astype(np.int64)
    y[[5, 17]] = -100
    return h, w, b, y


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("use_bias", [True, False])
def test_plain_flash_ce_matches_pallas_interpret(use_bias,
                                                 no_persistent_compile_cache):
    h, w, b, y = _flash_inputs()
    ignored = y == -100
    safe = np.where(ignored, 0, y).astype(np.int32)
    g = np.where(ignored, 0.0, 1.0 / (~ignored).sum()).astype(np.float32)
    jb = jnp.asarray(b) if use_bias else None
    jl, jlse = jax_fce.ce_forward(jnp.asarray(h), jnp.asarray(w), jb,
                                  jnp.asarray(safe), interpret=True)
    jdh, jdw, jdb = jax_fce.ce_backward(jnp.asarray(h), jnp.asarray(w), jb,
                                        jnp.asarray(safe), jnp.asarray(g),
                                        jlse, interpret=True)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    tb = torch.from_numpy(b) if use_bias else None
    ty, tg = torch.from_numpy(safe), torch.from_numpy(g)
    loss, lse = k9.ce_forward(th, tw, tb, ty)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-5)
    dh = k9.ce_backward_dx(th, tw, tb, ty, tg, lse)
    dw, db = k9.ce_backward_dw(th, tw, tb, ty, tg, lse)
    assert _rel(dh, jdh) < 1e-4 and _rel(dw, jdw) < 1e-4
    assert np.all(dh.numpy()[ignored] == 0.0)
    if use_bias:
        assert db.dtype == torch.float32 and _rel(db, jdb) < 1e-4
    else:
        assert db is None and jdb is None


@pytest.mark.parametrize("use_bias", [True, False])
def test_flash_ce_route_matches_jax_flce(use_bias,
                                         no_persistent_compile_cache):
    """The port's loss under the flag (plain K9-K11, autograd through the
    ``_FlashCE`` function) against JAX's ``_flce`` in interpret mode (its
    Pallas kernels): mean loss and dh, dw, db."""
    import jax

    h, w, b, y = _flash_inputs()

    def f(hh, ww, bb):
        bb = bb if use_bias else jnp.zeros((), jnp.float32)
        losses = jax_fused._flce(hh, ww, bb, jnp.asarray(y), -100, 0)
        return losses.sum() / float((y != -100).sum())

    with interpret_mode():
        jloss = float(f(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b)))
        jgrads = jax.grad(f, (0, 1, 2))(jnp.asarray(h), jnp.asarray(w),
                                        jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (h, w, b)]
    with port_flags(enable_flash_ce=True):
        loss = PF.fused_linear_cross_entropy(
            leaves[0], leaves[1], torch.from_numpy(y),
            leaves[2] if use_bias else None)
    loss.backward()
    assert abs(float(loss) - jloss) < 1e-5
    for t, want in zip(leaves[:3 if use_bias else 2], jgrads):
        assert _rel(t.grad, want) < 1e-4


_BF16_STEP = 2.0 ** -7


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("hidden", [128, 384, 1152])
def test_bf16_plain_flash_ce_matches_pallas_interpret(
        hidden, use_bias, no_persistent_compile_cache):
    """bf16 operands: the plain K9-K11 against the Pallas kernels in
    interpret mode (300 tokens, vocab 1000, two labels ignored)."""
    rng = np.random.RandomState(hidden + use_bias)
    h = rng.randn(_N, hidden).astype(np.float32)
    w = (rng.randn(_V, hidden) * 0.05).astype(np.float32)
    b = (rng.randn(_V) * 0.1).astype(np.float32)
    y = rng.randint(0, _V, (_N,)).astype(np.int32)
    y[[5, 17]] = 0
    g = np.full(_N, 1.0 / (_N - 2), np.float32)
    g[[5, 17]] = 0.0
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    jb = jnp.asarray(b) if use_bias else None
    jl, jlse = jax_fce.ce_forward(jh, jw, jb, jnp.asarray(y), interpret=True)
    jdh, jdw, jdb = jax_fce.ce_backward(jh, jw, jb, jnp.asarray(y),
                                        jnp.asarray(g), jlse, interpret=True)
    th = torch.from_numpy(h).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    tb = torch.from_numpy(b) if use_bias else None
    ty, tg = torch.from_numpy(y), torch.from_numpy(g)
    loss, lse = k9.ce_forward(th, tw, tb, ty)
    dh = k9.ce_backward_dx(th, tw, tb, ty, tg, lse)
    dw, db = k9.ce_backward_dw(th, tw, tb, ty, tg, lse)
    assert dh.dtype == dw.dtype == torch.bfloat16
    pairs = [(loss, jl), (lse, jlse), (dh, jdh), (dw, jdw)]
    if use_bias:
        pairs.append((db, jdb))
    else:
        assert db is None and jdb is None
    for got, want in pairs:
        assert _rel(got.float(), np.asarray(want, np.float32)) <= _BF16_STEP


# (hidden, dtype, mode, expected (route, cluster CTAs, slice columns))
_PLANS = [
    (128, torch.bfloat16, 0, ("cluster", 1, 128)),
    (384, torch.bfloat16, 1, ("cluster", 1, 384)),
    (640, torch.bfloat16, 0, ("cluster", 5, 128)),
    (768, torch.bfloat16, 0, ("cluster", 2, 384)),
    (768, torch.float16, 1, ("cluster", 2, 384)),
    (1024, torch.bfloat16, 1, ("cluster", 4, 256)),
    (1152, torch.bfloat16, 0, ("cluster", 3, 384)),
    (1536, torch.bfloat16, 1, ("cluster", 4, 384)),
    (1408, torch.bfloat16, 0, ("streamed", 1, 128)),
    (2048, torch.bfloat16, 0, ("streamed", 1, 512)),
    (3072, torch.float16, 1, ("streamed", 1, 768)),
    (4096, torch.bfloat16, 1, ("streamed", 1, 512)),
    (768, torch.float32, 0, ("resident", 1, 768)),
    (1536, torch.float32, 1, ("streamed", 1, 768)),
    # K9 (mode 2): (route, {tokens: (vocab ranges, CTAs)}). 24576 tokens are
    # 192 stripes of 128: one range would leave 1.45 waves on 132 SMs, two
    # give 384 units, 3 a CTA (2.91 waves), 99 of the 197 vocab tiles a
    # range; 16384 tokens are 128 stripes, one wave with one range
    (768, torch.bfloat16, 2, ("wgmma", {24576: (2, 132), 16384: (1, 128)})),
    (1536, torch.bfloat16, 2, ("wgmma", {24576: (2, 132), 16384: (1, 128)})),
    (1408, torch.bfloat16, 2, ("wgmma", {24576: (2, 132), 16384: (1, 128)})),
    (4096, torch.bfloat16, 2, ("wgmma", {24576: (2, 132), 16384: (1, 128)})),
    (3072, torch.float16, 2, ("wgmma", {24576: (2, 132), 16384: (1, 128)})),
    (768, torch.float32, 2, ("resident", {24576: (1, 768), 16384: (1, 512)})),
    (1536, torch.float32, 2, ("streamed", {24576: (1, 768),
                                           16384: (1, 512)})),
]


@pytest.mark.parametrize("hidden,dtype,mode,want", _PLANS)
def test_kernel_plan_names_the_route(hidden, dtype, mode, want):
    """The plan's routes: the cluster kernel at 2-byte widths that split
    into 384-, 256- or 128-column slices over at most 8 CTAs (the fewest)
    whose ring still holds two T blocks beside the partners' partials; the
    streamed kernel at 2-byte widths that do not (1408: 22 CTAs; 2048 and
    3072, whose 8-CTA clusters leave too little ring; 4096); FMA kernels at
    fp32. The CTAs launched follow from the rows. K9 takes the wgmma
    kernel at every 2-byte width (256-column vocab tiles) and the FMA
    kernels at fp32 (32-token blocks, one range)."""
    n, v = 24576, 50304
    if mode == 2:
        route, by_tokens = want
        for tokens, (ranges, ctas) in by_tokens.items():
            assert k9.kernel_plan(tokens, v, hidden, dtype, 2) == {
                "route": route, "ranges": ranges,
                "tile": 256 if route == "wgmma" else 32, "ctas": ctas}
        return
    plan = k9.kernel_plan(n, v, hidden, dtype, mode)
    assert (plan["route"], plan["cluster"], plan["slice"]) == want
    rows = n if mode == 0 else v
    if want[0] == "cluster":
        assert plan["ctas"] == want[1] * -(-rows // 64)
        assert want[1] * want[2] == hidden
    else:
        assert plan["ctas"] == -(-rows // 32) * (hidden // want[2])
