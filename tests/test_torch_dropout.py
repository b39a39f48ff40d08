"""Attention dropout of the port on the CPU: the Philox generator the flash
kernels draw their keep-mask from, the dense path against the JAX package's
``_sdpa_raw`` given the same mask, the flash kernels' plain versions against
the dense path given the Philox mask of their seed, the router's dropout
routes, the JAX wrapper's refusals, and seeded replay of a default-config
GPT (hidden and attention dropout 0.1).

Tolerances: fp32 1e-5 on outputs and gradients (the same fp32 arithmetic in
another order); bf16 plain kernels one bf16 step a element,
|Δ| <= 2^-7 · max(1, |ref|), against the fp32 dense path on the same bf16
inputs (each output rounds once; K1 and K3 also round p and ds · scale).
The keep rate is held within 4σ of 1 - p (a binomial over the mask).
"""
import importlib
import inspect
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional import attention as JA

from paddle_tpu_torch.framework import random as rnd
from paddle_tpu_torch.nn.functional import attention as PA
from paddle_tpu_torch.ops import philox
from paddle_tpu_torch.ops.cuda import flash_attention as k1
from paddle_tpu_torch.ops.cuda import flash_attention_packed as k5
from tests.torch_port_util import FP32_TOL, port_flags

# the module (the package exports a function of the same name)
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

BF16_STEP = 2.0 ** -7
SEED = (0x9E3779B9, 12345)


# ---------------------------------------------------------------------------
# Philox4x32-10 and the keep rule
# ---------------------------------------------------------------------------
# Random123's kat_vectors: counter, key -> output
_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", _KAT)
def test_philox_known_answer_vectors(ctr, key, want):
    got = philox.philox4x32(*ctr, *key)
    assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("p", [0.0, 1e-6, 0.1, 0.25, 0.5, 0.9, 0.999999])
def test_keep_threshold_is_the_tpu_kernels_rule(p):
    # the line of _keep_bits (paddle_tpu/ops/pallas/flash_attention.py)
    rule = "thr = min(int((1.0 - dropout_p) * 65536.0), 65535)"
    assert rule in inspect.getsource(jfa._keep_bits)
    scope = {"dropout_p": p}
    exec(rule, {}, scope)
    assert philox.keep_threshold(p) == scope["thr"]


def test_keep_mask_depends_only_on_absolute_coordinates():
    """One mask whatever the tiling: a (70, 77) call's mask is the corner of
    a (100, 120) call's with the same seed, batch and heads; element
    (b, h, i, j) is bit (j & 7) of Philox(j >> 3, i, b·H + h, 0); the keep
    rate is within 4σ of 1 - p; another seed gives another mask."""
    p = 0.1
    big = philox.keep_mask(SEED, 2, 3, 100, 120, p)
    small = philox.keep_mask(SEED, 2, 3, 70, 77, p)
    assert torch.equal(small, big[:, :, :70, :77])
    b, hh, i, j = 1, 2, 37, 53
    words = philox.philox4x32(j >> 3, i, b * 3 + hh, 0, *SEED)
    bits = (int(words[(j & 7) >> 1]) >> (16 * (j & 1))) & 0xFFFF
    assert bool(big[b, hh, i, j]) == (bits < philox.keep_threshold(p))
    n = big.numel()
    rate = big.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * math.sqrt(p * (1 - p) / n)
    assert not torch.equal(big, philox.keep_mask((1, 2), 2, 3, 100, 120, p))


# ---------------------------------------------------------------------------
# the dense path against JAX's, given one mask
# ---------------------------------------------------------------------------
def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, sq, h, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, sk, h, d) * 0.5).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    co = rng.randn(b, sq, h, d).astype(np.float32)
    return q, k, v, co, rng


def _jax_dense(q, k, v, co, keep, p, causal):
    """JAX ``_sdpa_raw`` given the keep-mask: output and (dq, dk, dv)."""
    jkeep = jnp.asarray(keep)

    def f(q_, k_, v_):
        out = JA._sdpa_raw.raw(q_, k_, v_, None, jkeep, causal=causal,
                               dropout_p=p)
        return jnp.vdot(out, jnp.asarray(co)), out

    (_, out), grads = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _grads(fn, q, k, v, co, dtype=torch.float32):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(co).to(dtype))
    return [out] + list(grads)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_dropout_matches_jax_given_the_mask(causal):
    b, sq, sk, h, d, p = 2, 24, 40, 2, 16, 0.2
    q, k, v, co, rng = _qkv(b, sq, sk, h, d, 1)
    keep = rng.rand(b, h, sq, sk) >= p
    want = _jax_dense(q, k, v, co, keep, p, causal)
    got = _grads(lambda *t: PA._sdpa_raw(*t, None, torch.from_numpy(keep),
                                         causal=causal, dropout_p=p),
                 q, k, v, co)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=FP32_TOL,
                                   rtol=0)


def test_sdpa_with_dropout_runs_on_the_cpu_and_matches_jax(monkeypatch):
    """``scaled_dot_product_attention(..., dropout_p=0.1, training=True)``
    on the CPU takes the dense path (a flash shape included) with a
    bernoulli keep-mask from the port's generator; given the mask it drew,
    JAX's ``_sdpa_raw`` gives the same output and gradients."""
    b, s, h, d, p = 1, 128, 2, 32, 0.1
    q, k, v, co, _ = _qkv(b, s, s, h, d, 2)
    drawn = []
    real = PA._keep_mask

    def spy(*a):
        drawn.append(real(*a))
        return drawn[-1]

    monkeypatch.setattr(PA, "_keep_mask", spy)
    rnd.seed(7)
    got = _grads(lambda *t: PA.scaled_dot_product_attention(
        *t, dropout_p=p, is_causal=True, training=True), q, k, v, co)
    assert len(drawn) == 1 and drawn[0].shape == (b, h, s, s)
    want = _jax_dense(q, k, v, co, drawn[0].numpy(), p, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=FP32_TOL,
                                   rtol=0)
    rate = drawn[0].float().mean().item()
    n = drawn[0].numel()
    assert abs(rate - (1 - p)) <= 4 * math.sqrt(p * (1 - p) / n)


# ---------------------------------------------------------------------------
# the flash kernels' plain versions against the dense path
# ---------------------------------------------------------------------------
def _dense_given(keep, p, causal):
    return lambda q, k, v: PA._sdpa_raw(q.float(), k.float(), v.float(),
                                        None, keep, causal=causal,
                                        dropout_p=p)


def _flash(p, causal):
    return lambda q, k, v: k1.flash_attention(
        q, k, v, causal=causal, dropout_p=p, dropout_seed=SEED)


def _packed(p, causal, h):
    def f(q, k, v):
        b, sq, _, d = q.shape
        sk = k.shape[1]
        return k5.flash_attention_packed(
            q.reshape(b, sq, h * d), k.reshape(b, sk, h * d),
            v.reshape(b, sk, h * d), h, causal=causal, dropout_p=p,
            dropout_seed=SEED).reshape(b, sq, h, d)
    return f


def _check(got, want, dtype):
    for g, w in zip(got, want):
        g, w = g.detach().float(), w.detach().float()
        if dtype == torch.float32:
            assert float((g - w).abs().max()) <= FP32_TOL
        else:
            err = (g - w).abs()
            assert bool((err <= BF16_STEP * w.abs().clamp_min(1.0)).all()), \
                float(err.max())


# (sq, sk): the 100 x 130 case's causal boundary (row i sees keys up to
# i + 30) crosses its 64-key tiles; the 96-key case is one tile and a part
@pytest.mark.parametrize("shape", [(100, 130), (96, 96)])
@pytest.mark.parametrize("which", ["k1_k3", "k5_k6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_kernels_match_the_dense_path_given_their_mask(shape, which,
                                                             dtype):
    (sq, sk), b, h, d, p = shape, 2, 2, 32, 0.2
    q, k, v, co, _ = _qkv(b, sq, sk, h, d, 3)
    keep = philox.keep_mask(SEED, b, h, sq, sk, p)
    fn = _flash(p, True) if which == "k1_k3" else _packed(p, True, h)
    got = _grads(fn, q, k, v, co, dtype)
    # the reference sees the same (rounded) inputs and cotangent, in fp32
    r = [torch.from_numpy(a).to(dtype).float().numpy() for a in (q, k, v, co)]
    want = _grads(_dense_given(keep, p, True), *r)
    _check(got, want, dtype)


@pytest.mark.parametrize("tile", [32, 64])
def test_plain_k1_gives_one_answer_at_two_key_tiles(tile, monkeypatch):
    """K1's plain version runs its online softmax over key tiles; the mask
    is the same whatever the tile, so the output matches the dense path at
    both (fp32)."""
    b, sq, sk, h, d, p = 1, 70, 150, 2, 16, 0.3
    q, k, v, co, _ = _qkv(b, sq, sk, h, d, 4)
    monkeypatch.setattr(k1, "_KEY_TILE", tile)
    keep = philox.keep_mask(SEED, b, h, sq, sk, p)
    got = _grads(_flash(p, False), q, k, v, co)
    want = _grads(_dense_given(keep, p, False), q, k, v, co)
    _check(got, want, torch.float32)


# ---------------------------------------------------------------------------
# routes and refusals
# ---------------------------------------------------------------------------
def _spy(monkeypatch, module, name, log):
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        log.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("case", ["packed", "layout_swapping", "length_mask"])
def test_cpu_router_sends_dropout_calls_to_the_dense_path(case, monkeypatch):
    """Shapes that take a flash kernel's plain version on the CPU without
    dropout take the dense path with it (JAX's interpret route has no
    in-kernel PRNG); LengthMask calls with dropout go dense too, as
    ``_blockwise_ok`` sends them in JAX."""
    d = 96 if case == "layout_swapping" else 32
    x = torch.randn(1, 128, 2, d)
    mask = None
    if case == "length_mask":
        mask = PA.LengthMask(torch.arange(128, dtype=torch.int32)[None])
    log = []
    for mod, name in ((PA, "_sdpa_raw"), (PA, "_sdpa_blockwise"),
                      (k1, "flash_attention"), (k1, "flash_attention_cached"),
                      (k5, "flash_attention_packed")):
        _spy(monkeypatch, mod, name, log)
    # LengthMask calls of 128 keys take the cached kernel's route at this
    # threshold
    with port_flags(blockwise_attention_min_kv=128):
        PA.scaled_dot_product_attention(x, x, x, attn_mask=mask,
                                        is_causal=mask is None,
                                        training=False)
    assert log and log[0] != "_sdpa_raw"
    log.clear()
    with port_flags(blockwise_attention_min_kv=128):
        out = PA.scaled_dot_product_attention(x, x, x, attn_mask=mask,
                                              dropout_p=0.1,
                                              is_causal=mask is None,
                                              training=True)
    assert log == ["_sdpa_raw"] and bool(out.isfinite().all())


def test_jax_refusals_raise():
    x = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError, match="dropout_seed"):
        k1.flash_attention(x, x, x, dropout_p=0.1)
    with pytest.raises(ValueError, match="bias_grad"):
        k1.flash_attention(x, x, x, bias=torch.zeros(64, 64), dropout_p=0.1,
                           dropout_seed=SEED)
    # a constant bias takes dropout
    out = k1.flash_attention(x, x, x, bias=torch.zeros(64, 64),
                             bias_grad=False, dropout_p=0.1,
                             dropout_seed=SEED)
    assert out.shape == x.shape
    wide = torch.zeros(1, 8, 1024, 1)
    with pytest.raises(ValueError, match="1024 heads"):
        k1.flash_attention(wide, wide, wide, dropout_p=0.1, dropout_seed=SEED)
    with pytest.raises(ValueError, match="1024 heads"):
        k5.flash_attention_packed(wide.reshape(1, 8, 1024), wide.reshape(
            1, 8, 1024), wide.reshape(1, 8, 1024), 1024, dropout_p=0.1,
            dropout_seed=SEED)
    with pytest.raises(ValueError, match="dropout_seed"):
        k5.flash_attention_packed(x.reshape(1, 64, 64), x.reshape(1, 64, 64),
                                  x.reshape(1, 64, 64), 2, dropout_p=0.1)
    # the kernels take every head dim, as JAX's do: the check passes a head
    # dim above 256 and names the one it refuses
    big = torch.zeros(1, 4, 1, 257)
    assert k1._check_qkv(big, big, big, "flash_attention_fwd") == (
        1, 4, 4, 1, 257)
    empty = torch.zeros(1, 4, 1, 0)
    with pytest.raises(ValueError, match="head dim of at least 1"):
        k1._check_qkv(empty, empty, empty, "flash_attention_fwd")


# ---------------------------------------------------------------------------
# a default-config GPT
# ---------------------------------------------------------------------------
def _default_gpt():
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2, num_heads=2,
                    max_position_embeddings=128)
    assert cfg.hidden_dropout == cfg.attention_dropout == 0.1
    return GPTForCausalLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))


def test_default_dropout_gpt_replays_its_loss_and_trains():
    """Hidden and attention dropout 0.1 (GPTConfig's defaults): the loss
    replays bit for bit from one seed, another seed drops other elements,
    and AdamW steps lower it."""
    from paddle_tpu_torch.optimizer import AdamW

    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 97, (2, 64)))
    model = _default_gpt()
    model.train()
    losses = []
    for s in (5, 5, 6):
        rnd.seed(s)
        losses.append(model.loss(ids, ids).detach())
    assert torch.equal(losses[0], losses[1])
    assert not torch.equal(losses[0], losses[2])
    model.eval()
    assert not torch.equal(model.loss(ids, ids).detach(), losses[0])
    model.train()
    opt = AdamW(learning_rate=1e-2, parameters=model.parameters())
    rnd.seed(0)
    curve = []
    for _ in range(5):
        loss = model.loss(ids, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        curve.append(float(loss.detach()))
    assert all(np.isfinite(curve)) and curve[-1] < curve[0]
