"""The port's ``nn/layer/transformer.py`` against the JAX package's, on the
CPU, fp32, with the same weights (``load_jax_state``) and numpy inputs:

* ``_convert_attention_mask`` (bool -> additive at -1e9) and
  ``generate_square_subsequent_mask``: equal;
* ``MultiHeadAttention`` (self and cross attention; no mask, a bool mask,
  an additive one), ``TransformerEncoderLayer`` pre- and post-LN with relu
  and gelu, a ``TransformerEncoder`` with a final norm, the decoder layer
  and the encoder-decoder ``Transformer``: outputs within 1e-5 absolute /
  1e-4 relative (the same fp32 arithmetic in another order), and the
  encoder layer's input and parameter gradients within the same limits;
* decoding: the port's ``Cache`` (self-attention, grown a token at a time)
  and ``StaticCache`` (cross-attention over the memory) give the full
  causal forward's rows, and JAX's cached decoding the same values;
* ``_clone_layer``: clones redraw each weight of two or more dims with
  std ``sqrt(2 / (fan_in + fan_out))`` and keep the rest, reproducibly
  from a generator.

Sizes: d_model 32, 2 heads, feed-forward 64, 2 layers, sequences <= 8.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.nn.layer import transformer as JT

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch.nn.layer import transformer as PT
from tests.torch_port_util import (  # noqa: F401
    default_place,
    grads_match,
    model_pair,
    no_persistent_compile_cache,
    port_cpu,
)

# layers built here without a device land on the CPU place
pytestmark = pytest.mark.usefixtures("port_cpu")

ATOL, RTOL = 1e-5, 1e-4
D, H, FF = 32, 2, 64


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want.numpy()), atol=ATOL,
                               rtol=RTOL)


def _masks(kind, sq, sk):
    """(jax mask, port mask): None, a bool keep-mask or an additive one,
    ``[2, 1, sq, sk]``."""
    if kind == "none":
        return None, None
    rng = np.random.RandomState(3)
    keep = rng.rand(2, 1, sq, sk) < 0.7
    keep[..., 0] = True
    if kind == "bool":
        return Tensor(keep), torch.from_numpy(keep)
    add = np.where(keep, 0.0, -1e4).astype(np.float32)
    return Tensor(add), torch.from_numpy(add)


def test_convert_attention_mask_and_causal_mask_match_jax():
    _, pm = _masks("bool", 4, 6)
    jm, _ = _masks("bool", 4, 6)
    got = PT._convert_attention_mask(pm, torch.float32)
    want = JT._convert_attention_mask(jm, "float32")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    add = torch.zeros(2, 1, 4, 6)
    assert PT._convert_attention_mask(add, torch.float32) is add
    jt, tt = model_pair(lambda: jnn.Transformer(D, H, 1, 1, FF),
                        lambda device: pnn.Transformer(D, H, 1, 1, FF,
                                                       device=device))
    np.testing.assert_array_equal(
        tt.generate_square_subsequent_mask(5).numpy(),
        np.asarray(jt.generate_square_subsequent_mask(5).numpy()))


@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_multi_head_attention_matches_jax(cross, mask,
                                          no_persistent_compile_cache):
    jm, tm = model_pair(lambda: jnn.MultiHeadAttention(D, H),
                        lambda device: pnn.MultiHeadAttention(D, H,
                                                              device=device))
    q = _x(2, 5, D)
    kv = _x(2, 7, D, seed=1) if cross else q
    jmask, tmask = _masks(mask, 5, kv.shape[1])
    want = jm(Tensor(q), Tensor(kv), Tensor(kv), jmask)
    got = tm(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
             tmask)
    _close(got, want)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_encoder_layer_forward_and_grads_match_jax(
        normalize_before, activation, no_persistent_compile_cache):
    kw = dict(dropout=0.0, activation=activation,
              normalize_before=normalize_before)
    jm, tm = model_pair(
        lambda: jnn.TransformerEncoderLayer(D, H, FF, **kw),
        lambda device: pnn.TransformerEncoderLayer(D, H, FF, **kw,
                                                   device=device))
    x = _x(2, 8, D)
    jmask, tmask = _masks("additive", 8, 8)
    jx = Tensor(x)
    jx.stop_gradient = False
    want = jm(jx, jmask)
    tx = torch.from_numpy(x).requires_grad_()
    got = tm(tx, tmask)
    _close(got, want)
    w = _x(2, 8, D, seed=4)
    (want * Tensor(w)).sum().backward()
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               atol=ATOL, rtol=RTOL)
    grads_match(jm, tm)


def test_encoder_stack_with_norm_matches_jax(no_persistent_compile_cache):
    def jax_ctor():
        layer = jnn.TransformerEncoderLayer(D, H, FF, dropout=0.0,
                                            normalize_before=True)
        return jnn.TransformerEncoder(layer, 2, jnn.LayerNorm(D))

    def port_ctor(device):
        layer = pnn.TransformerEncoderLayer(D, H, FF, dropout=0.0,
                                            normalize_before=True,
                                            device=device)
        return pnn.TransformerEncoder(layer, 2, pnn.LayerNorm(D),
                                      device=device)

    jm, tm = model_pair(jax_ctor, port_ctor)
    x = _x(2, 6, D)
    _close(tm(torch.from_numpy(x)), jm(Tensor(x)))


def _transformer_pair(normalize_before):
    kw = dict(d_model=D, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=FF, dropout=0.0,
              normalize_before=normalize_before)
    return model_pair(lambda: jnn.Transformer(**kw),
                      lambda device: pnn.Transformer(**kw, device=device))


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_transformer_forward_matches_jax(normalize_before,
                                         no_persistent_compile_cache):
    jm, tm = _transformer_pair(normalize_before)
    src, tgt = _x(2, 7, D), _x(2, 5, D, seed=1)
    want = jm(Tensor(src), Tensor(tgt),
              tgt_mask=jm.generate_square_subsequent_mask(5))
    got = tm(torch.from_numpy(src), torch.from_numpy(tgt),
             tgt_mask=tm.generate_square_subsequent_mask(5))
    _close(got, want)


def _decode(decoder, tgt, memory, caches, wrap):
    """Feed ``tgt`` a token at a time through ``decoder`` with ``caches``;
    returns the per-step outputs, each ``[b, 1, d]``."""
    outs = []
    for t in range(tgt.shape[1]):
        out, caches = decoder(wrap(tgt[:, t:t + 1]), memory, cache=caches)
        outs.append(out)
    return outs


def test_cached_decoding_equals_the_full_forward(no_persistent_compile_cache):
    jm, tm = _transformer_pair(False)
    src, tgt = _x(2, 7, D), _x(2, 5, D, seed=1)
    with torch.no_grad():
        memory = tm.encoder(torch.from_numpy(src))
        full = tm.decoder(torch.from_numpy(tgt), memory,
                          tgt_mask=tm.generate_square_subsequent_mask(5))
        caches = tm.decoder.gen_cache(memory)
        assert isinstance(caches[0][0], pnn.MultiHeadAttention.Cache)
        assert isinstance(caches[0][1], pnn.MultiHeadAttention.StaticCache)
        assert caches[0][0].k.shape == (2, 0, H, D // H)
        steps = _decode(tm.decoder, tgt, memory, caches, torch.from_numpy)
    for t, out in enumerate(steps):
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL, rtol=RTOL)
    jmem = jm.encoder(Tensor(src))
    jsteps = _decode(jm.decoder, tgt, jmem, jm.decoder.gen_cache(jmem),
                     Tensor)
    for got, want in zip(steps, jsteps):
        _close(got, want)


def test_encoder_layer_incremental_cache_matches_jax(
        no_persistent_compile_cache):
    jm, tm = model_pair(
        lambda: jnn.TransformerEncoderLayer(D, H, FF, dropout=0.0),
        lambda device: pnn.TransformerEncoderLayer(D, H, FF, dropout=0.0,
                                                   device=device))
    x = _x(2, 3, D)
    jc = jm.gen_cache(Tensor(x))
    with torch.no_grad():
        tc = tm.gen_cache(torch.from_numpy(x))
        for t in range(3):
            want, jc = jm(Tensor(x[:, t:t + 1]), cache=jc)
            got, tc = tm(torch.from_numpy(x[:, t:t + 1]), cache=tc)
            _close(got, want)
    assert tc.k.shape == (2, 3, H, D // H)


def test_clone_layer_redraws_weights_with_the_xavier_std():
    layer = pnn.TransformerEncoderLayer(
        256, 4, 512, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in layer.parameters():
            if p.ndim == 1:
                p.uniform_()          # the clone keeps 1-D parameters
    a = PT._clone_layer(layer, torch.Generator().manual_seed(1))
    b = PT._clone_layer(layer, torch.Generator().manual_seed(1))
    for (name, p), pa, pb in zip(layer.named_parameters(), a.parameters(),
                                 b.parameters()):
        assert torch.equal(pa, pb), name                 # reproducible
        if p.ndim >= 2:
            assert not torch.equal(pa, p), name
            want = math.sqrt(2.0 / (p.shape[0] + p.shape[1]))
            assert abs(float(pa.detach().std()) / want - 1) < 0.02, name
        else:
            assert torch.equal(pa, p), name
    stack = pnn.TransformerEncoder(layer, 3, device="cpu")
    assert stack.layers[0] is layer
    assert not torch.equal(stack.layers[1].linear1.weight,
                           stack.layers[2].linear1.weight)


def test_layers_default_to_the_card_and_take_no_param_attr():
    # Linear takes a ParamAttr (its name, initializer, trainable); since
    # A7(a2) the conv and norm layers take one too
    # (tests/test_torch_nn_utils.py holds them against the JAX package)
    lin = pnn.Linear(4, 4, weight_attr=pnn.ParamAttr(
        name="w", initializer=pnn.initializer.Constant(0.5)), bias_attr="b")
    assert lin.weight.name == "w" and lin.bias.name == "b"
    assert torch.equal(lin.weight, torch.full((4, 4), 0.5))
    assert pnn.Linear(4, 4, bias_attr=False).bias is None
    assert pnn.Conv2D(2, 3, 3, bias_attr="b").bias.name == "b"
    if not torch.cuda.is_available():
        with default_place():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                pnn.MultiHeadAttention(D, H)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                pnn.Linear(4, 4)
