"""The port's GPT against the JAX package's, on the CPU, fp32: the same
weights (carried over by ``load_jax_state``) give the same logits within
1e-4 (two blocks of fp32 matmuls over widths up to 512 in another order),
at hidden 128, 2 layers, 2 heads, vocab 97, 256 positions."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import interpret_mode

import paddle_tpu_torch.models as pm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.serving import KVCache, PrefillView
from tests.torch_port_util import gpt_pair, no_persistent_compile_cache  # noqa: F401

LOGIT_TOL = 1e-4


@pytest.mark.parametrize("seq", [16, 128])
def test_uncached_logits_match_jax(seq, no_persistent_compile_cache):
    jm, tm = gpt_pair()
    ids = np.random.RandomState(seq).randint(0, 97, (2, seq))
    with interpret_mode():
        want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int64))).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, seq, 97)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


def test_cached_prefill_logits_match_uncached():
    """A prefill through the cache views and a LengthMask gives the
    uncached causal forward's logits on every valid position."""
    _, tm = gpt_pair()
    n, bucket = 20, 32
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :n] = np.random.RandomState(0).randint(0, 97, n)
    cfg = tm.cfg
    cache = KVCache.alloc(cfg.num_layers, 2, 64, cfg.num_heads,
                          cfg.hidden_size // cfg.num_heads, device="cpu")
    i = torch.arange(bucket, dtype=torch.int32)
    lm = PF.LengthMask(i[None], torch.tensor([n], dtype=torch.int32))
    views = [PrefillView(k, v, 1) for k, v in zip(cache.ks, cache.vs)]
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(ids), position_ids=i[None],
                    attn_mask=lm, cache=views)
        want = tm(torch.from_numpy(ids[:, :n]))
    np.testing.assert_allclose(got[0, :n].numpy(), want[0].numpy(),
                               atol=LOGIT_TOL, rtol=0)
    assert cache.ks[0][1, :n].abs().sum() > 0   # slot 1 written in place
    assert cache.ks[0][0].abs().sum() == 0      # slot 0 untouched


def test_load_jax_state_transposes_linear_weights():
    # both packages keep paddle's [in, out]: nothing is transposed (C9)
    jm, tm = gpt_pair(layers=1)
    jw = np.asarray(jm.state_dict()["gpt.layers.0.qkv_proj.weight"].numpy())
    assert jw.shape == (128, 384)               # paddle: [in, out]
    tw = tm.gpt.layers[0].qkv_proj.weight.detach().numpy()
    assert tw.shape == (128, 384)
    np.testing.assert_array_equal(tw, jw)


def test_load_jax_state_rejects_a_mismatched_state():
    jm, tm = gpt_pair(layers=1)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    state.pop("gpt.ln_f.bias")
    with pytest.raises(KeyError, match="gpt.ln_f.bias"):
        pm.load_jax_state(tm, state)


def test_seeded_init_is_reproducible_and_device_defaults_to_cuda():
    cfg = pm.GPTConfig(vocab_size=31, hidden_size=32, num_layers=1,
                       num_heads=2, max_position_embeddings=16)
    a = pm.GPTForCausalLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    b = pm.GPTForCausalLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pm.GPTForCausalLM(cfg)
