"""The port's BERT (``paddle_tpu_torch/models/bert.py``) and its
``EncoderScorer`` against the JAX package's, on the CPU, with the same
weights (``load_jax_state``) and numpy inputs. Tiny config: vocab 128,
hidden 32, 2 layers, 2 heads, feed-forward 64, sequences of 16.

Limits:
* fp32 forward (sequence and pooled outputs, classifier logits, MLM and
  NSP logits), with and without a padding mask; the pretraining loss (MLM
  + NSP) and every parameter's gradient; a 5-step AdamW loss curve: 1e-5
  absolute / 1e-4 relative (1e-5 on the losses), the same fp32 arithmetic
  in another order;
* a bf16 model (``amp.decorate(O2)``, fp32 LayerNorms) with a padding mask:
  each module's output dtype equals JAX's (bf16 embeddings, fp32 from the
  first attention output on: the promotion both packages keep), values
  within two bf16 steps of the module's largest value;
* padding does not change the unpadded positions (1e-5, as the JAX test
  ``test_bert_forward_shapes_and_padding_mask``);
* ``EncoderScorer`` against JAX's scorer on the inputs of JAX's
  ``test_encoder_scorer_parity_and_bucket_compiles`` (rtol 1e-4, atol
  1e-5), one padded shape a bucket;
* at the default dropout 0.1 a training loss replays bit for bit after
  ``paddle_tpu_torch.seed``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models import bert as JB

import paddle_tpu_torch as pt
import paddle_tpu_torch.models as pm
from tests.torch_port_util import (  # noqa: F401
    grads_match,
    model_pair,
    no_persistent_compile_cache,
)

ATOL, RTOL = 1e-5, 1e-4
BF16_STEP = 2.0 ** -7
CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position_embeddings=64,
           hidden_dropout=0.0, attention_dropout=0.0)


def _pair(jax_cls, port_cls, seed=0, **kw):
    return model_pair(lambda: jax_cls(JB.BertConfig(**CFG), **kw),
                      lambda device: port_cls(pm.BertConfig(**CFG), **kw,
                                              device=device), seed)


def _inputs(seed=0, b=2, s=16, padded=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s)).astype(np.int64)
    types = (np.arange(s) >= s // 2).astype(np.int64)[None].repeat(b, 0)
    mask = np.ones((b, s), np.float32)
    if padded:
        mask[0, 11:] = 0.0
        mask[1, 5:] = 0.0
    return ids, types, mask


def _j(*arrs):
    return [None if a is None else Tensor(a) for a in arrs]


def _t(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype("float32").numpy()),
                               atol=atol, rtol=rtol)


def test_configs_match_jax():
    for name in ("bert_base", "bert_large"):
        assert (dataclasses.asdict(getattr(pm, name)())
                == dataclasses.asdict(getattr(JB, name)()))
    assert pm.bert_large().hidden_size == 1024
    assert pm.bert_large().layer_norm_eps == 1e-12


@pytest.mark.parametrize("padded", [False, True], ids=["no_mask", "padded"])
def test_forward_matches_jax(padded, no_persistent_compile_cache):
    ids, types, mask = _inputs(padded=padded)
    mask = mask if padded else None
    jm, tm = _pair(JB.BertModel, pm.BertModel)
    jseq, jpool = jm(*_j(ids, types), attention_mask=_j(mask)[0])
    with torch.no_grad():
        tseq, tpool = tm(*_t(ids, types), attention_mask=_t(mask)[0])
    _close(tseq, jseq)
    _close(tpool, jpool)
    jm, tm = _pair(JB.BertForSequenceClassification,
                   pm.BertForSequenceClassification, num_classes=3)
    with torch.no_grad():
        _close(tm(*_t(ids, types), attention_mask=_t(mask)[0]),
               jm(*_j(ids, types), attention_mask=_j(mask)[0]))
    jm, tm = _pair(JB.BertForPretraining, pm.BertForPretraining)
    want = jm(*_j(ids, types), attention_mask=_j(mask)[0])
    with torch.no_grad():
        got = tm(*_t(ids, types), attention_mask=_t(mask)[0])
    assert tuple(got[0].shape) == (2, 16, 128)
    for g, w in zip(got, want):
        _close(g, w)


def _labels(seed=1, b=2, s=16):
    rng = np.random.RandomState(seed)
    lab = np.where(rng.rand(b, s) < 0.4, rng.randint(0, 128, (b, s)), -100)
    return lab.astype(np.int64), rng.randint(0, 2, (b,)).astype(np.int64)


@pytest.mark.parametrize("nsp", [False, True], ids=["mlm", "mlm_nsp"])
def test_pretraining_loss_and_grads_match_jax(nsp,
                                              no_persistent_compile_cache):
    ids, types, mask = _inputs()
    mlm, nsp_labels = _labels()
    nsp_labels = nsp_labels if nsp else None
    jm, tm = _pair(JB.BertForPretraining, pm.BertForPretraining)
    jm.train()
    tm.train()
    want = jm.loss(*_j(ids, mlm, types, mask), nsp_labels=_j(nsp_labels)[0])
    got = tm.loss(*_t(ids, mlm, types, mask), nsp_labels=_t(nsp_labels)[0])
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL,
                               rtol=0)
    want.backward()
    got.backward()
    grads_match(jm, tm)


def test_adamw_loss_curve_matches_jax(no_persistent_compile_cache):
    """5 AdamW steps of the MLM + NSP loss with a padding mask."""
    jm, tm = _pair(JB.BertForPretraining, pm.BertForPretraining)
    jm.train()
    tm.train()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    topt = pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=tm.parameters())
    want, got = [], []
    for step in range(5):
        ids, types, mask = _inputs(seed=10 + step)
        mlm, nsp = _labels(seed=20 + step)
        loss = jm.loss(*_j(ids, mlm, types, mask), nsp_labels=_j(nsp)[0])
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        want.append(float(loss))
        loss = tm.loss(*_t(ids, mlm, types, mask), nsp_labels=_t(nsp)[0])
        loss.backward()
        topt.step()
        topt.clear_grad()
        got.append(float(loss.detach()))
    assert want[-1] < want[0]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _bf16_pair(jax_cls, port_cls, **kw):
    from paddle_tpu_torch import amp

    jm, tm = _pair(jax_cls, port_cls, **kw)
    paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    amp.decorate(tm, level="O2", dtype="bfloat16")
    return jm, tm


def _module_outputs(model, ids, types, mask, wrap):
    """The classifier's modules one by one: embeddings, each encoder layer,
    pooler, classifier."""
    from paddle_tpu_torch.models.bert import padding_bias

    bert = model.bert
    ids, types, mask = wrap(ids, types, mask)
    if isinstance(mask, torch.Tensor):
        bias = padding_bias(mask)
    else:
        bias = ((1.0 - mask.astype("float32")) * -1e4).unsqueeze(1)
        bias = bias.unsqueeze(2)
    outs = [bert.embeddings(ids, types)]
    for layer in bert.encoder.layers:
        outs.append(layer(outs[-1], src_mask=bias))
    outs.append(bert.pooler(outs[-1]))
    outs.append(model.classifier(outs[-1]))
    return outs


def test_bf16_model_with_a_padding_mask_keeps_jax_dtypes(
        no_persistent_compile_cache):
    """The property both packages keep: with bf16 weights and an fp32
    padding mask, attention promotes, so every module from the first
    encoder layer on gives fp32 (its Linear layers promote the bf16
    weights, its LayerNorms take fp32 rows)."""
    jm, tm = _bf16_pair(JB.BertForSequenceClassification,
                        pm.BertForSequenceClassification, num_classes=3)
    ids, types, mask = _inputs()
    want = _module_outputs(jm, ids, types, mask, _j)
    with torch.no_grad():
        got = _module_outputs(tm, ids, types, mask, _t)
    names = ["embeddings", "layer0", "layer1", "pooler", "classifier"]
    assert [str(w.dtype) for w in want] == [
        "bfloat16", "float32", "float32", "float32", "float32"]
    for name, g, w in zip(names, got, want):
        assert str(g.dtype) == "torch." + str(w.dtype), name
        w32 = np.asarray(w.astype("float32").numpy())
        np.testing.assert_allclose(
            g.float().numpy(), w32, rtol=0,
            atol=2 * BF16_STEP * np.abs(w32).max(), err_msg=name)


def test_padding_does_not_change_unpadded_outputs():
    """JAX's ``test_bert_forward_shapes_and_padding_mask``, on the port."""
    tm = pm.BertModel(pm.BertConfig(**CFG), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tm.eval()
    ids, _, _ = _inputs(padded=False)
    mask = np.ones((2, 16), np.float32)
    mask[:, 12:] = 0.0
    ids2 = ids.copy()
    ids2[:, 12:] = 7
    with torch.no_grad():
        seq, pooled = tm(torch.from_numpy(ids))
        a, _ = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
        b, _ = tm(torch.from_numpy(ids2),
                  attention_mask=torch.from_numpy(mask))
    assert tuple(seq.shape) == (2, 16, 32) and tuple(pooled.shape) == (2, 32)
    np.testing.assert_allclose(a[:, :12].numpy(), b[:, :12].numpy(),
                               atol=1e-5)


def test_encoder_scorer_matches_jax(no_persistent_compile_cache):
    """JAX's ``test_encoder_scorer_parity_and_bucket_compiles``: 6 requests
    in buckets (8, 16) at ``max_batch`` 4: the port's scorer gives JAX's
    scorer's logits and each request's own unpadded logits, and runs one
    padded shape a bucket (where JAX compiles one executable a bucket)."""
    jm, tm = _pair(JB.BertForSequenceClassification,
                   pm.BertForSequenceClassification, num_classes=3)
    rng = np.random.RandomState(0)
    seqs = [rng.randint(0, 128, n).tolist() for n in (5, 8, 11, 16, 3, 7)]
    want = jm.scorer(max_batch=4, seq_buckets=(8, 16)).score(seqs)
    scorer = tm.scorer(max_batch=4, seq_buckets=(8, 16))
    got = scorer.score(seqs)
    assert got.shape == (6, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert scorer.padded_shapes == [(4, 16), (4, 8)]
    with torch.no_grad():
        for s, row in zip(seqs, got):
            alone = tm(torch.tensor([s]))[0].numpy()
            np.testing.assert_allclose(row, alone, rtol=1e-4, atol=1e-5)


def test_seeded_replay_at_the_default_dropout():
    cfg = dict(CFG, hidden_dropout=0.1, attention_dropout=0.1)
    tm = pm.BertForPretraining(pm.BertConfig(**cfg), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    tm.train()
    ids, types, mask = _inputs()
    mlm, nsp = _labels()

    def loss():
        return float(tm.loss(*_t(ids, mlm, types, mask),
                             nsp_labels=_t(nsp)[0]).detach())

    pt.seed(5)
    first = loss()
    pt.seed(5)
    assert loss() == first
    pt.seed(6)
    assert loss() != first
    tm.eval()
    assert loss() == loss()
