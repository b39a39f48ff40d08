"""The port's ERNIE (``paddle_tpu_torch/models/ernie.py``) against the JAX
package's, on the CPU, with the same weights (``load_jax_state``) and
numpy inputs. Tiny config: vocab 100, hidden 32, 2 layers, 2 heads,
feed-forward 64, task ids on, sequences of 16; the flash-CE curve at
hidden 128 (the kernels' gate: a multiple of 128, below which the flag
keeps the chunked loop in both packages).

Limits:
* fp32 forward of every head (pretraining's MLM logits with the tied,
  biased projection and NSP logits; sequence and token classification;
  question answering), with and without a padding mask; the biased MLM +
  NSP loss and every parameter's gradient; 5-step AdamW loss curves with
  ``FLAGS_enable_flash_ce`` off (the chunked loop) and on (the plain
  K9-K11 against the Pallas kernels in interpret mode): 1e-5 absolute /
  1e-4 relative (1e-5 on the losses);
* the tied matrix is one ``Parameter``, listed once under the JAX name;
* a bf16 model with a padding mask: each module's output dtype equals
  JAX's, values within two bf16 steps of its largest value;
* ``ErnieDataCollator``: the same bits as JAX's from one seed;
* at the default dropout 0.1 a training loss replays bit for bit after
  ``paddle_tpu_torch.seed``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models import ernie as JE
from paddle_tpu.ops.pallas import interpret_mode

import paddle_tpu_torch as pt
import paddle_tpu_torch.models as pm
from tests.torch_port_util import (  # noqa: F401
    both_flags,
    grads_match,
    jax_state,
    model_pair,
    no_persistent_compile_cache,
)

ATOL, RTOL = 1e-5, 1e-4
BF16_STEP = 2.0 ** -7
VOCAB = 100
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position_embeddings=32,
           hidden_dropout=0.0, attention_dropout=0.0)


def _pair(jax_cls, port_cls, seed=0, cfg=None, **kw):
    cfg = cfg or CFG
    return model_pair(lambda: jax_cls(JE.ErnieConfig(**cfg), **kw),
                      lambda device: port_cls(pm.ErnieConfig(**cfg), **kw,
                                              device=device), seed)


def _inputs(seed=0, b=2, s=16, padded=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, s)).astype(np.int64)
    types = (np.arange(s) >= s // 2).astype(np.int64)[None].repeat(b, 0)
    tasks = rng.randint(0, 3, (b, s)).astype(np.int64)
    mask = np.ones((b, s), np.float32)
    if padded:
        mask[0, 12:] = 0.0
        mask[1, 6:] = 0.0
    return ids, types, mask, tasks


def _j(*arrs):
    return [None if a is None else Tensor(a) for a in arrs]


def _t(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype("float32").numpy()),
                               atol=atol, rtol=rtol)


def test_configs_match_jax():
    for name in ("ernie_base", "ernie_large"):
        assert (dataclasses.asdict(getattr(pm, name)())
                == dataclasses.asdict(getattr(JE, name)()))
    assert pm.ernie_large().vocab_size == 18000


def test_tied_matrix_is_one_parameter_under_the_jax_name():
    jm, tm = _pair(JE.ErnieForPretraining, pm.ErnieForPretraining)
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(jax_state(jm))
    assert "ernie.embeddings.word_embeddings.weight" in names
    assert not any("decoder_weight" in n for n in names)
    assert (tm.lm_head.decoder_weight
            is tm.ernie.embeddings.word_embeddings.weight)
    assert tuple(tm.lm_head.decoder_bias.shape) == (VOCAB,)
    assert len(list(tm.parameters())) == len(names)


_HEADS = {
    "pretraining": (JE.ErnieForPretraining, pm.ErnieForPretraining, {}),
    "sequence": (JE.ErnieForSequenceClassification,
                 pm.ErnieForSequenceClassification, {"num_classes": 3}),
    "token": (JE.ErnieForTokenClassification,
              pm.ErnieForTokenClassification, {"num_classes": 5}),
    "qa": (JE.ErnieForQuestionAnswering, pm.ErnieForQuestionAnswering, {}),
}


@pytest.mark.parametrize("padded", [False, True], ids=["no_mask", "padded"])
@pytest.mark.parametrize("head", list(_HEADS))
def test_heads_match_jax(head, padded, no_persistent_compile_cache):
    jcls, tcls, kw = _HEADS[head]
    jm, tm = _pair(jcls, tcls, **kw)
    ids, types, mask, tasks = _inputs(padded=padded)
    mask = mask if padded else None
    want = jm(*_j(ids, types, mask), task_type_ids=_j(tasks)[0])
    with torch.no_grad():
        got = tm(*_t(ids, types, mask), task_type_ids=_t(tasks)[0])
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def _labels(seed=1, b=2, s=16):
    rng = np.random.RandomState(seed)
    lab = np.where(rng.rand(b, s) < 0.4, rng.randint(0, VOCAB, (b, s)), -100)
    return lab.astype(np.int64), rng.randint(0, 2, (b,)).astype(np.int64)


def _loss(model, wrap, ids, types, mask, tasks, mlm, nsp):
    ids, types, mask, tasks, mlm, nsp = wrap(ids, types, mask, tasks, mlm,
                                             nsp)
    return model.loss(ids, mlm, nsp_labels=nsp, token_type_ids=types,
                      attention_mask=mask, task_type_ids=tasks)


def test_pretraining_loss_and_grads_match_jax(no_persistent_compile_cache):
    """The biased MLM loss (the bias gets its gradient) + NSP, padded."""
    jm, tm = _pair(JE.ErnieForPretraining, pm.ErnieForPretraining)
    jm.train()
    tm.train()
    batch = (*_inputs(), *_labels())
    want = _loss(jm, _j, *batch)
    got = _loss(tm, _t, *batch)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL,
                               rtol=0)
    want.backward()
    got.backward()
    assert float(tm.lm_head.decoder_bias.grad.abs().sum()) > 0
    grads_match(jm, tm)


@pytest.mark.parametrize("flash_ce", [False, True], ids=["loop", "flash_ce"])
def test_adamw_loss_curve_matches_jax(flash_ce, no_persistent_compile_cache):
    """5 AdamW steps of the biased MLM + NSP loss with a padding mask, at
    hidden 128. Flag on: the port's plain K9-K11 against JAX's Pallas
    kernels in interpret mode; flag off: the chunked loops."""
    cfg = dict(CFG, hidden_size=128, num_heads=2)
    jm, tm = _pair(JE.ErnieForPretraining, pm.ErnieForPretraining, cfg=cfg)
    jm.train()
    tm.train()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    topt = pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=tm.parameters())
    from paddle_tpu_torch.ops.cuda import fused_ce as k9

    calls = [0]
    real = k9.flash_linear_cross_entropy

    def counting(*a):
        calls[0] += 1
        return real(*a)

    k9.flash_linear_cross_entropy = counting
    want, got = [], []
    try:
        with both_flags(enable_flash_ce=flash_ce), \
                (interpret_mode() if flash_ce else contextlib.nullcontext()):
            for step in range(5):
                batch = (*_inputs(seed=10 + step), *_labels(seed=20 + step))
                loss = _loss(jm, _j, *batch)
                loss.backward()
                jopt.step()
                jopt.clear_grad()
                want.append(float(loss))
                loss = _loss(tm, _t, *batch)
                loss.backward()
                topt.step()
                topt.clear_grad()
                got.append(float(loss.detach()))
    finally:
        k9.flash_linear_cross_entropy = real
    assert calls[0] == (5 if flash_ce else 0)
    assert want[-1] < want[0]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bf16_model_with_a_padding_mask_keeps_jax_dtypes(
        no_persistent_compile_cache):
    """As BERT's: bf16 embeddings, fp32 from the first encoder layer on
    (attention promotes against the fp32 padding mask), in both."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import padding_bias

    jm, tm = _pair(JE.ErnieForSequenceClassification,
                   pm.ErnieForSequenceClassification, num_classes=3)
    paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    amp.decorate(tm, level="O2", dtype="bfloat16")
    ids, types, mask, tasks = _inputs()

    def outputs(model, wrap):
        e = model.ernie
        i, t, m, k = wrap(ids, types, mask, tasks)
        if isinstance(m, torch.Tensor):
            bias = padding_bias(m)
        else:
            bias = ((1.0 - m.astype("float32")) * -1e4).unsqueeze(1)
            bias = bias.unsqueeze(2)
        outs = [e.embeddings(i, t, None, k)]
        for layer in e.encoder.layers:
            outs.append(layer(outs[-1], src_mask=bias))
        outs.append(e.pooler(outs[-1]))
        outs.append(model.classifier(outs[-1]))
        return outs

    want = outputs(jm, _j)
    with torch.no_grad():
        got = outputs(tm, _t)
    assert [str(w.dtype) for w in want] == [
        "bfloat16", "float32", "float32", "float32", "float32"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert str(g.dtype) == "torch." + str(w.dtype), i
        w32 = np.asarray(w.astype("float32").numpy())
        np.testing.assert_allclose(g.float().numpy(), w32, rtol=0,
                                   atol=2 * BF16_STEP * np.abs(w32).max())


def test_data_collator_gives_jax_bits():
    rng = np.random.RandomState(3)
    jc = JE.ErnieDataCollator(VOCAB, seed=7)
    tc = pm.ErnieDataCollator(VOCAB, seed=7)
    for shape in ((4, 16), (2, 5), (3, 40)):
        batch = rng.randint(5, VOCAB, shape)
        (ids, labels), want = tc(batch), jc(batch)
        for a, b in zip((ids, labels), want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (labels != -100).sum() >= shape[0]
        np.testing.assert_array_equal(labels[labels != -100],
                                      batch[labels != -100])


def test_seeded_replay_at_the_default_dropout():
    cfg = dict(CFG, hidden_dropout=0.1, attention_dropout=0.1)
    tm = pm.ErnieForPretraining(pm.ErnieConfig(**cfg), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    tm.train()
    batch = (*_inputs(), *_labels())

    def loss():
        return float(_loss(tm, _t, *batch).detach())

    pt.seed(5)
    first = loss()
    pt.seed(5)
    assert loss() == first
    pt.seed(6)
    assert loss() != first
