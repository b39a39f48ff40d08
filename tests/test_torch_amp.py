"""``amp.decorate`` and ``amp.auto_cast`` of the port against the JAX
package's, on the CPU, on a 2-layer GPT holding the same weights: the
inputs' dtypes of every hooked op, one call after another, and the loss and
gradients of one forward and backward.

Op names: the JAX package runs its LayerNorm as ``layer_norm_op`` on the
CPU and the port as ``fused_layer_norm`` (the kernel wrapper's plain
version); both are on the black list and cast alike, so the sequences are
compared with that one name mapped.

Tolerances. O2: the LayerNorms stay fp32 and promote everything after them
to fp32 (the property of the reference kept by the port), so the loss is
fp32 arithmetic in another order, 1e-5 relative; the bf16 parameters'
gradients are fp32 sums rounded once to bf16, within one bf16 step of the
largest (2^-7 · max); the fp32 LayerNorm gradients sum terms that carry
those bf16 differences, 1e-3 · max. O1: matmuls, attention and gelu run in
bf16, and the JAX package rounds after every primitive of its gelu and
softmax where PyTorch's kernels round once, so the loss agrees to 2e-3
relative and the gradients only to 0.2 · max (a check of sign and size);
the dtypes agree exactly.
"""
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.ops import dispatch

import paddle_tpu_torch as pt
from paddle_tpu_torch.nn.functional import activation, attention, common, norm
from tests.torch_port_util import gpt_pair

_HOOKED = {"linear", "matmul", "sdpa", "flash_sdpa", "layer_norm_op",
           "fused_layer_norm", "softmax_op", "gelu"}
_SAME = {"fused_layer_norm": "layer_norm_op"}


def _jax_run(jm, ids, level):
    log = []
    with paddle.amp.auto_cast(level=level):
        inner = dispatch.AMP_HOOK

        def recording(name, fwd):
            if name in _HOOKED:
                op = fwd

                def fwd(*vals, **kw):
                    log.append((name, tuple(str(v.dtype) for v in vals
                                            if hasattr(v, "dtype"))))
                    return op(*vals, **kw)
            return inner(name, fwd)

        dispatch.AMP_HOOK = recording
        try:
            loss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
        finally:
            dispatch.AMP_HOOK = inner
    loss.backward()
    return float(loss), log


def _port_run(tm, ids, level, monkeypatch):
    log = []
    cast = sys.modules["paddle_tpu_torch.amp.auto_cast"].cast_inputs

    def recording(name, *vals):
        out = cast(name, *vals)
        log.append((_SAME.get(name, name),
                    tuple(str(v.dtype).replace("torch.", "") for v in out
                          if torch.is_tensor(v))))
        return out

    for mod in (activation, attention, common, norm):
        monkeypatch.setattr(mod, "_amp_cast", recording)
    with pt.amp.auto_cast(level=level):
        loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(ids))
    loss.backward()
    return float(loss.detach()), log


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate_and_auto_cast_match_jax(level, monkeypatch):
    jm, tm = gpt_pair(vocab=256, hidden=128, layers=2, heads=2)
    jm.train()
    tm.train()
    jopt = paddle.optimizer.AdamW(parameters=jm.parameters())
    topt = pt.optimizer.AdamW(parameters=tm.parameters())
    if level == "O2":
        paddle.amp.decorate(jm, jopt, level="O2")
        _, out = pt.amp.decorate(tm, topt, level="O2")
        assert out is topt and topt._multi_precision
    ids = np.random.RandomState(0).randint(0, 256, (2, 32)).astype(np.int64)
    jloss, jlog = _jax_run(jm, ids, level)
    tloss, tlog = _port_run(tm, ids, level, monkeypatch)
    assert tlog == jlog
    # the reference's first ops (GPT block 0): under O2 the LayerNorm runs
    # fp32 and the linear after it promotes against its bf16 weight
    first_linear = ("float32", "bfloat16", "bfloat16") if level == "O2" else (
        "bfloat16",) * 3
    assert tlog[:2] == [("layer_norm_op", ("float32",) * 3),
                        ("linear", first_linear)]
    np.testing.assert_allclose(tloss, jloss,
                               rtol=1e-5 if level == "O2" else 2e-3)
    jparams = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        jp = jparams[name]
        assert str(p.dtype).replace("torch.", "") == str(jp._value.dtype)
        assert p.grad.dtype == p.dtype, name
        want = np.asarray(jnp.asarray(jp.grad._value, jnp.float32))
        err = np.abs(p.grad.float().numpy() - want).max()
        big = np.abs(want).max()
        if level == "O1":
            tol = 0.2 * big
        elif p.dtype == torch.bfloat16:
            tol = 2.0 ** -7 * big
        else:
            tol = 1e-3 * big
        assert err <= tol, (name, err, big)


def test_decorate_keeps_norms_fp32_and_auto_cast_custom_lists():
    _, tm = gpt_pair(vocab=64, hidden=128, layers=1, heads=2)
    pt.amp.decorate(tm, level="O2")
    for name, p in tm.named_parameters():
        want = torch.float32 if ".ln_" in name else torch.bfloat16
        assert p.dtype == want, name
    a = torch.randn(4, 4)
    with pt.amp.auto_cast(level="O1"):
        assert pt.nn.functional.matmul(a, a).dtype == torch.bfloat16
        assert pt.nn.functional.softmax(a.bfloat16()).dtype == torch.float32
    with pt.amp.auto_cast(level="O1", custom_black_list={"matmul"}):
        assert pt.nn.functional.matmul(a.bfloat16(), a).dtype == torch.float32
    with pt.amp.auto_cast(level="O1", custom_white_list={"softmax_op"}):
        assert pt.nn.functional.softmax(a).dtype == torch.bfloat16
    with pt.amp.auto_cast(enable=False):
        assert pt.nn.functional.matmul(a, a).dtype == torch.float32
    assert pt.nn.functional.matmul(a, a).dtype == torch.float32
    with pytest.raises(ValueError, match="O0, O1 or O2"):
        with pt.amp.auto_cast(level="O3"):
            pass
