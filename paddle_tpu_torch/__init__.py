"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

``import paddle_tpu_torch as paddle`` gives the Paddle API on the card:
``paddle.set_device("gpu")`` (the default; ``"cpu"`` for the host),
``paddle.to_tensor``, the ``paddle.*`` tensor ops and the Tensor methods,
``paddle.grad`` / ``no_grad`` / ``autograd.PyLayer``, ``nn.Layer`` and its
containers, ``ParamAttr`` and the initializers, ``paddle.save`` /
``paddle.load``. A Tensor is a ``torch.Tensor`` subclass with Paddle's
methods; plain tensor code is PyTorch. Every Pallas TPU kernel on a ported
path is a hand-written CUDA kernel for Hopper (``csrc/``, built at first use
by ``ops/cuda/_build.py``). Entry points run on ``cuda`` unless the caller
sets the CPU (``set_device("cpu")`` or ``device="cpu"``).

The port covers GPT serving (``models.GPTForCausalLM``,
``serving.GenerationEngine`` and ``serving.Scheduler``) and GPT training:
``GPTForCausalLM.loss`` (the chunked fused loss, or the flash-CE kernels
under ``FLAGS_enable_flash_ce``), the optimizers with LR schedulers,
gradient clipping and regularizers, ``amp`` (``auto_cast``, ``decorate``,
``GradScaler``) and ``io.DeviceLoader``; and the encoder family:
``nn.Transformer`` and its layers, BERT (``models.BertForPretraining``,
``BertForSequenceClassification`` behind ``serving.EncoderScorer``) and
ERNIE (``models.ErnieForPretraining`` and its heads); and the vision path:
``vision.models`` (LeNet, the ResNet family) on ``nn``'s convolutions, batch
norms and pooling, with ``incubate.autotune``'s layout autotune
(channels-last convolutions); and the training runtime: ``paddle.Model``
(``prepare``/``fit``/``evaluate``/``predict`` with callbacks and
``paddle.metric``), ``paddle.io``'s ``DataLoader`` with its worker
processes, ``paddle.fault``'s checkpoint/resume, ``summary``/``flops`` and
``paddle.batch``. It imports neither ``jax`` nor ``paddle_tpu``.
"""
from __future__ import annotations

import numpy as _np
import torch as _torch

__version__ = "0.1.0"

from .framework.dtype import (  # noqa: F401
    bfloat16,
    bool_,
    complex64,
    complex128,
    float16,
    float32,
    float64,
    get_default_dtype,
    int8,
    int16,
    int32,
    int64,
    set_default_dtype,
    uint8,
)
from .framework.dtype import bool_ as bool  # noqa: F401,A001

#: ``paddle.dtype``: dtypes are torch dtypes here
dtype = _torch.dtype

from .framework.place import (  # noqa: E402,F401
    CPUPlace,
    CUDAPinnedPlace,
    CUDAPlace,
    device_count,
    get_device,
    is_compiled_with_cuda,
    set_device,
)
from .framework.random import (  # noqa: E402,F401
    get_cuda_rng_state, get_rng_state, seed, set_cuda_rng_state,
    set_rng_state)
from .framework.flags import get_flags, set_flags  # noqa: E402,F401
from .framework.tensor import (Parameter, Tensor, is_tensor,  # noqa: E402,F401
                               to_tensor)

# the tensor-op surface (also installs the Tensor methods)
from .ops import *  # noqa: E402,F401,F403
from .ops import add_n, einsum, fill_, zero_  # noqa: E402,F401
from .ops.random import (  # noqa: E402,F401
    bernoulli,
    multinomial,
    normal,
    poisson,
    rand,
    randint,
    randint_like,
    randn,
    randperm,
    standard_normal,
    uniform,
)

from .autograd import (enable_grad, grad, no_grad,  # noqa: E402,F401
                       set_grad_enabled)
from . import autograd  # noqa: E402,F401

from . import (amp, framework, incubate, io, models, nn,  # noqa: E402,F401
               ops, optimizer, regularizer, serving, vision)
from . import fault, hapi, metric, reader  # noqa: E402,F401
from . import callbacks  # noqa: E402,F401
from .batch import batch  # noqa: E402,F401
from .hapi.model import Model  # noqa: E402,F401
from .hapi.model_summary import flops, summary  # noqa: E402,F401
from .nn.layer.container import (LayerDict, LayerList,  # noqa: E402,F401
                                 ParameterList, Sequential)
from .nn.layer.layers import ParamAttr  # noqa: E402,F401
from .framework.io import load, save  # noqa: E402,F401


def in_dynamic_mode():
    """Always true: the static Program waits for ``ROADMAP.md`` A10."""
    return True


def is_grad_enabled():
    return _torch.is_grad_enabled()


def set_grad_enabled_ctx(mode):
    return set_grad_enabled(mode)


def set_printoptions(**kwargs):
    keep = {k: v for k, v in kwargs.items()
            if k in ("precision", "threshold", "edgeitems", "linewidth")}
    _np.set_printoptions(**keep)
    _torch.set_printoptions(**keep)


def check_shape(shape):
    """Validate a shape spec: ints or a 1-D integer Tensor; -1 is the
    dynamic marker."""
    if isinstance(shape, _torch.Tensor):
        if shape.ndim != 1:
            raise TypeError("shape tensor must be 1-D")
        return
    for s_ in shape:
        if not isinstance(s_, int) or (s_ < 0 and s_ != -1):
            raise TypeError(
                f"shape entries must be non-negative ints or -1, got {s_!r}")


def disable_signal_handler():
    """Kept for call-site compatibility: the port installs no fault-signal
    handlers."""
    return None


def is_compiled_with_tpu():
    return False
