"""Layout autotune — a copy of ``paddle_tpu/framework/layout_autotune.py``
(which imports no JAX), kept here so the port imports nothing of the JAX
package.

When it is on, ``nn.functional.conv*d`` runs an NCHW (NCDHW) convolution in
``torch.channels_last`` (``channels_last_3d``) memory format, and conv
layers built while it is on keep their weights in that format. The tensor's
logical shape stays NCHW; only its strides change, so cuDNN takes its NHWC
kernels and the convolutions after it receive channels-last activations
without a transpose. This is the counterpart of the JAX package's
transpose → NHWC conv → transpose. Turn it on with
``paddle_tpu_torch.incubate.autotune.set_config({"layout": {"enable":
True}})``.
"""
from __future__ import annotations

_enabled = False


def enable_layout_autotune(flag=True):
    global _enabled
    _enabled = bool(flag)


def layout_autotune_enabled():
    return _enabled
