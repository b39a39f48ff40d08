"""The 1 x 1 convolution's product route (``paddle_tpu_torch/nn/functional/
conv.py`` ``_pointwise``) against cuDNN's convolution, on the card.

These tests need an NVIDIA card (marker ``cuda``) and skip without one:

    python -m pytest --noconftest -q tests/test_torch_conv_route_cuda.py

At ShuffleNetV2 x1.0's 1 x 1 shapes in bf16 and fp16, channels-last: the
output, dx and dW of ``F.conv2d`` under layout autotune (which takes the
route) against ``torch.nn.functional.conv2d`` on the same tensors, within
one step of the type in relative L2 (both sum in fp32 and round each
output once); the route's output is channels-last. fp32, strided and
grouped convs, and layout autotune off stay on cuDNN.
"""
import contextlib

import pytest
import torch

from paddle_tpu_torch.framework.layout_autotune import (
    enable_layout_autotune)
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import conv

pytestmark = pytest.mark.cuda

_STEP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@contextlib.contextmanager
def _layout_autotune():
    enable_layout_autotune(True)
    try:
        yield
    finally:
        enable_layout_autotune(False)


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("c_in,c_out,hw", [(24, 58, 56), (58, 58, 28),
                                           (116, 116, 28), (116, 116, 14),
                                           (232, 232, 7), (464, 1024, 7)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_route_matches_cudnn_forward_and_backward(dev, c_in, c_out, hw,
                                                  dtype):
    gen = torch.Generator(device=dev).manual_seed(c_in * hw)
    cl = torch.channels_last
    x = torch.randn(16, c_in, hw, hw, generator=gen, device=dev).to(dtype)
    w = (torch.randn(c_out, c_in, 1, 1, generator=gen, device=dev)
         / c_in ** 0.5).to(dtype)
    g = torch.randn(16, c_out, hw, hw, generator=gen, device=dev).to(dtype)
    x, w, g = (t.contiguous(memory_format=cl) for t in (x, w, g))
    res = []
    for route in (True, False):
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        if route:
            with _layout_autotune():
                assert conv._pointwise_on_gemm(
                    xr, wr, (1, 1), ((0, 0), (0, 0)), 1, False, 2)
                out = PF.conv2d(xr, wr)
            assert out.is_contiguous(memory_format=cl)
        else:
            out = torch.nn.functional.conv2d(xr, wr)
        out.backward(g)
        res.append((out.detach(), xr.grad, wr.grad))
    for got, want in zip(*res):
        assert _rel(got, want) <= _STEP[dtype], _rel(got, want)


def test_route_leaves_fp32_and_other_convs_to_cudnn(dev):
    pads = ((0, 0), (0, 0))
    with _layout_autotune():
        x = torch.randn(2, 58, 4, 4, device=dev)
        w = torch.randn(58, 58, 1, 1, device=dev)
        assert not conv._pointwise_on_gemm(x, w, (1, 1), pads, 1, False, 2)
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        assert conv._pointwise_on_gemm(x, w, (1, 1), pads, 1, False, 2)
        assert not conv._pointwise_on_gemm(x, w, (2, 2), pads, 1, False, 2)
        assert not conv._pointwise_on_gemm(x, w[:, :29], (1, 1), pads, 2,
                                           False, 2)
    assert not conv._pointwise_on_gemm(x, w, (1, 1), pads, 1, False, 2)
