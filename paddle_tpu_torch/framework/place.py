"""Places and the current device — port of ``paddle_tpu/framework/place.py``.

The port runs on a CUDA card unless the caller asks for the CPU. The
current place starts as ``gpu:0``; ``set_device("cpu")`` moves it to the
host. Where the JAX package falls back to the CPU when it finds no
accelerator, the port never does: asking for a card that is not there
raises, in ``set_device`` and wherever the current place is used
(``to_tensor``, the creation ops, a Layer or model built without a
``device``).
"""
from __future__ import annotations

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "set_device", "get_device", "is_compiled_with_cuda",
           "device_count", "resolve_device", "current_device"]


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; call set_device('cpu') or pass "
            "device='cpu' to run the port on the CPU")


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def torch_device(self):
        raise NotImplementedError


class CPUPlace(Place):
    device_type = "cpu"

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self):
        _require_cuda()
        return torch.device("cuda", self.device_id)


class CUDAPinnedPlace(CPUPlace):
    """Host memory; tensors on it are plain CPU tensors here."""


_current = CUDAPlace(0)

_GPU_NAMES = ("gpu", "cuda")


def place_of(device):
    """The :class:`Place` of a ``torch.device`` (or a device string)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return CUDAPlace(dev.index or 0)
    return CPUPlace(0)


def _parse(device):
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return place_of(device)
    name, _, idx = str(device).partition(":")
    idx = int(idx) if idx else 0
    if name == "cpu":
        return CPUPlace(idx)
    if name in _GPU_NAMES:
        return CUDAPlace(idx)
    raise ValueError(f"unknown device {device!r}: the port runs on 'cpu' "
                     "or 'gpu[:n]'")


def set_device(device) -> Place:
    """``paddle.set_device('gpu' | 'gpu:1' | 'cpu')``. A GPU place raises
    when there is no card."""
    global _current
    place = _parse(device)
    if isinstance(place, CUDAPlace):
        _require_cuda()
        if place.device_id >= torch.cuda.device_count():
            raise ValueError(f"{device!r}: this host has "
                             f"{torch.cuda.device_count()} cards")
    _current = place
    return place


def get_device() -> str:
    return f"{_current.device_type}:{_current.device_id}"


def current_device():
    """The current place as a ``torch.device`` (raises for a GPU place
    without a card)."""
    return _current.torch_device()


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def device_count() -> int:
    return torch.cuda.device_count()


def resolve_device(device=None):
    """``None`` means the current place. Returns a ``torch.device`` (a CUDA
    device with its index, so it compares equal to a tensor's ``.device``);
    raises ``RuntimeError`` when CUDA is asked for and there is no card."""
    if device is None:
        return current_device()
    if isinstance(device, Place):
        return device.torch_device()
    dev = torch.device("cuda" if device in _GPU_NAMES else device)
    if dev.type == "cuda":
        _require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
