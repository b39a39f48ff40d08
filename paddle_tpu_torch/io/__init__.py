"""Data input of the port (``paddle_tpu/io``: the device staging loader)."""
from .device_loader import DeviceLoader  # noqa: F401

__all__ = ["DeviceLoader"]
