"""``paddle.incubate.autotune`` — port of ``paddle_tpu/incubate/autotune.py``.

``set_config`` maps the reference's sections as the JAX package does:
``kernel`` toggles the flash-attention route (``enable: False`` sets
``FLAGS_disable_flash_attention``), ``layout`` toggles layout autotune
(channels-last convolutions, ``framework/layout_autotune.py``), and
``dataloader`` is recorded (the port has no DataLoader workers to tune).
cuDNN's own algorithm search is ``torch.backends.cudnn.benchmark``, which the
caller sets.
"""
from __future__ import annotations

import json

from ..framework.flags import set_flags
from ..framework.layout_autotune import enable_layout_autotune

__all__ = ["set_config", "get_status"]

_STATUS = {"kernel": {"enable": True}, "layout": {"enable": False},
           "dataloader": {"enable": False}}


def set_config(config=None):
    """Takes the reference's dict or a JSON file path; ``None`` resets every
    section to its default."""
    if config is None:
        _STATUS["kernel"]["enable"] = True
        _STATUS["layout"]["enable"] = False
        _STATUS["dataloader"]["enable"] = False
        set_flags({"disable_flash_attention": False})
        enable_layout_autotune(False)
        return
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise TypeError("set_config expects None, a dict, or a JSON path")
    for key in config:
        if key not in _STATUS:
            raise ValueError(f"unknown autotune section {key!r}")
        _STATUS[key].update(config[key] or {})
    if _STATUS["kernel"].get("enable") is False:
        set_flags({"disable_flash_attention": True})
    elif "kernel" in config:
        set_flags({"disable_flash_attention": False})
    if "layout" in config:
        enable_layout_autotune(bool(_STATUS["layout"].get("enable")))


def get_status():
    return {k: dict(v) for k, v in _STATUS.items()}
