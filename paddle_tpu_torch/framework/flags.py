"""Global flags registry — ``set_flags`` / ``get_flags`` / ``flag_value``.

Port of ``paddle_tpu/framework/flags.py`` with only the flags the serving
and training paths read. Environment ``FLAGS_<name>`` values seed the defaults at
import, as in the JAX package. No flag binds to a backend config here:
the routing flags are read by ``nn.functional.attention`` at call time.
"""
from __future__ import annotations

import os

__all__ = ["set_flags", "get_flags", "register_flag", "flag_value"]


class _Flag:
    __slots__ = ("name", "default", "value", "typ", "help")

    def __init__(self, name, default, typ=None, help=""):
        self.name = name
        self.typ = typ or type(default)
        self.default = default
        self.help = help
        env = os.environ.get(f"FLAGS_{name}")
        self.value = self._coerce(env) if env is not None else default

    def _coerce(self, v):
        if self.typ is bool:
            if isinstance(v, str):
                return v.lower() not in ("0", "false", "")
            return bool(v)
        return self.typ(v)


_REGISTRY: dict[str, _Flag] = {}


def register_flag(name, default, typ=None, help=""):
    f = _Flag(name, default, typ, help)
    _REGISTRY[name] = f
    return f


def flag_value(name):
    """Internal fast read used by subsystems."""
    f = _REGISTRY.get(name)
    return f.value if f is not None else None


def set_flags(flags):
    """``flags``: a dict of ``{flag_name: value}``."""
    if not isinstance(flags, dict):
        raise TypeError("set_flags expects a dict of {flag_name: value}")
    for name, value in flags.items():
        f = _REGISTRY.get(name)
        if f is None:
            raise ValueError(f"unknown flag {name!r}; known: {sorted(_REGISTRY)}")
        f.value = f._coerce(value)


def get_flags(flags):
    """Name or list of names -> dict."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for name in names:
        f = _REGISTRY.get(name)
        if f is None:
            raise ValueError(f"unknown flag {name!r}")
        out[name] = f.value
    return out


register_flag("disable_flash_attention", False,
              help="route uncached sdpa to the dense path")
register_flag("flash_attention_block_q", 0,
              help="the JAX package's flash q block override; accepted so "
                   "FLAGS_ settings carry over, the CUDA kernels' tiles "
                   "are fixed")
register_flag("flash_attention_block_k", 0,
              help="the JAX package's flash k block override; accepted so "
                   "FLAGS_ settings carry over, the CUDA kernels' tiles "
                   "are fixed")
register_flag("flash_attention_bwd_block", 0,
              help="the JAX package's packed flash backward block override; "
                   "accepted so FLAGS_ settings carry over, the CUDA "
                   "kernels' tiles are fixed")
register_flag("enable_flash_ce", False,
              help="route fused_linear_cross_entropy to the flash-CE "
                   "kernels K9-K11 (their plain versions on the CPU) when "
                   "the hidden size is a multiple of 128")
register_flag("flash_attention_min_seq_prod", 1024 * 1024,
              help="uncached sdpa takes the dense path below this sq*sk")
register_flag("disable_blockwise_attention", False,
              help="route length-masked/long-causal sdpa to the dense "
                   "path (debugging / parity bisection)")
register_flag("blockwise_attention_min_kv", 1024,
              help="KV length at/above which sdpa takes the blockwise "
                   "online-softmax loop on the CPU")
register_flag("blockwise_attention_block_q", 512,
              help="query block of the blockwise path (largest divisor "
                   "of seq_q <= this is used)")
register_flag("blockwise_attention_block_k", 512,
              help="KV block of the blockwise loop (largest divisor of "
                   "seq_k <= this is used)")
register_flag("check_nan_inf", False,
              help="scan every output of a paddle op for Inf/NaN and raise "
                   "(a host sync an op)")
