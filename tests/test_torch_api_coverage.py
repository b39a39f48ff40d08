"""The port's Paddle-API surface against the JAX package's: every public
callable and class at the top level of ``paddle_tpu`` exists in
``paddle_tpu_torch`` or stands below beside the queue item
(``ROADMAP.md`` A) it waits for; the same for the Tensor's methods. The
positional parameters of every callable the two share (top level, ``nn``,
``nn.functional``) are the JAX package's, bar the differences named below:
the port takes no parameter that the JAX package lacks and then ignores."""
import inspect
import types

import torch

import paddle_tpu as jp

import paddle_tpu_torch as pt

#: top-level names still to port, by queue item
WAITING = {
    "DataParallel": "A8 (distributed)",
    "enable_static": "A10 (static)",
    "disable_static": "A10 (static)",
    "TPUPlace": "none: the port has no TPU (ROADMAP.md C)",
    "NPUPlace": "none: the port has no NPU (ROADMAP.md C)",
    "XPUPlace": "none: the port has no XPU (ROADMAP.md C)",
}

#: Tensor attributes of the JAX package that the port does not carry
TENSOR_WAITING = {
    "apply_nondiff_op": "an internal helper the JAX package leaks as a "
                        "method; paddle.apply_nondiff_op exists",
    "to_tensor": "the same leak; paddle.to_tensor exists",
    "is_leaf_param": "the JAX tape's flag; a Parameter is the port's leaf",
}


#: shared callables whose positional parameters differ from the JAX package's
SIGNATURE_DIFFERS = {
    "paddle.Parameter": "a torch.nn.Parameter (data, requires_grad); "
                        "ROADMAP.md C",
    "paddle.Tensor": "a torch.Tensor subclass; to_tensor builds one",
    "paddle.angle": "Paddle's angle(x); the JAX package shows jnp.angle's "
                    "(z, deg) and passes x only",
    "paddle.imag": "Paddle's imag(x); the JAX package shows jnp.imag's (val)",
    "paddle.assign": "Paddle's assign(x, output): output is written",
    "paddle.fill_": "the Tensor method as a function: x names the tensor "
                    "(self in the JAX package)",
    "paddle.zero_": "as fill_",
    "paddle.op": "the op decorator: nondiff in place of the tape's "
                 "inplace_of",
    "F.relu": "Paddle's relu(x, name); name is ignored, as everywhere",
}


def _positional(f):
    sig = inspect.signature(f.__init__ if inspect.isclass(f) else f)
    return [n for n, p in sig.parameters.items() if n != "self" and p.kind in (
        inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD)]


def test_shared_callables_take_the_jax_packages_positional_parameters():
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as JF

    import paddle_tpu_torch.nn as pnn
    import paddle_tpu_torch.nn.functional as PF

    differ, checked = {}, 0
    for label, jm, pm in (("paddle", jp, pt), ("nn", jnn, pnn),
                          ("F", JF, PF)):
        for n in _public_callables(pm):
            if not callable(getattr(jm, n, None)):
                continue
            try:
                want, got = _positional(getattr(jm, n)), _positional(
                    getattr(pm, n))
            except (TypeError, ValueError):  # no signature (a torch dtype)
                continue
            checked += 1
            if want != got:
                differ[f"{label}.{n}"] = (want, got)
    assert sorted(differ) == sorted(SIGNATURE_DIFFERS), differ
    assert checked >= 300, checked


def _public_callables(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and callable(getattr(mod, n))
                  and not isinstance(getattr(mod, n), types.ModuleType))


def test_every_top_level_callable_exists_or_waits():
    names = _public_callables(jp)
    missing = [n for n in names if not hasattr(pt, n)]
    assert sorted(missing) == sorted(WAITING)
    present = [n for n in names if hasattr(pt, n)]
    assert len(present) >= 300, len(present)
    for n in present:
        # the dtype names are numpy types in JAX, torch dtypes here
        v = getattr(pt, n)
        assert callable(v) or isinstance(v, torch.dtype), n


def test_every_tensor_method_exists_or_waits():
    names = sorted(n for n in dir(jp.Tensor) if not n.startswith("_"))
    missing = [n for n in names if not hasattr(pt.Tensor, n)]
    assert sorted(missing) == sorted(TENSOR_WAITING)


def test_the_port_imports_neither_jax_nor_the_jax_package():
    import subprocess
    import sys

    code = ("import sys, paddle_tpu_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'paddle_tpu.')) or m == 'paddle_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True)
