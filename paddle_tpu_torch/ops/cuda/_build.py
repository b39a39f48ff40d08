"""Build and load the port's hand-written CUDA kernels.

At first use every ``paddle_tpu_torch/csrc/*.cu`` is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per
source, all started together, then linked into one shared library under
``paddle_tpu_torch/ops/cuda/_build/`` (named by a hash of the sources and
flags, so an edited source rebuilds). The library has a plain C
interface and is loaded with ``ctypes``: no PyTorch headers are compiled,
which keeps the build to seconds.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0. A failed
build raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "check", "stream_of", "build_info", "dtype_code",
           "needs_grad"]

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_OUT = Path(__file__).resolve().parent / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
_info = {}

p = ctypes.c_void_p
i32 = ctypes.c_int
i64 = ctypes.c_longlong
u32 = ctypes.c_uint
f32 = ctypes.c_float

#: the attention kernels' trailing arguments: scale, causal, the dropout
#: seed words, keep threshold and 1 / (1 - p), dtype, stream
_ATTN_TAIL = [f32, i32, u32, u32, u32, f32, i32, p]

#: C signatures of every entry point in csrc/
_SIGNATURES = {
    # x, gamma, beta, y, rows, features, eps, x_dtype, w_dtype, stream
    "ptt_layer_norm_fwd": [p, p, p, p, i32, i32, f32, i32, i32, p],
    # x, gamma, dy, dx, dgamma, dbeta, partials, parts, rows, features, eps,
    # x_dtype, w_dtype, stream
    "ptt_layer_norm_bwd": [p, p, p, p, p, p, p, i32, i32, i32, f32, i32, i32,
                           p],
    # b, sq, sk, h, d, dtype, out: route, key parts, workspace floats
    "ptt_flash_attention_cached_plan": [i32] * 6 + [p] * 3,
    # q, k, v, q_pos, kv_len, out, split workspace, its floats, out: the
    # split kernel's CTAs, b, sq, sk, h, d, q strides (b, s, h), k strides,
    # v strides, scale, dtype, stream
    "ptt_flash_attention_cached_fwd": (
        [p] * 7 + [i64, p] + [i32] * 5 + [i64] * 9 + [f32, i32, p]),
    # q, k, v, bias, out, lse, b, sq, sk, h, d, q/k/v strides (b, s, h),
    # bias strides (b, h, row), scale, causal, dropout, dtype, stream (K1,
    # and the packed forward K5 on its strides)
    "ptt_flash_attention_fwd": [p] * 6 + [i32] * 5 + [i64] * 12 + _ATTN_TAIL,
    # q, k, v, bias, out, dout, lse, dq, b, sq, sk, h, d, strides as above,
    # scale, causal, dropout, dtype, stream
    "ptt_flash_attention_bwd_dq": [p] * 8 + [i32] * 5 + [i64] * 12 + _ATTN_TAIL,
    # q, k, v, bias, out, dout, lse, dk, dv, b, sq, sk, h, d, strides as
    # above, scale, causal, dropout, dtype, stream
    "ptt_flash_attention_bwd_dkv": [p] * 9 + [i32] * 5 + [i64] * 12 + _ATTN_TAIL,
    # q, k, v, bias, out, dout, lse, delta, dq workspace, dq, dk, dv,
    # b, sq, sk, h, d, strides as K1's (the packed views' (b, s) strides and
    # head stride d; the shared bias's 0, 0, sk), scale, causal, dropout,
    # dtype, stream
    "ptt_flash_attention_packed_bwd": (
        [p] * 12 + [i32] * 5 + [i64] * 12 + _ATTN_TAIL),
    # x, w, bias, label, loss, lse, tokens, vocab, hidden, dtype, stream
    "ptt_fused_ce_fwd": [p] * 6 + [i32] * 4 + [p],
    # x, w, bias, label, g, lse, out, db, tokens, vocab, hidden, mode,
    # round_dl, dtype, stream
    "ptt_fused_ce_bwd": [p] * 8 + [i32] * 6 + [p],
    # mask, b, h, sq, sk, seed0, seed1, threshold, stream
    "ptt_philox_keep_mask": [p, i32, i32, i32, i32, u32, u32, u32, p],
}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build():
    sources = sorted(_CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for src in sources + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    tag = h.hexdigest()[:16]
    so = _OUT / f"libptt_kernels_{tag}.so"
    if so.exists():
        _info.update(path=str(so), seconds=0.0, cached=True, log="")
        return so
    _OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        # per-process object names: processes that build at once (pytest
        # workers) never write one file together
        obj = _OUT / f"{src.stem}_{tag}.{os.getpid()}.o"
        cmd = [nvcc, *_ARCH, *_FLAGS, "-c", str(src), "-o", str(obj)]
        # the report goes to a file, so no pipe fills while another
        # process is waited on
        out = open(obj.with_suffix(".log"), "w+")
        procs.append((src, obj, out, subprocess.Popen(
            cmd, stdout=out, stderr=subprocess.STDOUT)))
    # each source's wall time until its nvcc ended (they run at once)
    per_source = {}
    while len(per_source) < len(procs):
        for src, _, _, proc in procs:
            if src.name not in per_source and proc.poll() is not None:
                per_source[src.name] = round(time.perf_counter() - t0, 1)
        time.sleep(0.05)
    log = []
    failed = []
    for src, obj, out, proc in procs:
        out.seek(0)
        log.append(f"== {src.name}\n{out.read()}")
        out.close()
        os.remove(out.name)
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(
            f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *_ARCH, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the CUDA kernels failed:\n{link.stdout}")
    os.replace(tmp, so)
    _info.update(path=str(so), seconds=time.perf_counter() - t0,
                 cached=False, log="\n".join(log), per_source=per_source)
    return so


def library():
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_info():
    """``{"path", "seconds", "cached", "log", "per_source"}`` of the build
    this process loaded (empty before the first :func:`library` call).
    ``log`` holds nvcc's ``-Xptxas -v`` report: registers, shared memory,
    spills; ``per_source`` the seconds from the start until each source's
    nvcc ended (all start together)."""
    return dict(_info)


def check(err, what):
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def dtype_code(dtype):
    """The C-side code of a torch dtype (csrc/common.cuh ``ptt::DType``);
    raises for a type no kernel takes."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise TypeError(f"no CUDA kernel takes {dtype}")
    return codes[dtype]


def stream_of(t):
    """The current CUDA stream of tensor ``t``'s device, as an int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def needs_grad(*tensors):
    """Whether autograd would record a call on ``tensors``: grad mode is on
    and one of them requires grad."""
    import torch

    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
