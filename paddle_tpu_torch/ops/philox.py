"""Philox4x32-10 and the attention keep-mask, in plain PyTorch.

The plain counterpart of ``csrc/philox.cuh``: the flash kernels K1-K3 and
K5/K6 draw their dropout keep-mask with the device function there, and
their plain versions draw it here, bit for bit the same (int64 arithmetic
on values below 2^32, so no product overflows).

The mask of one attention call depends only on (seed, batch, head, query
row, key column), never on a kernel's tiling, so every kernel of a forward
and backward pair regenerates the same bits:

* key: the two seed words ``(seed0, seed1)``
  (:func:`paddle_tpu_torch.framework.random.next_seed_words`);
* counter: ``(col >> 3, row, batch * heads + head, 0)``;
* bits: half-word ``col & 7`` of the four output words (word
  ``(col & 7) >> 1``, low half for even ``col``);
* keep: ``bits < keep_threshold(p)``, the TPU kernels' ``_keep_bits`` rule
  (``paddle_tpu/ops/pallas/flash_attention.py:100-113``), and a kept
  probability is scaled by ``1 / (1 - p)``.
"""
from __future__ import annotations

import torch

__all__ = ["philox4x32", "keep_threshold", "inv_keep", "keep_mask",
           "keep_mask_kernel", "kernel_args"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m, c):
    """``(hi, lo)`` 32-bit words of ``m * c`` for a constant ``m`` and a
    tensor ``c`` of values in ``[0, 2^32)``, through 16-bit limbs."""
    mh, ml = m >> 16, m & 0xFFFF
    ch, cl = c >> 16, c & 0xFFFF
    mid = mh * cl + ml * ch                      # < 2^33
    low = ml * cl + ((mid & 0xFFFF) << 16)       # < 2^33
    lo = low & _MASK32
    hi = (mh * ch + (mid >> 16) + (low >> 32)) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC 2011; Random123's ``philox4x32_R``
    at 10 rounds) of the counter words ``c0..c3`` (int64 tensors, or ints,
    in ``[0, 2^32)``, broadcast together) under the key ``(k0, k1)``;
    returns the four output words as int64 tensors."""
    dev = next((c.device for c in (c0, c1, c2, c3)
                if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev)
          for c in (c0, c1, c2, c3)))
    k0, k1 = int(k0) & _MASK32, int(k1) & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(p):
    """16-bit keep threshold of dropout rate ``p`` (JAX's ``_keep_bits``)."""
    return min(int((1.0 - float(p)) * 65536.0), 65535)


def inv_keep(p):
    """``1 / (1 - p)`` rounded to fp32, as the kernels and the TPU kernels
    (``p * (1.0 / (1.0 - dropout_p))`` on fp32 values) scale by it."""
    return torch.tensor(1.0 / (1.0 - float(p)), dtype=torch.float32).item()


def kernel_args(p, seed):
    """``(seed0, seed1, threshold, 1 / (1 - p))``, the dropout arguments of
    the attention kernels' C entry points; at p = 0 a threshold no 16-bit
    value is below, which selects the p = 0 kernels."""
    if not p:
        return (0, 0, 65536, 1.0)
    return (int(seed[0]) & _MASK32, int(seed[1]) & _MASK32, keep_threshold(p),
            inv_keep(p))


def keep_mask(seed, b, h, sq, sk, p, device="cpu"):
    """Boolean ``[b, h, sq, sk]`` keep-mask of one attention call keyed by
    ``seed`` (two words), ``True`` where a probability is kept."""
    thr = keep_threshold(p)
    groups = (sk + 7) // 8
    dev = torch.device(device)
    grp = torch.arange(groups, dtype=torch.int64, device=dev)
    row = torch.arange(sq, dtype=torch.int64, device=dev)[:, None]
    out = []
    for bb in range(b):                      # one batch at a time: memory
        bh = (bb * h + torch.arange(h, dtype=torch.int64, device=dev))
        words = philox4x32(grp, row, bh[:, None, None], 0, *seed)
        w = torch.stack(words, -1)                           # [h, sq, G, 4]
        bits = torch.stack((w & 0xFFFF, w >> 16), -1)        # [h, sq, G, 4, 2]
        out.append((bits.reshape(h, sq, groups * 8)[..., :sk] < thr))
    if not out:
        return torch.zeros((0, h, sq, sk), dtype=torch.bool, device=dev)
    return torch.stack(out)


def keep_mask_kernel(seed, b, h, sq, sk, p, device="cuda"):
    """The same mask drawn by the device Philox (``csrc/philox.cu``, a
    test-only launch on no main path), as bool ``[b, h, sq, sk]``."""
    from .cuda._build import check, library, stream_of

    mask = torch.empty((b, h, sq, sk), dtype=torch.uint8, device=device)
    check(library().ptt_philox_keep_mask(
        mask.data_ptr(), b, h, sq, sk, int(seed[0]) & _MASK32,
        int(seed[1]) & _MASK32, keep_threshold(p), stream_of(mask)),
        "philox_keep_mask")
    return mask.bool()
