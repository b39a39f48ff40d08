// Philox4x32-10 and the attention dropout keep-mask of the flash kernels
// K1-K3 (flash_attention.cu) and K5/K6 (flash_attention_packed.cu).
//
// Replaces the TPU kernels' hardware PRNG draws
// (paddle_tpu/ops/pallas/flash_attention.py::_dropout_mask, ::_keep_bits and
// flash_attention_packed.py::_drop). Written out here rather than taken from
// curand so that the plain versions (paddle_tpu_torch/ops/philox.py)
// reproduce the bits exactly.
//
// The mask depends only on (seed, batch, head, query row, key column), not
// on a kernel's tiling: key (seed0, seed1), counter (col >> 3, row,
// batch * heads + head, 0), and half-word col & 7 of the four output words
// is the element's 16 random bits. An element is kept when its bits are
// below thr = min(int((1 - p) * 65536), 65535) (the TPU kernels' rule); a
// kept probability is scaled by 1 / (1 - p). One Philox call gives the keep
// bits of 8 neighbouring columns of one row: keep_byte returns them as a
// byte, bit e for column 8 * group + e.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ptt {

// what a kernel needs to regenerate the mask of its (batch, head) slice
struct Dropout {
  uint32_t k0, k1;   // the seed words
  uint32_t thr;      // keep when bits < thr
  float inv_keep;    // 1 / (1 - p)
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// keep bits of columns 8 * group .. 8 * group + 7 of `row` in slice bh
// (batch * heads + head): bit e set when column 8 * group + e is kept
__device__ __forceinline__ uint32_t keep_byte(const Dropout& dp, uint32_t group,
                                              uint32_t row, uint32_t bh) {
  const uint4 w = philox4x32_10(make_uint4(group, row, bh, 0u), dp.k0, dp.k1);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  uint32_t byte = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    byte |= static_cast<uint32_t>(((words[e >> 1] >> (16 * (e & 1))) & 0xFFFFu) < dp.thr)
            << e;
  return byte;
}

// a kept probability times 1 / (1 - p), a dropped one 0
__device__ __forceinline__ float drop(const Dropout& dp, uint32_t byte, int bit, float x) {
  return (byte >> bit) & 1u ? x * dp.inv_keep : 0.f;
}

}  // namespace ptt
