// The tensor-core tile scheme of the bf16/fp16 flash attention kernels K1
// (forward, flash_attention.cu; it also runs the packed forward K5), K2 (dq,
// flash_attention_dq.cu) and K3 (dk/dv, flash_attention_dkv.cu).
//
// A CTA of 4 warps owns a 64-row tile (query rows in K1 and K2, keys in
// K3), 16 rows a warp, as one m16 row block of mma.sync m16n8k16
// (csrc/mma.cuh). The warp's own operand rows (q in K1; q and dout in K2; k
// and v in K3) are loaded once as A fragments and stay in registers; the
// streamed tiles (k and v in K1 and K2; q, dout and out in K3) sit in
// shared memory in their input type, each row
// padded by 16 bytes (row stride D + 8 elements: 208 bytes at d = 96), so
// the 8 row addresses of every ldmatrix fall in 8 different 16-byte bank
// groups for every instantiated head dim (16, 32, 64, 80, 96, 128)
// without a swizzle. Score tiles come out of the tensor cores as C fragments, which
// are also the A fragments of the next product once rounded to the input
// type (pack2): p and ds never go through shared memory.
#pragma once

#include "flash_tile.cuh"
#include "mma.cuh"

namespace ptt {
namespace flash {

constexpr int kBQ = 64;  // query rows a tile
constexpr int kBK = 64;  // keys a tile
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
static_assert(kTcWarps * 16 == kBQ && kBQ == kBK, "one m16 row block a warp");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// row stride, in elements, of a bf16/fp16 tile in shared memory
template <int D>
__host__ __device__ constexpr int tc_stride() {
  return D + 8;
}

// 2^x on the special-function unit (ex2.approx.ftz: ~2 ulp, denormal
// results flushed to 0); 2^(-1e30) and 2^(-inf) are 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A fragments of the warp's 16 rows r0 .. r0 + 15 of a tile (row stride S)
// over D = 16 KT columns
template <int KT, typename T>
__device__ __forceinline__ void load_a(uint32_t (&f)[KT][4], const T* tile, int r0,
                                       int S) {
  const int lane = threadIdx.x & 31;
  const T* p = tile + (r0 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) ldm_x4(f[kk], p + kk * 16);
}

// c[j] (16 x 8, j < NJ) += A . B^T over D = 16 KT: A the warp's fragments,
// B the rows n0 .. n0 + 8 NJ of a tile (row stride S, D contiguous)
template <typename T, int KT, int NJ>
__device__ __forceinline__ void mma_abt(float (&c)[NJ][4], const uint32_t (&a)[KT][4],
                                        const T* tile, int n0, int S) {
  static_assert(NJ % 2 == 0, "n8 tiles go in pairs");
  const int lane = threadIdx.x & 31;
  const T* p = tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t b[4];
      ldm_x4(b, p + jp * 16 * S + kk * 16);
      mma16816<T>(c[2 * jp], a[kk], b[0], b[1]);
      mma16816<T>(c[2 * jp + 1], a[kk], b[2], b[3]);
    }
}

// acc (16 x D as NT = D / 8 n8 tiles) += P . B: P the warp's 16 x 16 KS
// values as the C fragments of 2 KS n8 tiles, rounded to T here; B the rows
// k0 .. k0 + 16 KS of a tile (row stride S, D contiguous), read transposed
template <typename T, int KS, int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[NT][4], const float (&p)[2 * KS][4],
                                       const T* tile, int k0, int S) {
  const int lane = threadIdx.x & 31;
  const T* base = tile + (k0 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {pack2<T>(p[2 * kk][0], p[2 * kk][1]),
                           pack2<T>(p[2 * kk][2], p[2 * kk][3]),
                           pack2<T>(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack2<T>(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int cp = 0; cp < NT / 2; ++cp) {
      uint32_t b[4];
      ldm_x4_trans(b, base + kk * 16 * S + cp * 16);
      mma16816<T>(acc[2 * cp], a, b[0], b[1]);
      mma16816<T>(acc[2 * cp + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 8 NC: n8 tiles from column n0) += A . B over 16 KS: A the warp's
// rows r0 .. r0 + 15 of a tile stored transposed (at[k][row], row stride
// SA), read with ldmatrix.trans; B the rows 0 .. 16 KS of a tile (row
// stride S, columns contiguous), read transposed as in mma_pb. K6's dq =
// (ds * scale) k, with ds stored as key rows.
template <typename T, int KS, int NC>
__device__ __forceinline__ void mma_atb(float (&acc)[NC][4], const T* at, int r0, int SA,
                                        const T* tile, int n0, int S) {
  static_assert(NC % 2 == 0, "n8 tiles go in pairs");
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  // matrix mi of the x4 load: keys 8 (mi >> 1) .., rows 8 (mi & 1) ..
  const T* ap = at + ((mi >> 1) * 8 + (lane & 7)) * SA + r0 + (mi & 1) * 8;
  const T* bp = tile + (lane & 15) * S + n0 + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    ldm_x4_trans(a, ap + kk * 16 * SA);
#pragma unroll
    for (int cp = 0; cp < NC / 2; ++cp) {
      uint32_t b[4];
      ldm_x4_trans(b, bp + kk * 16 * S + cp * 16);
      mma16816<T>(acc[2 * cp], a, b[0], b[1]);
      mma16816<T>(acc[2 * cp + 1], a, b[2], b[3]);
    }
  }
}

// the warp's 16 x D accumulator, row g times mul[0] and row g + 8 times
// mul[1], into rows r0 + g and r0 + g + 8 of dst (row stride rs elements;
// rows >= n and columns >= dn are not written). Columns go in pairs with
// one 4-byte store where dn is even (every row offset is then even), one by
// one where it is odd.
template <typename T, int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], const float (&mul)[2],
                                          T* dst, long long rs, int r0, int n, int dn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool pairs = (dn & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
    T* d = dst + row * rs + 2 * t;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const int col = c * 8 + 2 * t;
      const float lo = acc[c][2 * r] * mul[r], hi = acc[c][2 * r + 1] * mul[r];
      if (pairs) {
        if (col < dn) *reinterpret_cast<uint32_t*>(d + c * 8) = pack2<T>(lo, hi);
      } else {
        if (col < dn) d[c * 8] = from_f32<T>(lo);
        if (col + 1 < dn) d[c * 8 + 1] = from_f32<T>(hi);
      }
    }
  }
}

}  // namespace flash
}  // namespace ptt
