// What the layout-swapping flash attention kernels K1 (flash_attention.cu),
// K2 (flash_attention_dq.cu) and K3 (flash_attention_dkv.cu) share: their
// arguments, the (batch, head) slice a CTA works on, the loads of a query
// tile and of a k/v tile, the tensor-core pieces of the kernels whose warp
// rows are query rows (K1 and K2: the k/v ring, the keep bits of a warp's
// rows, the logits of a score fragment), the instantiated widths and the
// launch checks. Each kernel has its own translation unit so that nvcc
// builds the three in parallel.
#pragma once

#include <math_constants.h>

#include <cstdint>

#include "flash_mma.cuh"

namespace ptt {
namespace {

using namespace flash;

struct Args {
  const void *q, *k, *v;
  const float* bias;          // nullptr: no bias
  int b, sq, sk, h, dn;       // dn: the data's head dim (<= the width D)
  long long qs[3], ks[3], vs[3];  // (batch, seq, head) strides, in elements
  long long bs[3];                // bias (batch, head, row) strides
  float scale;
  int causal;
  Dropout drp;
};

// the (batch, head) slices of q, k and v a CTA works on, and its logits
template <typename T>
struct Slice {
  const T *q, *k, *v;
  Logits lg;
  __device__ Slice(const Args& a, int bb, int hh)
      : q(static_cast<const T*>(a.q) + bb * a.qs[0] + hh * a.qs[2]),
        k(static_cast<const T*>(a.k) + bb * a.ks[0] + hh * a.ks[2]),
        v(static_cast<const T*>(a.v) + bb * a.vs[0] + hh * a.vs[2]),
        lg{a.sq, a.sk, a.causal, a.scale,
           a.bias == nullptr ? nullptr : a.bias + bb * a.bs[0] + hh * a.bs[1],
           a.bs[2]} {}
};

// the q and dout rows of the query tile at q0 (0 past sq), their lse
// (-1e30 past sq) and delta = rowsum(dout * out); out and dout contiguous
// at row stride hd
template <typename T, int D, int M>
__device__ __forceinline__ void load_q_tile(const T* qb, long long qss, const T* ob,
                                            const T* gb, long long hd, const float* lb,
                                            int q0, int sq, int dn, float* qs, float* gs,
                                            float* ls, float* dl) {
  load_rows<T, D, M>(qb, qss, q0, sq, dn, 1.f, qs);
  load_rows<T, D, M>(gb, hd, q0, sq, dn, 1.f, gs);
  const int t = threadIdx.x;
  if (t < Tile<M>::B) ls[t] = q0 + t < sq ? lb[q0 + t] : kNegInf;
  row_delta<T, M>(ob, gb, hd, q0, sq, dn, dl);
}

// 64 rows r0.. of a tensor-core tile operand (row stride rs, n rows) into
// dst at row stride tc_stride: with cp.async when `vec` (whole rows of
// aligned views), else with plain loads that zero-fill the columns past the
// head dim
template <typename T, int D>
__device__ __forceinline__ void tile_rows(T* dst, const T* src, long long rs, int r0,
                                          int n, const Args& a, bool vec) {
  copy_rows(dst, tc_stride<D>(), src, rs, r0, kBK, n, D, kTcThreads, vec, a.dn);
}

// keys k0 .. k0 + kBK of k and v into kdst and vdst (row stride tc_stride)
template <typename T, int D>
__device__ __forceinline__ void load_kv_rows(const Slice<T>& in, const Args& a, int k0,
                                             bool vec, T* kdst, T* vdst) {
  tile_rows<T, D>(kdst, in.k, a.ks[1], k0, a.sk, a, vec);
  tile_rows<T, D>(vdst, in.v, a.vs[1], k0, a.sk, a, vec);
}

// ---------------------------------------------------------------------------
// the tensor-core kernels whose warp rows are query rows (K1, K2)
// ---------------------------------------------------------------------------
// a two-stage ring of (k tile, v tile) in the input type
template <typename T, int D>
__host__ __device__ constexpr int qrow_ring_bytes() {
  return 2 * 2 * kBK * tc_stride<D>() * static_cast<int>(sizeof(T));
}

// the keep bits of a warp: its 16 query rows of 8 bytes (one a 8-key group)
constexpr int kQRowKeepBytes = 16 * (kBK / 8);

template <typename T, int D, bool DROP>
__host__ __device__ constexpr int qrow_smem_bytes() {
  return qrow_ring_bytes<T, D>() + (DROP ? kTcWarps * kQRowKeepBytes : 0);
}

// The keep bits of this thread's fragment rows (rows g and g + 8 of the
// warp's 16 from qw) for the 64-key tile at k0: each lane draws 4 Philox
// calls (a row's 4 key groups) into the warp's buffer kw (row r at kw + 8 r),
// then reads its two rows back; byte j of keep[r] is key group j.
__device__ __forceinline__ void row_keep_bits(const Dropout& drp, uint8_t* kw, int k0,
                                              int qw, uint32_t bh, uint2 (&keep)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  __syncwarp();  // the previous tile's bits are no longer read
  const int rr = lane >> 1, g0 = (lane & 1) * 4;
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w |= keep_byte(drp, (k0 >> 3) + g0 + e, qw + rr, bh) << (8 * e);
  *reinterpret_cast<uint32_t*>(kw + rr * 8 + g0) = w;
  __syncwarp();
  keep[0] = *reinterpret_cast<const uint2*>(kw + g * 8);
  keep[1] = *reinterpret_cast<const uint2*>(kw + (g + 8) * 8);
}

// the keep byte of key group j (of 8) from row_keep_bits
__device__ __forceinline__ uint32_t keep_group(const uint2& keep, int j) {
  return (j < 4 ? keep.x : keep.y) >> (8 * (j & 3));
}

// The warp's score fragments s (its rows row0 and row0 + 8; n8 tile j holds
// keys k0 + 8 j + 2 t, + 1) as logits in log2 units, kNegInf where masked.
// The bias and the mask are applied only where the 8 NJ keys from k0 cross
// the diagonal of the query tile at q0 or the ragged end, or with a bias.
template <typename T, int NJ>
__device__ __forceinline__ void log2_logits(float (&s)[NJ][4], const Slice<T>& in,
                                            const Args& a, int q0, int k0, int row0) {
  const int t = threadIdx.x & 3;
  const bool edge = a.bias != nullptr || k0 + 8 * NJ > a.sk ||
                    (a.causal && k0 + 8 * NJ - 1 > q0 + (a.sk - a.sq));
  if (edge) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8, col = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = in.lg.visible(row, col) ? in.lg.at(s[j][e], row, col) * kLog2e
                                          : kNegInf;
      }
  } else {
    const float sl2 = a.scale * kLog2e;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
  }
}

// the widths the kernels are instantiated at
// (paddle_tpu_torch/ops/cuda/flash_attention.py::FLASH_WIDTHS); bf16 and
// fp16 K1-K3 take the tensor cores up to 128, FMA at 256
#define PTT_TC_WIDTHS(X) X(16) X(32) X(64) X(80) X(96) X(128)
#define PTT_FLASH_WIDTHS(X) PTT_TC_WIDTHS(X) X(256)

// Above the widest width, the FMA kernels of every type run the head dim in
// chunks of kWide columns, with kWide-wide tiles (32 x 32, M = 2): the
// scores (and K2's and K3's dp) accumulate over the chunks, and the output
// columns (out, dq, dk and dv) split over the grid's x dimension into slices
// of kWide, each CTA recomputing the scores for its slice.
constexpr int kWide = 256;

// the number of kWide-column slices of a head dim d
__host__ __device__ constexpr int wide_slices(int d) { return (d + kWide - 1) / kWide; }

// the smallest width >= d (0: d above 256, the chunked kernels)
int width_of(int d) {
  const int widths[] = {16, 32, 64, 80, 96, 128, 256};
  for (int w : widths)
    if (d <= w) return w;
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// whether the tensor-core kernels copy whole rows with cp.async: the head
// dim is an instantiated width and every q, k and v row is 16-byte aligned
// (2-byte elements: base pointers and (batch, seq, head) strides)
int rows_aligned(const Args& a) {
  bool ok = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && a.dn == width_of(a.dn);
  for (int i = 0; i < 3; ++i) ok = ok && a.qs[i] % 8 == 0 && a.ks[i] % 8 == 0 && a.vs[i] % 8 == 0;
  return ok ? 1 : 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               int b, int sq, int sk, int h, int d, const long long* st, float scale,
               int causal, unsigned int seed0, unsigned int seed1, unsigned int thr,
               float inv_keep) {
  return Args{q, k, v, static_cast<const float*>(bias), b, sq, sk, h, d,
              {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
              {st[6], st[7], st[8]}, {st[9], st[10], st[11]}, scale, causal,
              Dropout{seed0, seed1, thr, inv_keep}};
}

}  // namespace
}  // namespace ptt
