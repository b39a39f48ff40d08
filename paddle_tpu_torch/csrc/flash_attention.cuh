// What the flash attention kernels K1 (flash_attention.cu), K2
// (flash_attention_dq.cu), K3 (flash_attention_dkv.cu), K4
// (flash_attention_cached.cu) and K6 (flash_attention_packed.cu) share:
// their arguments, the (batch, head) slice a CTA works on, the loads of a
// query tile and of a k/v tile, the tensor-core pieces of the kernels whose
// warp rows are query rows (K1, K2 and K4's prefill: the k/v ring, the keep
// bits of a warp's rows, the visibility policies and the logits of a score
// fragment), the two tensor-core kernel bodies that run under two names
// (fwd_tc: K1's forward and K4's prefill; dkv_tc: K3's dk/dv and, with its
// dq product, K6's one-pass backward), the instantiated widths and the
// launch checks. Each kernel has its own translation unit so that nvcc
// builds them in parallel.
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

// Visibility policies of the tensor-core kernels whose warp rows are query
// rows, seen from one thread: its fragment rows r = 0 (row0) and r = 1
// (row0 + 8) of the query tile at q0. Each gives key_end() (one past the
// last key any row of the tile sees: the sweep stops there), edge(k0, n)
// (whether the n keys from k0 need the per-element mask: elsewhere every
// pair is visible and the logit is dot * scale), visible(r, col) and
// at(dot, r, col) (the logit of a visible pair).
//
// K1 and K2: causal masking (bottom-right aligned) and the bias, through
// the slice's Logits.
struct CausalBias {
  Logits lg;
  int q0, row0;

  __device__ __forceinline__ int key_end() const { return lg.key_end(q0, kBQ); }
  __device__ __forceinline__ bool edge(int k0, int n) const {
    return lg.bias != nullptr || k0 + n > lg.sk ||
           (lg.causal && k0 + n - 1 > q0 + (lg.sk - lg.sq));
  }
  __device__ __forceinline__ bool visible(int r, int col) const {
    return lg.visible(row0 + 8 * r, col);
  }
  __device__ __forceinline__ float at(float dot, int r, int col) const {
    return lg.at(dot, row0 + 8 * r, col);
  }
};

// K4's length mask (the LengthMask contract): key col is visible to a row
// at cache position pos iff col <= pos and col < klen (kv_len of the slot);
// a row past sq has pos -1. kend is min(klen, the tile's largest pos + 1).
struct LengthMask {
  int kend, klen;
  int pos[2];  // this thread's rows
  float scale;

  __device__ __forceinline__ int key_end() const { return kend; }
  __device__ __forceinline__ bool edge(int k0, int n) const {
    return k0 + n > klen || k0 + n - 1 > min(pos[0], pos[1]);
  }
  __device__ __forceinline__ bool visible(int r, int col) const {
    return col <= pos[r] && col < klen;
  }
  __device__ __forceinline__ float at(float dot, int, int) const { return dot * scale; }
};

// The warp's score fragments s (this thread's rows r = 0, 1; n8 tile j
// holds keys k0 + 8 j + 2 t, + 1) as logits in log2 units, kNegInf where
// masked; the policy's per-element mask only where edge() says so.
template <int NJ, typename Mask>
__device__ __forceinline__ void log2_logits(float (&s)[NJ][4], const Mask& mk, int k0,
                                            float scale) {
  const int t = threadIdx.x & 3;
  if (mk.edge(k0, 8 * NJ)) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = mk.visible(r, col) ? mk.at(s[j][e], r, col) * kLog2e : kNegInf;
      }
  } else {
    const float sl2 = scale * kLog2e;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
  }
}

// ---------------------------------------------------------------------------
// the forward on the tensor cores (bf16, fp16): K1's fwd_tc_kernel, and K4's
// prefill (cached_tc_kernel) under the length mask
// ---------------------------------------------------------------------------
// The query tile at q0 of slice (bb, hh): 64 rows, 16 a warp, q fragments
// in registers; k and v 64-key tiles through a two-stage cp.async ring in
// the input type; the online softmax in log2 units; p rounded to the input
// type as the A fragment of p v. out (contiguous (b, sq, h, dn)) = acc / l,
// 0 on a row with no visible key; lse (fp32 (b, h, sq); nullptr: not
// written) = m + log l, -1e30 on such a row.
template <typename T, int D, bool DROP, typename Mask>
__device__ __forceinline__ void fwd_tc(const Args& a, const Slice<T>& in, const Mask& mk,
                                       int bb, int hh, int q0, T* __restrict__ out,
                                       float* __restrict__ lse, int vec) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int S = tc_stride<D>(), KT = D / 16, NT = D / 8, kTile = kBK * S;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* const ring = reinterpret_cast<T*>(tc_smem);  // stage s: k tile, v tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t bh = static_cast<uint32_t>(bb * a.h + hh);
  const int nk = (mk.key_end() + kBK - 1) / kBK;
  // this warp's keep bits: row r (of its 16) at kw + 8 r
  uint8_t* const kw = tc_smem + qrow_ring_bytes<T, D>() + warp * kQRowKeepBytes;

  // q lands in stage 1, is taken into registers, then the ring starts
  T* qs = ring + 2 * kTile;
  tile_rows<T, D>(qs, in.q, a.qs[1], q0, a.sq, a, vec);
  if (nk > 0) load_kv_rows<T, D>(in, a, 0, vec, ring, ring + kTile);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  uint32_t qf[KT][4];
  load_a(qf, qs, warp * 16, S);
  __syncthreads();

  float acc[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int i = 0; i < nk; ++i) {
    const int k0 = i * kBK;
    if (i > 0) {
      cp_wait<0>();     // tile i has landed
      __syncthreads();  // ... for every thread, and tile i - 1 is no longer read
    }
    if (i + 1 < nk) {
      T* nxt = ring + ((i + 1) & 1) * 2 * kTile;
      load_kv_rows<T, D>(in, a, k0 + kBK, vec, nxt, nxt + kTile);
    }
    cp_commit();
    const T* ks = ring + (i & 1) * 2 * kTile;
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<T, KT, kBK / 8>(s, qf, ks, 0, S);

    // keep bits of this thread's rows: byte j of keep[r] is key group j
    uint2 keep[2];
    if constexpr (DROP) row_keep_bits(a.drp, kw, k0, q0 + warp * 16, bh, keep);
    log2_logits<kBK / 8>(s, mk, k0, a.scale);

    // online softmax; l keeps this thread's partial row sums (summed over
    // the quad at the end: every term shares the row's rescaling)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      const bool live = m_new > 0.5f * kNegInf;
      const float alpha = ex2(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          float p = live ? ex2(s[j][e] - m_new) : 0.f;
          rs += p;
          if constexpr (DROP) p = drop(a.drp, keep_group(keep[r], j), 2 * t + (e & 1), p);
          s[j][e] = p;
        }
      l[r] = l[r] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        acc[c][2 * r] *= alpha;
        acc[c][2 * r + 1] *= alpha;
      }
    }
    mma_pb<T, kBK / 16, NT>(acc, s, ks + kTile, 0, S);  // o += p v
  }

  // out = acc / l (0 on a row with no visible key), lse = m + log l
  float mul[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    mul[r] = lr > 0.f ? 1.f / lr : 0.f;
    const int row = row0 + 8 * r;
    if (lse != nullptr && t == 0 && row < a.sq)
      lse[(static_cast<long long>(bb) * a.h + hh) * a.sq + row] =
          lr > 0.f ? m[r] * kLn2 + logf(lr) : kNegInf;
  }
  const long long hd = static_cast<long long>(a.h) * a.dn;
  store_acc<T, NT>(acc, mul, out + static_cast<long long>(bb) * a.sq * hd + hh * a.dn, hd,
                   q0 + warp * 16, a.sq, a.dn);
}

// ---------------------------------------------------------------------------
// dk and dv on the tensor cores (bf16, fp16): K3's dkv_tc_kernel, and with
// the dq product (DQ) K6's one-pass packed_bwd_tc_kernel
// ---------------------------------------------------------------------------
// a stage: q, dout and out tiles (row stride tc_stride), then the tile's lse
// in log2 units and delta, kBQ floats each
template <typename T, int D>
__host__ __device__ constexpr int dkv_tc_stage_bytes() {
  return 3 * kBQ * tc_stride<D>() * static_cast<int>(sizeof(T)) +
         2 * kBQ * static_cast<int>(sizeof(float));
}

// the keep bits of a warp: its 32 queries (a half tile) of 2 bytes (its 16
// keys)
constexpr int kDkvKeepBytes = 32 * 2;

// DQ adds the CTA's k tile (row stride tc_stride) and its ds tile, stored
// transposed (key rows of kBQ queries at row stride tc_stride<kBQ>), both
// in the input type
template <typename T, int D, bool DROP, bool DQ>
__host__ __device__ constexpr int dkv_tc_smem_bytes() {
  return 2 * dkv_tc_stage_bytes<T, D>() + (DROP ? kTcWarps * kDkvKeepBytes : 0) +
         (DQ ? (kBK * tc_stride<D>() + kBK * tc_stride<kBQ>()) * static_cast<int>(sizeof(T))
             : 0);
}

// The 64-key tile at k0 of slice (bb, hh), 16 keys a warp, k and v
// fragments in registers, swept over the query tiles that see it (q, dout
// and out through a two-stage cp.async ring; delta recomputed a tile from
// out and dout; lse prefetched a tile ahead): dv += p^T dout and dk +=
// (ds * scale)^T q with p and ds * scale rounded to the input type, in 32-
// query halves. With DQ, each warp's ds * scale (rounded) also goes to the
// shared ds tile, and after both halves each warp computes dq for 16 query
// rows over the CTA's 64 keys, (ds * scale) k, with ldmatrix.trans operands
// from the ds and k tiles, and adds it to the fp32 workspace dq_ws
// (contiguous (b, sq, h, dn)) with one 8-byte vector reduction
// (red.global.add.v2.f32) a column pair. dk and dv (contiguous (b, sk, h,
// dn)) are written once.
template <typename T, int D, bool DROP, bool DQ>
__device__ __forceinline__ void dkv_tc(const Args& a, const T* __restrict__ out,
                                       const T* __restrict__ dout,
                                       const float* __restrict__ lse, T* __restrict__ dk,
                                       T* __restrict__ dv, float* __restrict__ dq_ws,
                                       int vec) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int S = tc_stride<D>(), KT = D / 16, NT = D / 8, kTile = kBQ * S;
  constexpr int kStage = dkv_tc_stage_bytes<T, D>();
  constexpr int SD = tc_stride<kBQ>();  // the ds tile's row stride
  static_assert(kStage % 16 == 0, "stages stay 16-byte aligned");
  static_assert(!DQ || D % 32 == 0, "dq goes 32 columns at a time");
  extern __shared__ __align__(16) unsigned char tc_smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bb = blockIdx.z, hh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const uint32_t bh = static_cast<uint32_t>(bb * a.h + hh);
  const Slice<T> in(a, bb, hh);
  const long long hd = static_cast<long long>(a.h) * a.dn;
  const long long orow0 = static_cast<long long>(bb) * a.sq * hd + hh * a.dn;
  const T* ob = out + orow0;
  const T* gb = dout + orow0;
  const float* lb = lse + (static_cast<long long>(bb) * a.h + hh) * a.sq;
  const int qfirst = in.lg.first_q_tile(k0, kBQ);
  const int nq = qfirst < a.sq ? (a.sq - qfirst + kBQ - 1) / kBQ : 0;
  // this warp's keep bits: query c (of a half) at kw[c], byte e>>1 = key
  // group of keys e>>1 ? 8..15 : 0..7 of the warp's 16
  uint16_t* const kw =
      reinterpret_cast<uint16_t*>(tc_smem + 2 * kStage + warp * kDkvKeepBytes);
  // DQ: the k tile and the ds tile (dst[key][query])
  T* const kt = reinterpret_cast<T*>(tc_smem + 2 * kStage +
                                     (DROP ? kTcWarps * kDkvKeepBytes : 0));
  T* const dst = kt + kBK * S;

  auto tiles = [&](int st) { return reinterpret_cast<T*>(tc_smem + st * kStage); };
  auto load_stage = [&](int st, int q0) {
    T* d = tiles(st);
    tile_rows<T, D>(d, in.q, a.qs[1], q0, a.sq, a, vec);
    tile_rows<T, D>(d + kTile, gb, hd, q0, a.sq, a, vec);
    tile_rows<T, D>(d + 2 * kTile, ob, hd, q0, a.sq, a, vec);
  };
  auto lse_at = [&](int row) { return row < a.sq ? lb[row] : kNegInf; };

  // k and v land in stage 1 (DQ: k in its own tile, where it stays), are
  // taken into registers, then the ring starts
  T* const ks0 = DQ ? kt : tiles(1);
  tile_rows<T, D>(ks0, in.k, a.ks[1], k0, a.sk, a, vec);
  tile_rows<T, D>(tiles(1) + kTile, in.v, a.vs[1], k0, a.sk, a, vec);
  if (nq > 0) load_stage(0, qfirst);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  uint32_t kf[KT][4], vf[KT][4];
  load_a(kf, ks0, warp * 16, S);
  load_a(vf, tiles(1) + kTile, warp * 16, S);
  __syncthreads();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  // the next tile's lse, a register a row (threads < kBQ), loaded a tile ahead
  float lnext = threadIdx.x < kBQ && nq > 0 ? lse_at(qfirst + threadIdx.x) : 0.f;

  for (int i = 0; i < nq; ++i) {
    const int q0 = qfirst + i * kBQ;
    cp_wait<0>();     // tile i has landed
    __syncthreads();  // ... for every thread, and tile i - 1 is no longer read
    if (i + 1 < nq) load_stage((i + 1) & 1, q0 + kBQ);
    cp_commit();
    const T* qs = tiles(i & 1);
    const T* gs = qs + kTile;
    const T* os = qs + 2 * kTile;
    float* ls = reinterpret_cast<float*>(tiles(i & 1) + 3 * kTile);
    float* dl = ls + kBQ;
    // lse in log2 units, +inf on a row with no visible key or past sq (p = 0)
    if (threadIdx.x < kBQ) {
      ls[threadIdx.x] = lnext > 0.5f * kNegInf ? lnext * kLog2e : CUDART_INF_F;
      if (i + 1 < nq) lnext = lse_at(q0 + kBQ + threadIdx.x);
    }
    {  // delta = rowsum(dout * out): two threads a row, 16-byte loads
      const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
      float d = 0.f;
#pragma unroll
      for (int c = c0; c < c0 + D / 2; c += 8) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gs + r * S + c);
        const uint4 ov = *reinterpret_cast<const uint4*>(os + r * S + c);
        const T* gp = reinterpret_cast<const T*>(&gv);
        const T* op = reinterpret_cast<const T*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(to_f32(gp[e]), to_f32(op[e]), d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if ((threadIdx.x & 1) == 0) dl[r] = d;
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * (kBQ / 2);  // query rows q0 + c0 .. + 31
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<T, KT, 4>(s, kf, qs, c0, S);   // s^T = k q^T
      mma_abt<T, KT, 4>(dp, vf, gs, c0, S);  // dp^T = v dout^T
      if constexpr (DROP) {
        __syncwarp();  // the previous half's bits are no longer read
        const uint32_t grp = static_cast<uint32_t>(k0 + warp * 16) >> 3;
        const uint32_t q = static_cast<uint32_t>(q0 + c0 + lane);
        kw[lane] = static_cast<uint16_t>(keep_byte(a.drp, grp, q, bh) |
                                         keep_byte(a.drp, grp + 1, q, bh) << 8);
        __syncwarp();
      }
      const bool edge = a.bias != nullptr || k0 + kBK > a.sk ||
                        (a.causal && k0 + kBK - 1 > q0 + c0 + (a.sk - a.sq));
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c0 + j * 8 + 2 * t + (e & 1);
          const int key = key0 + (e >> 1) * 8, row = q0 + qc;
          float x = s[j][e] * sl2;
          if (edge)
            x = in.lg.visible(row, key) ? in.lg.at(s[j][e], row, key) * kLog2e : -CUDART_INF_F;
          const float p = ex2(x - ls[qc]);
          float pd = p, g_ = dp[j][e];
          if constexpr (DROP) {
            const uint32_t byte = kw[j * 8 + 2 * t + (e & 1)] >> (8 * (e >> 1));
            pd = drop(a.drp, byte, g, p);
            g_ = drop(a.drp, byte, g, g_);
          }
          s[j][e] = pd;
          dp[j][e] = p * (g_ - dl[qc]) * a.scale;  // ds * scale
        }
      if constexpr (DQ) {
        // ds * scale, rounded, to the ds tile: keys key0 (- k0) and + 8,
        // queries c0 + 8 j + 2 t, + 1
        T* d0 = dst + (warp * 16 + g) * SD + c0 + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<uint32_t*>(d0 + j * 8) = pack2<T>(dp[j][0], dp[j][1]);
          *reinterpret_cast<uint32_t*>(d0 + 8 * SD + j * 8) = pack2<T>(dp[j][2], dp[j][3]);
        }
      }
      mma_pb<T, 2, NT>(dva, s, gs, c0, S);   // dv += p^T dout
      mma_pb<T, 2, NT>(dka, dp, qs, c0, S);  // dk += (ds * scale)^T q
    }
    if constexpr (DQ) {
      __syncthreads();  // every warp's ds is in the tile
      // dq of the warp's 16 query rows, 32 columns at a time: (ds * scale) k
      const int qr = q0 + warp * 16 + g;  // this thread's rows: qr, qr + 8
      float* w0 = dq_ws + orow0 + static_cast<long long>(qr) * hd + 2 * t;
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += 32) {
        float acc[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
        mma_atb<T, kBK / 16, 4>(acc, dst, warp * 16, SD, kt, n0, S);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (qr + 8 * r >= a.sq) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n0 + c * 8 + 2 * t < a.dn)
              atomicAdd(reinterpret_cast<float2*>(w0 + 8 * r * hd + n0 + c * 8),
                        make_float2(acc[c][2 * r], acc[c][2 * r + 1]));
        }
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  const long long krow0 = static_cast<long long>(bb) * a.sk * hd + hh * a.dn;
  store_acc<T, NT>(dka, one, dk + krow0, hd, k0 + warp * 16, a.sk, a.dn);
  store_acc<T, NT>(dva, one, dv + krow0, hd, k0 + warp * 16, a.sk, a.dn);
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
