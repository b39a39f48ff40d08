// Length-masked (cached) attention forward (kernel K4 of the port).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_cached_fwd_kernel,
// which serves prefill, chunked prefill and speculative verify on the TPU.
// Here it serves every LengthMask attention call on the card: prefill,
// chunked prefill, decode (sq = 1) and verify (sq = spec_k + 1).
//
// Semantics (the LengthMask contract): key j attends to query row i of batch
// b iff j <= q_pos[b, i] and j < kv_len[b] (kv_len absent: j < sk). Scores
// and the online softmax (m, l, acc) are fp32; a row with no valid key
// (l == 0) gives 0.
//
// Bound on the H100: at decode and verify, bytes: the valid prefix of every
// slot's K/V rows is read once (up to 2 x 8 x 1024 x 12 x 64 x 2 B = 25 MB a
// layer, ~7.5 us at 3.35 TB/s) for 1 to 5 query rows. At prefill (sq = sk =
// 1024) the causal score work, 4*d flops a valid (q, k) pair, is about
// 3.2 GFLOP a layer, which needs the tensor cores to approach its bound.
//
// Design (simple and right first, plain FMA, no tensor cores):
//  * One CTA of 4 warps per (q tile, head, batch). q, k and v are read in
//    the paddle layout [b, s, h, d] through their strides, so no transposed
//    copy is made and a cache row view is read in place.
//  * Each warp owns RPW = 8 query rows and stages its own 32-key K/V tile in
//    its private slice of shared memory (fp32; K rows padded to d + 1 floats
//    so that the 32 lanes, one key each, hit 32 banks). Warps never wait for
//    each other inside the loop.
//  * Scores: lane = key; the q rows are broadcast from shared memory. The
//    online-softmax update uses warp shuffles; acc holds d / 32 columns a
//    lane for each row.
//  * A warp stops at the last tile any of its rows can see (max q_pos and
//    kv_len), so causal prefill skips the upper triangle and decode reads
//    only the written prefix of the cache.
//  * KSPLIT = 4 (used when sq <= 8, i.e. decode and verify): the four warps
//    hold the same 8 rows and take every fourth key tile; partial (m, l, acc)
//    are merged through shared memory at the end. That gives each decode CTA
//    four streams of loads in flight instead of one.
//  * Head dims: instantiated at widths 32, 64, 96, 128 and 256; a head dim d
//    runs in the smallest width >= d, its columns >= d zero-filled on load
//    and skipped on store (d = 80, GPT-3 2.7B's, runs at 96). At width 256
//    the K tile is staged 128 columns at a time (the score sums the two
//    halves), so four warps' tiles fit a CTA's shared memory. Above 256
//    (WIDE, one instantiation a type, KSPLIT 1): q and K stream in
//    128-column chunks over the whole head dim, staged in turn through the
//    same buffers, and the output columns split over the grid's x dimension
//    into 256-column slices, each CTA recomputing the scores for its slice
//    of V and out. Rows whose base or stride is not 16-byte aligned, or
//    whose head dim is not a whole number of 16-byte pieces, load element
//    by element.
#include <cstdint>

#include "common.cuh"

namespace ptt {
namespace {

constexpr int kWarps = 4;
constexpr int kRPW = 8;     // query rows a warp holds
constexpr int kTile = 32;   // keys a tile (one a lane)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of T -> floats
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  constexpr int n = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < n; ++i) dst[i] = to_f32(e[i]);
}

// the columns of K staged at once: all of them up to 128, half at 256
template <int D>
__host__ __device__ constexpr int k_chunk() {
  return D > 128 ? 128 : D;
}

template <int D>
__host__ __device__ constexpr int warp_smem_floats() {
  return kRPW * D + kTile * (k_chunk<D>() + 1) + kTile * D;
}

// keys j0 .. j0 + kTile of a K or V row block, columns c0 .. c0 + W, into
// dst[key][c] at stride `stride` (0 past sk and in columns >= dn): 16-byte
// loads when `vec`, element loads otherwise
template <typename T, int W>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const T* base,
                                           long long rs, int j0, int sk, int c0, int dn,
                                           bool vec) {
  constexpr int CH = 16 / sizeof(T);  // elements in a 16-byte load
  constexpr int CPR = W / CH;         // 16-byte pieces a row
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < kTile * CPR; idx += 32) {
    const int key = idx / CPR, c = (idx % CPR) * CH;
    const int j = j0 + key, col = c0 + c;
    float x[CH];
    const T* src = base + static_cast<long long>(j) * rs + col;
    if (j < sk && vec && col + CH <= dn) {
      load16(src, x);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) x[e] = j < sk && col + e < dn ? to_f32(src[e]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < CH; ++e) dst[key * stride + c + e] = x[e];
  }
}

// keys j0 .. j0 + kTile of K and V together (all D columns of both; the
// loads of a key's K and V pieces in flight at once), as stage_rows does
// for one of them
template <typename T, int D>
__device__ __forceinline__ void stage_kv(float* ks, float* vs, const T* kb, const T* vb,
                                         long long kss, long long vss, int j0, int sk,
                                         int dn, bool vec) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int CPR = D / CH;
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < kTile * CPR; idx += 32) {
    const int key = idx / CPR, c = (idx % CPR) * CH;
    const int j = j0 + key;
    float kx[CH], vx[CH];
    const T* ksrc = kb + static_cast<long long>(j) * kss + c;
    const T* vsrc = vb + static_cast<long long>(j) * vss + c;
    if (j < sk && vec && c + CH <= dn) {
      load16(ksrc, kx);
      load16(vsrc, vx);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        const bool ok = j < sk && c + e < dn;
        kx[e] = ok ? to_f32(ksrc[e]) : 0.f;
        vx[e] = ok ? to_f32(vsrc[e]) : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      ks[key * (D + 1) + c + e] = kx[e];
      vs[key * D + c + e] = vx[e];
    }
  }
}

template <typename T, int D, int KSPLIT, bool WIDE>
__global__ void __launch_bounds__(kWarps * 32)
cached_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ q_pos,
                  const int* __restrict__ kv_len, T* __restrict__ out,
                  int sq, int sk, int h, int dn,
                  long long qsb, long long qss, long long qsh,
                  long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh, float scale, int vec) {
  static_assert(D % 32 == 0 && D <= 256, "width must be a multiple of 32, at most 256");
  static_assert(KSPLIT == 1 || KSPLIT == kWarps, "KSPLIT is 1 or 4");
  static_assert(!WIDE || (D == 256 && KSPLIT == 1), "WIDE: width 256, one key part");
  constexpr int DPL = D / 32;             // acc columns a lane
  constexpr int KC = k_chunk<D>();        // K columns staged at once
  constexpr int NKC = D / KC;             // K chunks a tile
  constexpr int kRowGroups = kWarps / KSPLIT;
  constexpr int QT = kRPW * kRowGroups;   // query rows a CTA

  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % kRowGroups, kpart = warp / kRowGroups;
  const int bb = blockIdx.z, hh = blockIdx.y;
  // WIDE: the CTA's output columns c1 .. c1 + D (slice blockIdx.x % nsl),
  // and the K chunks of the whole head dim
  const int nsl = WIDE ? (dn + D - 1) / D : 1;
  const int c1 = WIDE ? static_cast<int>(blockIdx.x % nsl) * D : 0;
  const int nkc = WIDE ? (dn + KC - 1) / KC : NKC;
  const int row0 = static_cast<int>(blockIdx.x / nsl) * QT + rg * kRPW;
  // rows of this warp that exist (warp-uniform): decode has one, and the
  // loops below skip the rest instead of computing masked rows
  const int nlive = max(0, min(kRPW, sq - row0));

  float* qs = smem + warp * warp_smem_floats<D>();
  float* ks = qs + kRPW * D;
  float* vs = ks + kTile * (KC + 1);
  const T* kb = k + bb * ksb + hh * ksh;
  const T* vb = v + bb * vsb + hh * vsh;

  // this warp's query rows, pre-scaled, into shared memory (WIDE: a chunk
  // at a time, in the tile loop)
  int qp[kRPW];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int row = row0 + r;
    const bool live = row < sq;
    qp[r] = live ? q_pos[static_cast<long long>(bb) * sq + row] : -1;
    if (WIDE) continue;
    const T* qr = q + bb * qsb + static_cast<long long>(row) * qss + hh * qsh;
    for (int e = lane; e < D; e += 32)
      qs[r * D + e] = live && e < dn ? to_f32(qr[e]) * scale : 0.f;
  }
  const int klen = kv_len == nullptr ? sk : min(kv_len[bb], sk);
  int need = 0;  // keys any row of this warp can see
#pragma unroll
  for (int r = 0; r < kRPW; ++r) need = max(need, min(qp[r], klen - 1) + 1);
  const int ntiles = (need + kTile - 1) / kTile;

  float m[kRPW], l[kRPW], acc[kRPW][DPL];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  __syncwarp();

  for (int t = kpart; t < ntiles; t += KSPLIT) {
    const int j0 = t * kTile;
    float s[kRPW];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) s[r] = 0.f;
#pragma unroll
    for (int kc = 0; kc < nkc; ++kc) {
      __syncwarp();  // the previous tile (or chunk) is no longer read
      if constexpr (NKC == 1) {
        stage_kv<T, D>(ks, vs, kb, vb, kss, vss, j0, sk, dn, vec);
      } else {
        stage_rows<T, KC>(ks, KC + 1, kb, kss, j0, sk, kc * KC, dn, vec);
        if (kc == 0) stage_rows<T, D>(vs, D, vb, vss, j0, sk, c1, dn, vec);
      }
      if constexpr (WIDE) {  // the chunk of this warp's query rows, pre-scaled
#pragma unroll
        for (int r = 0; r < kRPW; ++r) {
          const int row = row0 + r;
          const T* qr = q + bb * qsb + static_cast<long long>(row) * qss + hh * qsh;
          for (int e = lane; e < KC; e += 32) {
            const int col = kc * KC + e;
            qs[r * D + e] = row < sq && col < dn ? to_f32(qr[col]) * scale : 0.f;
          }
        }
      }
      __syncwarp();
      const int qc = WIDE ? 0 : kc * KC;  // the chunk's first column in qs
      for (int d = 0; d < KC; ++d) {
        const float kd = ks[lane * (KC + 1) + d];
#pragma unroll
        for (int r = 0; r < kRPW; ++r)
          if (r < nlive) s[r] = fmaf(qs[r * D + qc + d], kd, s[r]);
      }
    }
    const int j = j0 + lane;
    float p[kRPW];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      if (r >= nlive) {
        p[r] = 0.f;
        continue;
      }
      const bool ok = j <= qp[r] && j < klen;
      const float sc = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      p[r] = ok ? __expf(sc - m_new) : 0.f;
      const float alpha = __expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
    }
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vv[c] = vs[jj * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        if (r >= nlive) continue;
        const float pj = __shfl_sync(0xffffffffu, p[r], jj);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

  const long long out_row = static_cast<long long>(h) * dn;
  T* ob = out + (static_cast<long long>(bb) * sq) * out_row + hh * dn + c1;
  if constexpr (KSPLIT == 1) {
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int row = row0 + r;
      if (row >= sq) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        if (c1 + lane + 32 * c < dn)
          ob[row * out_row + lane + 32 * c] = from_f32<T>(acc[r][c] * inv);
    }
  } else {
    // merge the four key partitions: each warp parks (m, l, acc) in its own
    // slice, then the CTA combines them row by row
    __syncwarp();
    float* part = qs;  // kRPW * (D + 2) floats fit in the warp's slice
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      if (lane == 0) {
        part[r] = m[r];
        part[kRPW + r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < DPL; ++c) part[2 * kRPW + r * D + lane + 32 * c] = acc[r][c];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRPW * D; idx += kWarps * 32) {
      const int r = idx / D, e = idx % D;
      const int row = row0 + r;  // rg == 0 for every warp here
      if (row >= sq || e >= dn) continue;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, smem[w * warp_smem_floats<D>() + r]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* pw = smem + w * warp_smem_floats<D>();
        const float f = __expf(pw[r] - mx);
        den += pw[kRPW + r] * f;
        num += pw[2 * kRPW + r * D + e] * f;
      }
      ob[row * out_row + e] = from_f32<T>(den > 0.f ? num / den : 0.f);
    }
  }
}

template <typename T, int D, int KSPLIT, bool WIDE = false>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_len, void* out, int b,
                   int sq, int sk, int h, int d, const long long* st, float scale,
                   int vec, cudaStream_t stream) {
  constexpr int QT = kRPW * (kWarps / KSPLIT);
  const size_t smem = sizeof(float) * kWarps * warp_smem_floats<D>();
  auto kern = cached_fwd_kernel<T, D, KSPLIT, WIDE>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int nsl = WIDE ? (d + D - 1) / D : 1;  // output slices
  dim3 grid((sq + QT - 1) / QT * nsl, h, b);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_len, static_cast<T*>(out), sq, sk, h, d,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, vec);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_len, void* out, int b,
                         int sq, int sk, int h, int d, const long long* st,
                         float scale, int ksplit, int vec, cudaStream_t stream) {
  if (ksplit == kWarps)
    return launch<T, D, kWarps>(q, k, v, q_pos, kv_len, out, b, sq, sk, h, d, st, scale,
                                vec, stream);
  if (ksplit == 1)
    return launch<T, D, 1>(q, k, v, q_pos, kv_len, out, b, sq, sk, h, d, st, scale, vec,
                           stream);
  return cudaErrorInvalidValue;
}

// the widths K4 is instantiated at; above 256 the chunked kernel with one
// key part (ksplit is not used)
template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* q_pos, const int* kv_len, void* out, int b,
                     int sq, int sk, int h, int d, const long long* st,
                     float scale, int ksplit, int vec, cudaStream_t stream) {
#define PTT_CACHED(D)                                                                 \
  if (d <= D)                                                                         \
    return launch_split<T, D>(q, k, v, q_pos, kv_len, out, b, sq, sk, h, d, st, scale, \
                              ksplit, vec, stream);
  PTT_CACHED(32)
  PTT_CACHED(64)
  PTT_CACHED(96)
  PTT_CACHED(128)
  PTT_CACHED(256)
#undef PTT_CACHED
  return launch<T, 256, 1, true>(q, k, v, q_pos, kv_len, out, b, sq, sk, h, d, st, scale,
                                 vec, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace
}  // namespace ptt

extern "C" int ptt_flash_attention_cached_fwd(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_len, void* out, int b, int sq, int sk, int h, int d,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, float scale,
    int dtype, int ksplit, void* stream) {
  using namespace ptt;
  if (b == 0 || sq == 0 || h == 0) return cudaSuccess;
  if (d < 1) return cudaErrorInvalidValue;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const int* qp = static_cast<const int*>(q_pos);
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte K/V loads: aligned bases and every (batch, seq, head) stride
  // and the head dim a whole number of 16-byte pieces
  const long long per16 = dtype == kFloat32 ? 4 : 8;
  int vec = aligned16(k) && aligned16(v) && d % per16 == 0;
  for (int i = 3; i < 9; ++i) vec = vec && st[i] % per16 == 0;
  switch (dtype) {
    case kFloat32: return launch_d<float>(q, k, v, qp, kl, out, b, sq, sk, h, d, st, scale, ksplit, vec, s);
    case kBFloat16: return launch_d<__nv_bfloat16>(q, k, v, qp, kl, out, b, sq, sk, h, d, st, scale, ksplit, vec, s);
    case kFloat16: return launch_d<__half>(q, k, v, qp, kl, out, b, sq, sk, h, d, st, scale, ksplit, vec, s);
  }
  return cudaErrorInvalidValue;
}
