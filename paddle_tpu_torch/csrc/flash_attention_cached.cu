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

template <int D>
__host__ __device__ constexpr int warp_smem_floats() {
  return kRPW * D + kTile * (D + 1) + kTile * D;
}

template <typename T, int D, int KSPLIT>
__global__ void __launch_bounds__(kWarps * 32)
cached_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ q_pos,
                  const int* __restrict__ kv_len, T* __restrict__ out,
                  int sq, int sk, int h,
                  long long qsb, long long qss, long long qsh,
                  long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh, float scale) {
  static_assert(D % 32 == 0 && D <= 128, "head_dim must be a multiple of 32, at most 128");
  static_assert(KSPLIT == 1 || KSPLIT == kWarps, "KSPLIT is 1 or 4");
  constexpr int DPL = D / 32;             // acc columns a lane
  constexpr int CH = 16 / sizeof(T);      // elements in a 16-byte load
  constexpr int CPR = D / CH;             // 16-byte loads a row
  constexpr int kRowGroups = kWarps / KSPLIT;
  constexpr int QT = kRPW * kRowGroups;   // query rows a CTA

  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % kRowGroups, kpart = warp / kRowGroups;
  const int bb = blockIdx.z, hh = blockIdx.y;
  const int row0 = blockIdx.x * QT + rg * kRPW;
  // rows of this warp that exist (warp-uniform): decode has one, and the
  // loops below skip the rest instead of computing masked rows
  const int nlive = max(0, min(kRPW, sq - row0));

  float* qs = smem + warp * warp_smem_floats<D>();
  float* ks = qs + kRPW * D;
  float* vs = ks + kTile * (D + 1);

  // this warp's query rows, pre-scaled, into shared memory
  int qp[kRPW];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int row = row0 + r;
    const bool live = row < sq;
    qp[r] = live ? q_pos[static_cast<long long>(bb) * sq + row] : -1;
    const T* qr = q + bb * qsb + static_cast<long long>(row) * qss + hh * qsh;
    for (int e = lane; e < D; e += 32)
      qs[r * D + e] = live ? to_f32(qr[e]) * scale : 0.f;
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
    __syncwarp();  // the previous tile is no longer read
    for (int idx = lane; idx < kTile * CPR; idx += 32) {
      const int key = idx / CPR, c = (idx % CPR) * CH;
      const int j = j0 + key;
      float kb[CH], vb[CH];
      if (j < sk) {
        load16(k + bb * ksb + static_cast<long long>(j) * kss + hh * ksh + c, kb);
        load16(v + bb * vsb + static_cast<long long>(j) * vss + hh * vsh + c, vb);
      } else {
#pragma unroll
        for (int e = 0; e < CH; ++e) kb[e] = vb[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        ks[key * (D + 1) + c + e] = kb[e];
        vs[key * D + c + e] = vb[e];
      }
    }
    __syncwarp();

    float s[kRPW];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) s[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < kRPW; ++r)
        if (r < nlive) s[r] = fmaf(qs[r * D + d], kd, s[r]);
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

  const long long out_row = static_cast<long long>(h) * D;
  T* ob = out + (static_cast<long long>(bb) * sq) * out_row + hh * D;
  if constexpr (KSPLIT == 1) {
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int row = row0 + r;
      if (row >= sq) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
      for (int c = 0; c < DPL; ++c)
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
      if (row >= sq) continue;
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

template <typename T, int D, int KSPLIT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_len, void* out, int b,
                   int sq, int sk, int h, const long long* st, float scale,
                   cudaStream_t stream) {
  constexpr int QT = kRPW * (kWarps / KSPLIT);
  const size_t smem = sizeof(float) * kWarps * warp_smem_floats<D>();
  auto kern = cached_fwd_kernel<T, D, KSPLIT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((sq + QT - 1) / QT, h, b);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_len, static_cast<T*>(out), sq, sk, h,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_len, void* out, int b,
                         int sq, int sk, int h, const long long* st,
                         float scale, int ksplit, cudaStream_t stream) {
  if (ksplit == kWarps)
    return launch<T, D, kWarps>(q, k, v, q_pos, kv_len, out, b, sq, sk, h, st, scale, stream);
  if (ksplit == 1)
    return launch<T, D, 1>(q, k, v, q_pos, kv_len, out, b, sq, sk, h, st, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* q_pos, const int* kv_len, void* out, int b,
                     int sq, int sk, int h, int d, const long long* st,
                     float scale, int ksplit, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_split<T, 32>(q, k, v, q_pos, kv_len, out, b, sq, sk, h, st, scale, ksplit, stream);
    case 64: return launch_split<T, 64>(q, k, v, q_pos, kv_len, out, b, sq, sk, h, st, scale, ksplit, stream);
    case 96: return launch_split<T, 96>(q, k, v, q_pos, kv_len, out, b, sq, sk, h, st, scale, ksplit, stream);
    case 128: return launch_split<T, 128>(q, k, v, q_pos, kv_len, out, b, sq, sk, h, st, scale, ksplit, stream);
  }
  return cudaErrorInvalidValue;
}

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
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const int* qp = static_cast<const int*>(q_pos);
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_d<float>(q, k, v, qp, kl, out, b, sq, sk, h, d, st, scale, ksplit, s);
    case kBFloat16: return launch_d<__nv_bfloat16>(q, k, v, qp, kl, out, b, sq, sk, h, d, st, scale, ksplit, s);
    case kFloat16: return launch_d<__half>(q, k, v, qp, kl, out, b, sq, sk, h, d, st, scale, ksplit, s);
  }
  return cudaErrorInvalidValue;
}
