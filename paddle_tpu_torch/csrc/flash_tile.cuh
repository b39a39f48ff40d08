// The FMA tile scheme shared by the flash attention kernels K1-K3
// (flash_attention.cu) and K5/K6 (flash_attention_packed.cu): a CTA of 256
// threads as a 16 x 16 grid, each thread a 4 x 4 micro-tile of every
// 64 x 64 score tile (rows ty*4+i, keys tx+16*j) and the same 4 rows (or
// keys) of every 64 x D product (columns tx+16*c, D/16 a thread). Tiles
// live in shared memory as fp32: query-side rows at the padded stride
// D + 1, k and v transposed at the padded stride kPad, so the score
// products (lanes along keys) and the products with k or v (lanes along
// head_dim) read them without bank conflicts.
#pragma once

#include "common.cuh"

namespace ptt {
namespace flash {

constexpr int kBQ = 64;        // query rows a tile
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kWarps = kThreads / 32;
constexpr int kPad = kBK + 1;  // padded row of a transposed tile
constexpr float kNegInf = -1e30f;

// sum and max over the 16 threads of a micro-tile row (lanes tx = 0..15)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// How a (query row, key) pair of one (batch, head) slice becomes a logit:
// dot * scale plus the bias at (row, col), bias rows at stride bsr (nullptr:
// no bias), where the key is visible to the row, and kNegInf elsewhere. A key
// is visible when both are in range and, under causal masking,
// col <= row + sk - sq (bottom-right aligned).
struct Logits {
  int sq, sk, causal;
  float scale;
  const float* bias;
  long long bsr;

  __device__ __forceinline__ bool visible(int row, int col) const {
    return row < sq && col < sk && (!causal || col <= row + (sk - sq));
  }

  // the logit of a visible pair
  __device__ __forceinline__ float at(float dot, int row, int col) const {
    float s = dot * scale;
    if (bias != nullptr) s += bias[row * bsr + col];
    return s;
  }

  // a score tile at (q0, k0) to logits, kNegInf where masked
  __device__ __forceinline__ void mask(float (&s)[4][4], int q0, int k0, int ty,
                                       int tx) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = visible(row, col) ? at(s[i][j], row, col) : kNegInf;
      }
    }
  }

  // one past the last key any row of the query tile at q0 can see
  __device__ __forceinline__ int key_end(int q0) const {
    if (!causal) return sk;
    return max(0, min(sk, min(q0 + kBQ, sq) + (sk - sq)));
  }

  // the first query tile with a row that can see key k0
  __device__ __forceinline__ int first_q_tile(int k0) const {
    return causal ? (max(0, k0 - (sk - sq)) / kBQ) * kBQ : 0;
  }
};

// ds = p (dp - delta) of a score tile at (q0, k0), p = exp(logit - lse) (0
// where masked or on a row with no visible key), from the tile's lse ls
// and delta dl; p also to ps when keep_p; ds returned in s
__device__ __forceinline__ void probs_ds(const Logits& lg, int q0, int k0,
                                         const float* ls, const float* dl,
                                         float (&s)[4][4], const float (&dp)[4][4],
                                         float* ps, bool keep_p, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, row = q0 + r;
    const float lr = ls[r];
    const bool live = lr > 0.5f * kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      float p = 0.f;
      if (live && lg.visible(row, col)) p = expf(lg.at(s[i][j], row, col) - lr);
      if (keep_p) ps[r * kPad + tx + 16 * j] = p;
      s[i][j] = p * (dp[i][j] - dl[r]);
    }
  }
}

// a 64 x 64 register tile to ps at stride kPad
__device__ __forceinline__ void store_tile(const float (&s)[4][4], float* ps, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * kPad + tx + 16 * j] = s[i][j];
}

// rows r0 .. r0 + kBQ of a (seq, D) operand at row stride rs, times mul,
// as fp32 dst[r][c] at stride D + 1 (0 past n)
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* src, long long rs, int r0, int n,
                                          float mul, float* dst) {
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    dst[r * (D + 1) + c] = row < n ? to_f32(src[row * rs + c]) * mul : 0.f;
  }
}

// keys k0 .. k0 + kBK of k and v, transposed: kt[c][key], vt[c][key] (0
// past sk)
template <typename T, int D>
__device__ __forceinline__ void load_kv_t(const T* kb, const T* vb, long long kss,
                                          long long vss, int k0, int sk, float* kt,
                                          float* vt) {
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int key = idx / D, c = idx % D, j = k0 + key;
    float kv = 0.f, vv = 0.f;
    if (j < sk) {
      kv = to_f32(kb[j * kss + c]);
      vv = to_f32(vb[j * vss + c]);
    }
    kt[c * kPad + key] = kv;
    vt[c * kPad + key] = vv;
  }
}

// delta[r] = rowsum(dout * out) of the rows r0 .. r0 + kBQ (0 past n), rows
// at stride rs; one warp a row
template <typename T, int D>
__device__ __forceinline__ void row_delta(const T* ob, const T* gb, long long rs,
                                          int r0, int n, float* delta) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kBQ; r += kWarps) {
    const int row = r0 + r;
    float acc = 0.f;
    if (row < n)
      for (int c = lane; c < D; c += 32)
        acc = fmaf(to_f32(ob[row * rs + c]), to_f32(gb[row * rs + c]), acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) delta[r] = acc;
  }
}

// s = a b^T over a 64 x 64 tile: a rows at stride D + 1, b transposed
template <int D>
__device__ __forceinline__ void score_tile(const float* a, const float* bt, int ty,
                                           int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty * 4 + i) * (D + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = bt[c * kPad + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// s = q k^T and dp = dout v^T over a 64 x 64 tile in one sweep over D
template <int D>
__device__ __forceinline__ void score_tiles(const float* qs, const float* gs,
                                            const float* kt, const float* vt,
                                            int ty, int tx, float (&s)[4][4],
                                            float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float x[4], g[4], kc[4], vc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = qs[(ty * 4 + i) * (D + 1) + c];
      g[i] = gs[(ty * 4 + i) * (D + 1) + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kc[j] = kt[c * kPad + tx + 16 * j];
      vc[j] = vt[c * kPad + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i], kc[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vc[j], dp[i][j]);
      }
  }
}

// acc[row] += ps[row][:] b, for the tile's rows ty*4+i: ps at stride kPad,
// b transposed (bt[c][key]); p v in the forward, ds k for dq
template <int D>
__device__ __forceinline__ void acc_rows(const float* ps, const float* bt, int ty,
                                         int tx, float (&acc)[4][D / 16]) {
#pragma unroll 4
  for (int kk = 0; kk < kBK; ++kk) {
    float y[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) y[c] = bt[(tx + 16 * c) * kPad + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = ps[(ty * 4 + i) * kPad + kk];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(p, y[c], acc[i][c]);
    }
  }
}

// acc[key] += ps[:][key]^T a, for the tile's keys ty*4+i: a rows at stride
// D + 1; p^T dout for dv, ds^T q for dk
template <int D>
__device__ __forceinline__ void acc_keys(const float* ps, const float* a, int ty,
                                         int tx, float (&acc)[4][D / 16]) {
#pragma unroll 4
  for (int qq = 0; qq < kBQ; ++qq) {
    float x[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = a[qq * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = ps[qq * kPad + ty * 4 + i];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(p, x[c], acc[i][c]);
    }
  }
}

// one online-softmax step over a tile of logits (kNegInf where masked):
// rescales each row's running max m, sum l and accumulator acc, and
// writes p = exp(s - m) to ps. Rows with no visible key so far keep l = 0
// (exp(s - m) would be 1 on their masked entries).
template <int D>
__device__ __forceinline__ void softmax_step(const float (&s)[4][4], float (&m)[4],
                                             float (&l)[4], float (&acc)[4][D / 16],
                                             float* ps, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
    const float m_new = fmaxf(m[i], max16(mx));
    const bool live = m_new > 0.5f * kNegInf;
    const float alpha = expf(m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = live ? expf(s[i][j] - m_new) : 0.f;
      ps[(ty * 4 + i) * kPad + tx + 16 * j] = p;
      rs += p;
    }
    l[i] = l[i] * alpha + sum16(rs);
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
  }
}

// the forward's outputs of the tile's rows: out = acc / l (0 on a row with
// no visible key) into contiguous (b, sq, h, D), lse = m + log l (-1e30 on
// such a row) into (b, h, sq)
template <typename T, int D>
__device__ __forceinline__ void store_out(const float (&acc)[4][D / 16],
                                          const float (&m)[4], const float (&l)[4],
                                          T* out, float* lse, int bb, int hh, int h,
                                          int q0, int sq, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = out + ((static_cast<long long>(bb) * sq + row) * h + hh) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    if (tx == 0)
      lse[(static_cast<long long>(bb) * h + hh) * sq + row] =
          m[i] + logf(l[i] > 0.f ? l[i] : 1.f);
  }
}

// dk and dv of the tile's keys into contiguous (b, sk, h, D); dk scaled
template <typename T, int D>
__device__ __forceinline__ void store_dkv(const float (&dka)[4][D / 16],
                                          const float (&dva)[4][D / 16], T* dk,
                                          T* dv, int bb, int hh, int h, int k0,
                                          int sk, float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= sk) continue;
    const long long o = ((static_cast<long long>(bb) * sk + key) * h + hh) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk[o + tx + 16 * c] = from_f32<T>(dka[i][c] * scale);
      dv[o + tx + 16 * c] = from_f32<T>(dva[i][c]);
    }
  }
}

// shared memory of a forward CTA: q rows, k^T and v^T, p tile
template <int D>
__host__ __device__ constexpr int fwd_smem_floats() {
  return kBQ * (D + 1) + 2 * D * kPad + kBQ * kPad;
}

// of a backward CTA: k^T and v^T, q and dout rows, p/ds, lse and delta
template <int D>
__host__ __device__ constexpr int bwd_smem_floats() {
  return 2 * D * kPad + 2 * kBQ * (D + 1) + kBQ * kPad + 2 * kBQ;
}

// raise a kernel's dynamic shared memory limit above the 48 KB default,
// once; returns the error of a refused request
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) configured = true;
  return e;
}

}  // namespace flash
}  // namespace ptt
