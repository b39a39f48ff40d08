// The FMA tile scheme shared by the flash attention kernels K1-K3
// (flash_attention*.cu; K1 also runs K5) and K6 (flash_attention_packed.cu):
// a CTA of 256
// threads as a 16 x 16 grid, each thread an M x M micro-tile of every
// 16M x 16M score tile (rows ty*M+i, keys tx+16*j) and the same M rows (or
// keys) of every 16M x D product (columns tx+16*c, D/16 a thread). M is 4
// (64 x 64 tiles) up to head width 128 and 2 (32 x 32 tiles) at 256, where
// 64-row fp32 tiles would not fit a CTA's shared memory. Tiles live in
// shared memory as fp32: query-side rows at the padded stride D + 1, k and
// v transposed at the padded stride 16M + 1, so the score products (lanes
// along keys) and the products with k or v (lanes along head_dim) read them
// without bank conflicts.
//
// D is the instantiated width; dn <= D is the head dim of the data. Columns
// dn .. D - 1 are zero-filled on load (they add nothing to a dot product)
// and skipped on store, so one instantiation serves every head dim up to D.
// Above the widest width the head dim runs in D-column chunks: the score
// products accumulate over the chunks (score_tile / score_tiles with ADD),
// and a CTA writes the D output columns from c1 (store_out, store_dkv).
//
// Attention dropout (DROP): the keep bits of a tile, one byte a row and
// 8-key group (csrc/philox.cuh), are drawn into shared memory beside the
// tile by fill_keep and read by softmax_step (K1, K5: kept p scaled, after
// the row sum took the undropped p) and probs_ds (K2, K3, K6: dp masked and
// scaled; K3 and K6 also get the dropped p for dv).
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace ptt {
namespace flash {

constexpr int kThreads = 256;  // 16 x 16 threads, an M x M micro-tile each
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// the micro-tile size of instantiated width D
__host__ __device__ constexpr int tile_m(int D) { return D > 128 ? 2 : 4; }

// rows (queries) and keys of a tile, and the padded row of a transposed tile
template <int M>
struct Tile {
  static constexpr int B = 16 * M;
  static constexpr int Pad = B + 1;
  static constexpr int Groups = B / 8;  // 8-key keep-bit groups a row
};

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
  template <int M>
  __device__ __forceinline__ void mask(float (&s)[M][M], int q0, int k0, int ty,
                                       int tx) const {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int row = q0 + ty * M + i;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = visible(row, col) ? at(s[i][j], row, col) : kNegInf;
      }
    }
  }

  // one past the last key any row of the bq-row query tile at q0 can see
  __device__ __forceinline__ int key_end(int q0, int bq) const {
    if (!causal) return sk;
    return max(0, min(sk, min(q0 + bq, sq) + (sk - sq)));
  }

  // the first bq-row query tile with a row that can see key k0
  __device__ __forceinline__ int first_q_tile(int k0, int bq) const {
    return causal ? (max(0, k0 - (sk - sq)) / bq) * bq : 0;
  }
};

// the keep bits of the tile at (q0, k0) of slice bh into kb[row][group]
template <int M>
__device__ __forceinline__ void fill_keep(const Dropout& dp, uint32_t bh, int q0, int k0,
                                          uint8_t* kb) {
  constexpr int B = Tile<M>::B, G = Tile<M>::Groups;
  for (int i = threadIdx.x; i < B * G; i += kThreads) {
    const int r = i / G, g = i % G;
    kb[i] = static_cast<uint8_t>(keep_byte(dp, (k0 >> 3) + g, q0 + r, bh));
  }
}

// element (r, c) of a tile: its keep byte and bit
template <int M>
__device__ __forceinline__ uint32_t keep_at(const uint8_t* kb, int r, int c) {
  return kb[r * Tile<M>::Groups + (c >> 3)];
}

// ds = p (dp - delta) of a score tile at (q0, k0), p = exp(logit - lse) (0
// where masked or on a row with no visible key), from the tile's lse ls
// and delta dl; p (with DROP, the dropped p) also to ps when keep_p; ds
// returned in s. With DROP, dp is masked and scaled by the keep bits kb.
template <int M, bool DROP>
__device__ __forceinline__ void probs_ds(const Logits& lg, int q0, int k0,
                                         const float* ls, const float* dl,
                                         float (&s)[M][M], const float (&dp)[M][M],
                                         float* ps, bool keep_p, int ty, int tx,
                                         const Dropout& drp, const uint8_t* kb) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int r = ty * M + i, row = q0 + r;
    const float lr = ls[r];
    const bool live = lr > 0.5f * kNegInf;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int c = tx + 16 * j, col = k0 + c;
      float p = 0.f;
      if (live && lg.visible(row, col)) p = expf(lg.at(s[i][j], row, col) - lr);
      float g = dp[i][j];
      float pd = p;
      if constexpr (DROP) {
        const uint32_t byte = keep_at<M>(kb, r, c);
        g = drop(drp, byte, c & 7, g);
        pd = drop(drp, byte, c & 7, p);
      }
      if (keep_p) ps[r * Tile<M>::Pad + c] = pd;
      s[i][j] = p * (g - dl[r]);
    }
  }
}

// a register tile to ps at stride Tile<M>::Pad
template <int M>
__device__ __forceinline__ void store_tile(const float (&s)[M][M], float* ps, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) ps[(ty * M + i) * Tile<M>::Pad + tx + 16 * j] = s[i][j];
}

// rows r0 .. r0 + 16M of a (seq, dn) operand at row stride rs, times mul,
// as fp32 dst[r][c] at stride D + 1 (0 past n and in columns >= dn)
template <typename T, int D, int M>
__device__ __forceinline__ void load_rows(const T* src, long long rs, int r0, int n,
                                          int dn, float mul, float* dst) {
  for (int idx = threadIdx.x; idx < Tile<M>::B * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    dst[r * (D + 1) + c] = row < n && c < dn ? to_f32(src[row * rs + c]) * mul : 0.f;
  }
}

// keys k0 .. k0 + 16M of one operand (row stride ss), transposed:
// dst[c][key] (0 past sk and in columns >= dn)
template <typename T, int D, int M>
__device__ __forceinline__ void load_t(const T* src, long long ss, int k0, int sk,
                                       int dn, float* dst) {
  constexpr int B = Tile<M>::B, P = Tile<M>::Pad;
  for (int idx = threadIdx.x; idx < B * D; idx += kThreads) {
    const int key = idx / D, c = idx % D, j = k0 + key;
    dst[c * P + key] = j < sk && c < dn ? to_f32(src[j * ss + c]) : 0.f;
  }
}

// keys k0 .. k0 + 16M of k and v, transposed: kt[c][key], vt[c][key] (0
// past sk and in columns >= dn)
template <typename T, int D, int M>
__device__ __forceinline__ void load_kv_t(const T* kb, const T* vb, long long kss,
                                          long long vss, int k0, int sk, int dn,
                                          float* kt, float* vt) {
  constexpr int B = Tile<M>::B, P = Tile<M>::Pad;
  for (int idx = threadIdx.x; idx < B * D; idx += kThreads) {
    const int key = idx / D, c = idx % D, j = k0 + key;
    float kv = 0.f, vv = 0.f;
    if (j < sk && c < dn) {
      kv = to_f32(kb[j * kss + c]);
      vv = to_f32(vb[j * vss + c]);
    }
    kt[c * P + key] = kv;
    vt[c * P + key] = vv;
  }
}

// delta[r] = rowsum(dout * out) of the rows r0 .. r0 + 16M (0 past n), rows
// of dn values at stride rs; one warp a row
template <typename T, int M>
__device__ __forceinline__ void row_delta(const T* ob, const T* gb, long long rs,
                                          int r0, int n, int dn, float* delta) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < Tile<M>::B; r += kWarps) {
    const int row = r0 + r;
    float acc = 0.f;
    if (row < n)
      for (int c = lane; c < dn; c += 32)
        acc = fmaf(to_f32(ob[row * rs + c]), to_f32(gb[row * rs + c]), acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) delta[r] = acc;
  }
}

// s = a b^T over a tile (ADD: s += a b^T): a rows at stride D + 1, b
// transposed
template <int D, int M, bool ADD = false>
__device__ __forceinline__ void score_tile(const float* a, const float* bt, int ty,
                                           int tx, float (&s)[M][M]) {
  constexpr int P = Tile<M>::Pad;
  if constexpr (!ADD) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) s[i][j] = 0.f;
  }
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float x[M], y[M];
#pragma unroll
    for (int i = 0; i < M; ++i) x[i] = a[(ty * M + i) * (D + 1) + c];
#pragma unroll
    for (int j = 0; j < M; ++j) y[j] = bt[c * P + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// s = q k^T and dp = dout v^T over a tile in one sweep over D (ADD: added
// to s and dp)
template <int D, int M, bool ADD = false>
__device__ __forceinline__ void score_tiles(const float* qs, const float* gs,
                                            const float* kt, const float* vt,
                                            int ty, int tx, float (&s)[M][M],
                                            float (&dp)[M][M]) {
  constexpr int P = Tile<M>::Pad;
  if constexpr (!ADD) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) s[i][j] = dp[i][j] = 0.f;
  }
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float x[M], g[M], kc[M], vc[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      x[i] = qs[(ty * M + i) * (D + 1) + c];
      g[i] = gs[(ty * M + i) * (D + 1) + c];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      kc[j] = kt[c * P + tx + 16 * j];
      vc[j] = vt[c * P + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        s[i][j] = fmaf(x[i], kc[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vc[j], dp[i][j]);
      }
  }
}

// acc[row] += ps[row][:] b, for the tile's rows ty*M+i: ps at stride Pad,
// b transposed (bt[c][key]); p v in the forward, ds k for dq
template <int D, int M>
__device__ __forceinline__ void acc_rows(const float* ps, const float* bt, int ty,
                                         int tx, float (&acc)[M][D / 16]) {
  constexpr int P = Tile<M>::Pad;
#pragma unroll 4
  for (int kk = 0; kk < Tile<M>::B; ++kk) {
    float y[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) y[c] = bt[(tx + 16 * c) * P + kk];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float p = ps[(ty * M + i) * P + kk];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(p, y[c], acc[i][c]);
    }
  }
}

// acc[key] += ps[:][key]^T a, for the tile's keys ty*M+i: a rows at stride
// D + 1; p^T dout for dv, ds^T q for dk
template <int D, int M>
__device__ __forceinline__ void acc_keys(const float* ps, const float* a, int ty,
                                         int tx, float (&acc)[M][D / 16]) {
  constexpr int P = Tile<M>::Pad;
#pragma unroll 4
  for (int qq = 0; qq < Tile<M>::B; ++qq) {
    float x[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = a[qq * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float p = ps[qq * P + ty * M + i];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(p, x[c], acc[i][c]);
    }
  }
}

// one online-softmax step over a tile of logits (kNegInf where masked):
// rescales each row's running max m, sum l and accumulator acc, and
// writes p = exp(s - m) to ps (with DROP: the kept p times 1 / (1 - p),
// after l took the undropped p). Rows with no visible key so far keep
// l = 0 (exp(s - m) would be 1 on their masked entries).
template <int D, int M, bool DROP>
__device__ __forceinline__ void softmax_step(const float (&s)[M][M], float (&m)[M],
                                             float (&l)[M], float (&acc)[M][D / 16],
                                             float* ps, int ty, int tx,
                                             const Dropout& drp, const uint8_t* kb) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int r = ty * M + i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < M; ++j) mx = fmaxf(mx, s[i][j]);
    const float m_new = fmaxf(m[i], max16(mx));
    const bool live = m_new > 0.5f * kNegInf;
    const float alpha = expf(m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int c = tx + 16 * j;
      float p = live ? expf(s[i][j] - m_new) : 0.f;
      rs += p;
      if constexpr (DROP) p = drop(drp, keep_at<M>(kb, r, c), c & 7, p);
      ps[r * Tile<M>::Pad + c] = p;
    }
    l[i] = l[i] * alpha + sum16(rs);
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
  }
}

// the forward's outputs of the tile's rows: out = acc / l (0 on a row with
// no visible key) into columns c1 .. c1 + D of contiguous (b, sq, h, dn),
// lse = m + log l (-1e30 on such a row) into (b, h, sq) from the CTA of
// columns 0
template <typename T, int D, int M>
__device__ __forceinline__ void store_out(const float (&acc)[M][D / 16],
                                          const float (&m)[M], const float (&l)[M],
                                          T* out, float* lse, int bb, int hh, int h,
                                          int q0, int sq, int dn, int ty, int tx,
                                          int c1 = 0) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int row = q0 + ty * M + i;
    if (row >= sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = out + ((static_cast<long long>(bb) * sq + row) * h + hh) * dn + c1;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      if (c1 + tx + 16 * c < dn) orow[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    if (tx == 0 && c1 == 0)
      lse[(static_cast<long long>(bb) * h + hh) * sq + row] =
          m[i] + logf(l[i] > 0.f ? l[i] : 1.f);
  }
}

// dk and dv of the tile's keys into columns c1 .. c1 + D of contiguous (b,
// sk, h, dn); dk scaled
template <typename T, int D, int M>
__device__ __forceinline__ void store_dkv(const float (&dka)[M][D / 16],
                                          const float (&dva)[M][D / 16], T* dk,
                                          T* dv, int bb, int hh, int h, int k0,
                                          int sk, int dn, float scale, int ty,
                                          int tx, int c1 = 0) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int key = k0 + ty * M + i;
    if (key >= sk) continue;
    const long long o = ((static_cast<long long>(bb) * sk + key) * h + hh) * dn + c1;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      if (c1 + tx + 16 * c >= dn) continue;
      dk[o + tx + 16 * c] = from_f32<T>(dka[i][c] * scale);
      dv[o + tx + 16 * c] = from_f32<T>(dva[i][c]);
    }
  }
}

// keep-bit bytes of a tile, in floats (0 without dropout)
template <int M, bool DROP>
__host__ __device__ constexpr int keep_floats() {
  return DROP ? Tile<M>::B * Tile<M>::Groups / 4 : 0;
}

// shared memory of a forward CTA: q rows, k^T and v^T, p tile, keep bits
template <int D, int M, bool DROP>
__host__ __device__ constexpr int fwd_smem_floats() {
  return Tile<M>::B * (D + 1) + 2 * D * Tile<M>::Pad + Tile<M>::B * Tile<M>::Pad +
         keep_floats<M, DROP>();
}

// of a backward CTA: k^T and v^T, q and dout rows, p/ds, lse and delta,
// keep bits
template <int D, int M, bool DROP>
__host__ __device__ constexpr int bwd_smem_floats() {
  return 2 * D * Tile<M>::Pad + 2 * Tile<M>::B * (D + 1) + Tile<M>::B * Tile<M>::Pad +
         2 * Tile<M>::B + keep_floats<M, DROP>();
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
