// Flash cross-entropy: the tied LM head's logits, softmax cross-entropy and
// its gradients without the [tokens, vocab] logits in device memory. Kernel
// K9 (forward) and kernels K10 (dx) and K11 (dw, db) of the port.
//
// Replaces: paddle_tpu/ops/pallas/fused_ce.py::_ce_fwd_kernel (K9),
// ::_ce_dx_kernel (K10) and ::_ce_dw_kernel (K11), behind
// ops/fused.py::fused_linear_cross_entropy under FLAGS_enable_flash_ce.
//
// Math (the Pallas kernels'): s = x . w^T (+ b) in fp32; forward keeps an
// online logsumexp over vocab blocks and picks the label logit from the
// fp32 tile (loss = lse - s[y]); backward recomputes each tile,
// dl = (exp(s - lse) - onehot(y)) * g in fp32, rounds dl to the operand
// type and takes dx = dl . w and dw = dl^T . x with fp32 accumulation;
// db sums the fp32 dl. Vocab columns >= V and tokens >= N count as absent
// (p = 0, dl = 0); nothing is padded in memory.
//
// Bound on the H100: operations. At the GPT-2 124M train step (N 24576,
// H 768, V 50304, bf16) the forward is 2*N*V*H = 1.90 TFLOP (1.92 ms at
// 989 TFLOP/s) and each backward kernel twice that (recompute + product);
// x (38 MB) and w (77 MB) are read far below the byte bound.
//
// Design: every CTA (256 threads, 8 warps) holds one resident block R of
// 32 rows x H in shared memory and streams blocks T of 32 rows x H through
// one or two shared buffers (cp.async; two when they fit). Each step forms
// the 32 x 32 tile S = R . T^T with warp-level tensor-core products
// (mma.sync m16n8k16, bf16 in, fp32 accumulate; the cp.async, ldmatrix and
// mma primitives are shared with K1/K3 in csrc/mma.cuh). The warps split the
// hidden width: each forms the whole 32 x 32 tile over H / 8 of it (eight
// independent mma chains a warp, every R and T element read from shared
// memory once) and writes its fp32 partial tile; the consumers of S sum the
// eight partials in a fixed order.
//  - K9: R = x tokens, T = w vocab blocks. 8 threads a token row keep the
//    running max, sum and picked logit with shuffles; loss and lse are
//    written once a row.
//  - K10: R = x tokens, T = w vocab blocks. dl (32 tokens x 32 vocab) goes
//    to shared memory in the operand type, then dx[32 x H] += dl . T, the
//    32 x H fp32 accumulator spread over the 8 warps' registers (H/8
//    values a thread).
//  - K11: R = w vocab rows, T = x token blocks: the same loop on the
//    transposed tile (dl^T), dw[32 x H] += dl^T . T, and db from the fp32
//    dl summed in a fixed order.
// Each CTA owns its output rows, so there are no atomics and every result
// is deterministic; the TPU kernels' sequential-grid scratch becomes the
// CTA's loop over T blocks.
// Widths whose R block and T buffers do not fit a CTA's shared memory (above
// 1024; fp32 above 768 in the backward) stream the hidden width instead:
// each T block's S is accumulated over 256-column chunks of R and T staged
// in turn (the same per-warp split, summed in a fixed order, so the bits
// repeat), and the backward splits its output columns over a second grid
// dimension in pieces of up to 768 (a piece's 32 x piece accumulator is
// what one CTA's registers hold): each piece's CTA recomputes S and dl and
// multiplies dl by the staged T columns of its piece.
// bf16 and fp16 take the tensor cores (mma.sync m16n8k16 of either type).
// fp32 operands (the CPU-parity model, and a mixed x/w pair that the
// wrapper widens) run the same loops with plain FMA in place of mma.sync;
// round_dl rounds dl to bf16 or fp16 there when the reference casts dl to
// a 2-byte operand's type.
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace ptt {
namespace {

constexpr int kRows = 32;     // rows of R and of each T block
constexpr int kChunk = 256;   // hidden columns a streamed chunk
constexpr int kThreads = 256;
constexpr int kPStride = kRows + 8;  // fp32 row stride of a partial S tile
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;

template <typename T>
__host__ __device__ constexpr int row_stride(int h) {
  return h + 16 / static_cast<int>(sizeof(T));  // 16 bytes of padding a row
}
template <typename T>
__host__ __device__ constexpr int dl_stride() {
  return kRows + 16 / static_cast<int>(sizeof(T));
}

// partial S tiles a step: the bf16 path splits the hidden width over the 8
// warps, the fp32 FMA path forms S in one piece
template <typename T>
__host__ __device__ constexpr int s_parts() {
  return sizeof(T) == 2 ? kThreads / 32 : 1;
}

template <typename T>
size_t smem_bytes(int h, int nbuf, bool with_dl) {
  size_t b = static_cast<size_t>(1 + nbuf) * kRows * row_stride<T>(h) * sizeof(T) +
             static_cast<size_t>(s_parts<T>()) * kRows * kPStride * sizeof(float);
  if (with_dl) b += static_cast<size_t>(kRows) * dl_stride<T>() * sizeof(T);
  return b;
}

// two T buffers when they fit in a CTA's shared memory, else one; 0: H too wide
template <typename T>
int pick_nbuf(int h, bool with_dl) {
  if (smem_bytes<T>(h, 2, with_dl) <= kMaxSmem) return 2;
  if (smem_bytes<T>(h, 1, with_dl) <= kMaxSmem) return 1;
  return 0;
}

// Copy rows [row0, row0 + kRows) of src (rows of h elements) into dst (row
// stride `stride`) with 16-byte cp.async (csrc/mma.cuh); rows >= nrows are
// zero-filled.
template <typename T>
__device__ void load_rows(T* dst, const T* src, int row0, int nrows, int h,
                          int stride) {
  copy_rows(dst, stride, src, h, row0, kRows, nrows, h, kThreads);
}

// Accumulator layout of an m16n8 tile (mma.sync): thread (g = lane / 4,
// t = lane % 4) holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). The fp32
// versions below compute the same elements with FMA.

// A warp's share of S = R . T^T, accumulated over hidden chunks: the
// 2-byte path's c[2][4][4] (two m16 halves times four n8 tiles of the whole
// 32 x 32 tile over the warp's slice of each chunk), the fp32 path's c[0][0]
// (the warp's own 16 x 8 tile over all of each chunk).
struct SAcc {
  float c[2][4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[mi][j][0] = c[mi][j][1] = c[mi][j][2] = c[mi][j][3] = 0.f;
  }
};

// acc += R[32 x kw] . T[32 x kw]^T over warp w's slice [w * kw, (w + 1) * kw)
// of the hw columns staged in R and T, kw = hw / 8 (a multiple of 16): 8
// mma a k16 step.
template <typename T>
__device__ __forceinline__ void s_accum(const T* R, const T* Tt, int hw, int stride,
                                        SAcc& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = hw / s_parts<T>(), k0 = warp * kw;
  // A: rows lane & 15 (+16), k half lane >> 4. B (ldmatrix x4 = two n8
  // tiles x k16): rows (lane & 7) + 8 * (lane >> 4), k half (lane >> 3) & 1.
  const T* ap = R + (lane & 15) * stride + (lane >> 4) * 8 + k0;
  const T* bp = Tt + ((lane & 7) + ((lane >> 4) << 3)) * stride + ((lane >> 3) & 1) * 8 + k0;
  for (int k = 0; k < kw; k += 16) {
    uint32_t a[2][4], b[2][4];
    ldm_x4(a[0], ap + k);
    ldm_x4(a[1], ap + 16 * stride + k);
    ldm_x4(b[0], bp + k);
    ldm_x4(b[1], bp + 16 * stride + k);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma16816<T>(acc.c[mi][j], a[mi], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
  }
}

// the fp32 path: the warp's 16 x 8 tile at rows 16 * (w & 1), cols
// 8 * (w >> 1), over all hw staged columns
template <>
__device__ __forceinline__ void s_accum<float>(const float* R, const float* Tt, int hw,
                                               int stride, SAcc& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * 8;
  const int g = lane >> 2, t = lane & 3;
  const float* r0 = R + (m0 + g) * stride;
  const float* r1 = r0 + 8 * stride;
  const float* t0 = Tt + (n0 + 2 * t) * stride;
  const float* t1 = t0 + stride;
  float* c = acc.c[0][0];
  for (int k = 0; k < hw; ++k) {
    const float a = r0[k], b = r1[k], x = t0[k], y = t1[k];
    c[0] = fmaf(a, x, c[0]);
    c[1] = fmaf(a, y, c[1]);
    c[2] = fmaf(b, x, c[2]);
    c[3] = fmaf(b, y, c[3]);
  }
}

// the warp's accumulated share into S: partial tile P[w] (fp32, row stride
// kPStride) on the 2-byte path, the warp's 16 x 8 tile of S on the fp32 path
template <typename T>
__device__ __forceinline__ void s_store(const SAcc& acc, float* S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* p = S + warp * kRows * kPStride + g * kPStride + 2 * t;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* q = p + mi * 16 * kPStride + j * 8;
      *reinterpret_cast<float2*>(q) = make_float2(acc.c[mi][j][0], acc.c[mi][j][1]);
      *reinterpret_cast<float2*>(q + 8 * kPStride) =
          make_float2(acc.c[mi][j][2], acc.c[mi][j][3]);
    }
}

template <>
__device__ __forceinline__ void s_store<float>(const SAcc& acc, float* S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * 8;
  const int g = lane >> 2, t = lane & 3;
  const float* c = acc.c[0][0];
  float* s0 = S + (m0 + g) * kPStride + n0 + 2 * t;
  s0[0] = c[0];
  s0[1] = c[1];
  s0[8 * kPStride] = c[2];
  s0[8 * kPStride + 1] = c[3];
}

// S (partial tiles, or the fp32 tile) = R[32 x h] . T[32 x h]^T, R and T
// resident
template <typename T>
__device__ __forceinline__ void s_tile(const T* R, const T* Tt, int h, int stride,
                                       float* S) {
  SAcc acc;
  acc.zero();
  s_accum<T>(R, Tt, h, stride, acc);
  s_store<T>(acc, S);
}

// S[r][c .. c + 3]: the sum of the partial tiles, in warp order
template <typename T>
__device__ __forceinline__ void s_row4(const float* S, int r, int c, float* out) {
  float4 v = *reinterpret_cast<const float4*>(S + r * kPStride + c);
#pragma unroll
  for (int w = 1; w < s_parts<T>(); ++w) {
    const float4 u = *reinterpret_cast<const float4*>(S + (w * kRows + r) * kPStride + c);
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// acc[32 x h] += DL[32 x 32] . T[32 x h]; warp w owns columns
// [w * NT * 8, (w + 1) * NT * 8) as NT n8 tiles over both m16 halves.
template <int NT, typename T>
__device__ void acc_product(float (&acc)[2][NT][4], const T* DL, const T* Tt, int stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = warp * NT * 8;
  constexpr int dls = dl_stride<T>();
#pragma unroll
  for (int kk = 0; kk < kRows; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldm_x4(a[mi], DL + (mi * 16 + (lane & 15)) * dls + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldm_x4_trans(b, Tt + (kk + (lane & 15)) * stride + col0 + j * 8 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma16816<T>(acc[mi][j], a[mi], b[0], b[1]);
        mma16816<T>(acc[mi][j + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

template <int NT>
__device__ void acc_product(float (&acc)[2][NT][4], const float* DL, const float* Tt,
                            int stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = warp * NT * 8 + 2 * t;
  constexpr int dls = dl_stride<float>();
  for (int k = 0; k < kRows; ++k) {
    const float a[2][2] = {{DL[g * dls + k], DL[(g + 8) * dls + k]},
                           {DL[(g + 16) * dls + k], DL[(g + 24) * dls + k]}};
    const float* tr = Tt + k * stride + col0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = tr[j * 8], b1 = tr[j * 8 + 1];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][j][0] = fmaf(a[mi][0], b0, acc[mi][j][0]);
        acc[mi][j][1] = fmaf(a[mi][0], b1, acc[mi][j][1]);
        acc[mi][j][2] = fmaf(a[mi][1], b0, acc[mi][j][2]);
        acc[mi][j][3] = fmaf(a[mi][1], b1, acc[mi][j][3]);
      }
    }
  }
}

__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stage T block `it` (one buffer) or T block it + 1 (two buffers) and wait
// until block `it` and R have landed.
template <typename T>
__device__ __forceinline__ T* stage(T* Tb, const T* src, int it, int nt, int total,
                                    int h, int stride, int nbuf) {
  const int blk = kRows * stride;
  if (nbuf == 1) {
    load_rows(Tb, src, it * kRows, total, h, stride);
    cp_commit();
    cp_wait<0>();
  } else if (it + 1 < nt) {
    load_rows(Tb + ((it + 1) & 1) * blk, src, (it + 1) * kRows, total, h, stride);
    cp_commit();
    cp_wait<1>();
  } else {
    cp_wait<0>();
  }
  __syncthreads();
  return Tb + (nbuf == 2 ? (it & 1) * blk : 0);
}

// S = R . T^T of T block `it`, the hidden width streamed through R and T
// chunk buffers kChunk columns at a time (the last chunk may be 128; rows of
// the operands at stride h, chunk rows at stride `stride`); S's partial
// tiles hold the sum over the chunks in a fixed order. Ends with S written
// and the CTA synchronised.
template <typename T>
__device__ __forceinline__ void s_streamed(T* R, T* Tc, const T* rsrc, const T* tsrc,
                                           int r0, int r_total, int t0, int t_total,
                                           int h, int stride, float* S) {
  SAcc acc;
  acc.zero();
  for (int c0 = 0; c0 < h; c0 += kChunk) {
    const int hw = min(kChunk, h - c0);
    __syncthreads();  // the previous chunk (or tile) is no longer read
    copy_rows(R, stride, rsrc + c0, h, r0, kRows, r_total, hw, kThreads);
    copy_rows(Tc, stride, tsrc + c0, h, t0, kRows, t_total, hw, kThreads);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    s_accum<T>(R, Tc, hw, stride, acc);
  }
  s_store<T>(acc, S);
  __syncthreads();
}

// The forward's step over S of vocab block `it`: thread (er, ec) updates its
// token row's running max m, sum l and picked label logit.
template <typename T>
__device__ __forceinline__ void lse_step(const float* S, int it, int vocab,
                                         const float* bias, int lab, int er, int ec,
                                         float& m, float& l, float& picked) {
  float sv[4];
  s_row4<T>(S, er, ec, sv);
  float tmax = -CUDART_INF_F;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int voc = it * kRows + ec + q;
    // vocab columns past V are absent
    sv[q] = voc < vocab ? sv[q] + (bias ? bias[voc] : 0.f) : -CUDART_INF_F;
    tmax = fmaxf(tmax, sv[q]);
    if (voc == lab) picked += sv[q];
  }
  const float m_new = fmaxf(m, group8_max(tmax));
  float ps = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) ps += expf(sv[q] - m_new);
  l = l * expf(m - m_new) + group8_sum(ps);
  m = m_new;
}

// loss and lse of the thread's token row, once a row
__device__ __forceinline__ void lse_store(float* loss, float* lse, int tok, int n_tok,
                                          float m, float l, float picked) {
  picked = group8_sum(picked);
  if ((threadIdx.x & 7) == 0 && tok < n_tok) {
    const float v = m + logf(l);
    lse[tok] = v;
    loss[tok] = v - picked;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, const int* __restrict__ label,
                  float* __restrict__ loss, float* __restrict__ lse, int n_tok,
                  int vocab, int h, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = row_stride<T>(h);
  T* R = reinterpret_cast<T*>(smem);
  T* Tb = R + kRows * stride;
  float* S = reinterpret_cast<float*>(Tb + nbuf * kRows * stride);
  const int r0 = blockIdx.x * kRows;
  const int nt = (vocab + kRows - 1) / kRows;
  load_rows(R, x, r0, n_tok, h, stride);
  cp_commit();
  if (nbuf == 2) {
    load_rows(Tb, w, 0, vocab, h, stride);
    cp_commit();
  }
  const int er = threadIdx.x >> 3, ec = (threadIdx.x & 7) * 4;
  const int tok = r0 + er;
  const int lab = tok < n_tok ? label[tok] : -1;
  float m = kNegInf, l = 0.f, picked = 0.f;
  for (int it = 0; it < nt; ++it) {
    const T* Tt = stage(Tb, w, it, nt, vocab, h, stride, nbuf);
    s_tile(R, Tt, h, stride, S);
    __syncthreads();
    lse_step<T>(S, it, vocab, bias, lab, er, ec, m, l, picked);
    __syncthreads();
  }
  lse_store(loss, lse, tok, n_tok, m, l, picked);
}

// the forward with the hidden width streamed (widths whose R block does not
// stay in shared memory)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ bias, const int* __restrict__ label,
                         float* __restrict__ loss, float* __restrict__ lse, int n_tok,
                         int vocab, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int stride = row_stride<T>(kChunk);
  T* R = reinterpret_cast<T*>(smem);
  T* Tc = R + kRows * stride;
  float* S = reinterpret_cast<float*>(Tc + kRows * stride);
  const int r0 = blockIdx.x * kRows;
  const int nt = (vocab + kRows - 1) / kRows;
  const int er = threadIdx.x >> 3, ec = (threadIdx.x & 7) * 4;
  const int tok = r0 + er;
  const int lab = tok < n_tok ? label[tok] : -1;
  float m = kNegInf, l = 0.f, picked = 0.f;
  for (int it = 0; it < nt; ++it) {
    s_streamed(R, Tc, x, w, r0, n_tok, it * kRows, vocab, h, stride, S);
    lse_step<T>(S, it, vocab, bias, lab, er, ec, m, l, picked);
  }
  lse_store(loss, lse, tok, n_tok, m, l, picked);
}

// what a backward CTA's dl phase reads: its R rows' per-row terms
struct DlRow {
  float lse, g, bias;
  int lab;
};

// The backward's dl phase over S of T block `it`: thread (er, ec) forms
// dl = (exp(s - lse) - onehot(y)) * g for its R row and 4 columns, rounded
// (round_dl: 1 to bf16, 2 to fp16, on the fp32 path) and stored to DL in
// T's type; returns its fp32 row sum (K11's db).
template <typename T>
__device__ __forceinline__ float dl_step(const float* S, int it, bool dx_mode, int rr,
                                         const DlRow& row, const int* label,
                                         const float* lse, const float* g,
                                         const float* bias, int n_tok, int vocab,
                                         int er, int ec, int round_dl, T* DL) {
  constexpr int dls = dl_stride<T>();
  float sv[4];
  s_row4<T>(S, er, ec, sv);
  float rowsum = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cc = it * kRows + ec + q;
    int tok, voc, lab;
    float lv, gv, b;
    if (dx_mode) {
      tok = rr; voc = cc; lab = row.lab; lv = row.lse; gv = row.g;
      b = (bias != nullptr && voc < vocab) ? bias[voc] : 0.f;
    } else {
      tok = cc; voc = rr; b = row.bias;
      const bool ok = tok < n_tok;
      lab = ok ? label[tok] : -1;
      lv = ok ? lse[tok] : 0.f;
      gv = ok ? g[tok] : 0.f;
    }
    float d = 0.f;
    if (tok < n_tok && voc < vocab) {
      const float s = sv[q] + b;
      d = (expf(s - lv) - (voc == lab ? 1.f : 0.f)) * gv;
    }
    rowsum += d;
    if (round_dl)
      d = round_dl == 1 ? __bfloat162float(__float2bfloat16(d)) : __half2float(__float2half(d));
    DL[er * dls + ec + q] = from_f32<T>(d);
  }
  return rowsum;
}

// the per-row terms of the thread's R row
__device__ __forceinline__ DlRow dl_row(bool dx_mode, int rr, int n_tok, int vocab,
                                        const float* lse, const float* g, const int* label,
                                        const float* bias) {
  DlRow row{0.f, 0.f, 0.f, -1};
  if (dx_mode && rr < n_tok) {
    row.lse = lse[rr];
    row.g = g[rr];
    row.lab = label[rr];
  }
  if (!dx_mode && bias != nullptr && rr < vocab) row.bias = bias[rr];
  return row;
}

// the 32 x (8 NT warps' columns) accumulator into rows r0.. of out (row
// stride h), columns from col0
template <typename T, int NT>
__device__ __forceinline__ void store_rows(const float (&acc)[2][NT][4], T* out, int r0,
                                           int r_total, int h, int col0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + mi * 16 + gq + 8 * half;
      if (row >= r_total) continue;
      T* o = out + static_cast<size_t>(row) * h + col0 + warp * NT * 8 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j * 8] = from_f32<T>(acc[mi][j][2 * half]);
        o[j * 8 + 1] = from_f32<T>(acc[mi][j][2 * half + 1]);
      }
    }
  }
}

// mode 0 (K10): R = x, T = w blocks, out = dx [n_tok, h].
// mode 1 (K11): R = w, T = x blocks, out = dw [vocab, h], db [vocab] (or null).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, const int* __restrict__ label,
                  const float* __restrict__ g, const float* __restrict__ lse,
                  T* __restrict__ out, float* __restrict__ db, int n_tok, int vocab,
                  int h, int mode, int nbuf, int round_dl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = row_stride<T>(h);
  T* R = reinterpret_cast<T*>(smem);
  T* Tb = R + kRows * stride;
  float* S = reinterpret_cast<float*>(Tb + nbuf * kRows * stride);
  T* DL = reinterpret_cast<T*>(S + s_parts<T>() * kRows * kPStride);
  const bool dx_mode = mode == 0;
  const T* rsrc = dx_mode ? x : w;
  const T* tsrc = dx_mode ? w : x;
  const int r_total = dx_mode ? n_tok : vocab;
  const int t_total = dx_mode ? vocab : n_tok;
  const int r0 = blockIdx.x * kRows;
  const int nt = (t_total + kRows - 1) / kRows;
  load_rows(R, rsrc, r0, r_total, h, stride);
  cp_commit();
  if (nbuf == 2) {
    load_rows(Tb, tsrc, 0, t_total, h, stride);
    cp_commit();
  }
  // dl phase: thread owns row er (an R row) and columns ec .. ec + 3
  const int er = threadIdx.x >> 3, ec = (threadIdx.x & 7) * 4;
  const int rr = r0 + er;
  const DlRow row = dl_row(dx_mode, rr, n_tok, vocab, lse, g, label, bias);
  float db_acc = 0.f;
  float acc[2][NT][4] = {};
  for (int it = 0; it < nt; ++it) {
    const T* Tt = stage(Tb, tsrc, it, nt, t_total, h, stride, nbuf);
    s_tile(R, Tt, h, stride, S);
    __syncthreads();
    float rowsum = dl_step<T>(S, it, dx_mode, rr, row, label, lse, g, bias, n_tok, vocab,
                              er, ec, round_dl, DL);
    if (!dx_mode) {
      rowsum = group8_sum(rowsum);
      if ((threadIdx.x & 7) == 0) db_acc += rowsum;
    }
    __syncthreads();
    acc_product<NT>(acc, DL, Tt, stride);
    __syncthreads();
  }
  store_rows<T, NT>(acc, out, r0, r_total, h, 0);
  if (!dx_mode && db != nullptr && (threadIdx.x & 7) == 0 && rr < vocab) db[rr] = db_acc;
}

// the backward with the hidden width streamed: CTA (row block, piece)
// computes S over the whole width in chunks, then the output columns
// [piece * 8 NT * 8, ...) of its rows from a staged T piece; the piece-0
// CTAs write db
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ bias, const int* __restrict__ label,
                         const float* __restrict__ g, const float* __restrict__ lse,
                         T* __restrict__ out, float* __restrict__ db, int n_tok, int vocab,
                         int h, int mode, int round_dl) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int stride = row_stride<T>(kChunk);
  constexpr int kPiece = 8 * NT * 8;  // output columns a CTA
  constexpr int pstride = row_stride<T>(kPiece);
  T* R = reinterpret_cast<T*>(smem);
  T* Tc = R + kRows * stride;
  float* S = reinterpret_cast<float*>(Tc + kRows * stride);
  T* DL = reinterpret_cast<T*>(S + s_parts<T>() * kRows * kPStride);
  T* Tp = DL + kRows * dl_stride<T>();
  const bool dx_mode = mode == 0;
  const T* rsrc = dx_mode ? x : w;
  const T* tsrc = dx_mode ? w : x;
  const int r_total = dx_mode ? n_tok : vocab;
  const int t_total = dx_mode ? vocab : n_tok;
  const int r0 = blockIdx.x * kRows;
  const int p0 = blockIdx.y * kPiece;
  const int nt = (t_total + kRows - 1) / kRows;
  const int er = threadIdx.x >> 3, ec = (threadIdx.x & 7) * 4;
  const int rr = r0 + er;
  const DlRow row = dl_row(dx_mode, rr, n_tok, vocab, lse, g, label, bias);
  float db_acc = 0.f;
  float acc[2][NT][4] = {};
  for (int it = 0; it < nt; ++it) {
    __syncthreads();  // the previous product no longer reads Tp and DL
    copy_rows(Tp, pstride, tsrc + p0, h, it * kRows, kRows, t_total, kPiece, kThreads);
    cp_commit();
    s_streamed(R, Tc, rsrc, tsrc, r0, r_total, it * kRows, t_total, h, stride, S);
    float rowsum = dl_step<T>(S, it, dx_mode, rr, row, label, lse, g, bias, n_tok, vocab,
                              er, ec, round_dl, DL);
    if (!dx_mode) {
      rowsum = group8_sum(rowsum);
      if ((threadIdx.x & 7) == 0) db_acc += rowsum;
    }
    __syncthreads();
    acc_product<NT>(acc, DL, Tp, pstride);
  }
  store_rows<T, NT>(acc, out, r0, r_total, h, p0);
  if (!dx_mode && db != nullptr && blockIdx.y == 0 && (threadIdx.x & 7) == 0 && rr < vocab)
    db[rr] = db_acc;
}

// the widths whose R block stays in shared memory: up to 1024, where the
// buffers fit
template <typename T>
bool resident(int h, bool with_dl) {
  return h <= 1024 && pick_nbuf<T>(h, with_dl) > 0;
}

template <typename T>
size_t stream_smem_bytes(int piece) {
  size_t b = 2 * static_cast<size_t>(kRows) * row_stride<T>(kChunk) * sizeof(T) +
             static_cast<size_t>(s_parts<T>()) * kRows * kPStride * sizeof(float);
  if (piece > 0)
    b += static_cast<size_t>(kRows) * (dl_stride<T>() + row_stride<T>(piece)) * sizeof(T);
  return b;
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* bias, const void* label,
               void* loss, void* lse, int n_tok, int vocab, int h, cudaStream_t s) {
  const unsigned grid = (n_tok + kRows - 1) / kRows;
  cudaError_t e;
  if (resident<T>(h, false)) {
    const int nbuf = pick_nbuf<T>(h, false);
    const size_t bytes = smem_bytes<T>(h, nbuf, false);
    e = cudaFuncSetAttribute(ce_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    ce_fwd_kernel<T><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const float*>(bias), static_cast<const int*>(label),
        static_cast<float*>(loss), static_cast<float*>(lse), n_tok, vocab, h, nbuf);
    return cudaGetLastError();
  }
  const size_t bytes = stream_smem_bytes<T>(0);
  e = cudaFuncSetAttribute(ce_fwd_stream_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  ce_fwd_stream_kernel<T><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(label), static_cast<float*>(loss), static_cast<float*>(lse),
      n_tok, vocab, h);
  return cudaGetLastError();
}

template <typename T, int NT>
int launch_bwd_nt(const void* x, const void* w, const void* bias, const void* label,
                  const void* g, const void* lse, void* out, void* db, int n_tok,
                  int vocab, int h, int mode, int round_dl, bool res, cudaStream_t s) {
  const int rows = mode == 0 ? n_tok : vocab;
  const unsigned grid = (rows + kRows - 1) / kRows;
  cudaError_t e;
  if (res) {  // NT = h / 64
    const int nbuf = pick_nbuf<T>(h, true);
    const size_t bytes = smem_bytes<T>(h, nbuf, true);
    e = cudaFuncSetAttribute(ce_bwd_kernel<T, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    ce_bwd_kernel<T, NT><<<grid, kThreads, bytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const float*>(bias), static_cast<const int*>(label),
        static_cast<const float*>(g), static_cast<const float*>(lse),
        static_cast<T*>(out), static_cast<float*>(db), n_tok, vocab, h, mode, nbuf,
        round_dl);
    return cudaGetLastError();
  }
  const size_t bytes = stream_smem_bytes<T>(NT * 64);
  e = cudaFuncSetAttribute(ce_bwd_stream_kernel<T, NT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  ce_bwd_stream_kernel<T, NT><<<dim3(grid, h / (NT * 64)), kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(label), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<T*>(out), static_cast<float*>(db), n_tok,
      vocab, h, mode, round_dl);
  return cudaGetLastError();
}

// the output columns a streamed backward CTA takes: the widest multiple of
// 128 up to 768 that divides h
int piece_of(int h) {
  for (int p = 768; p >= 128; p -= 128)
    if (h % p == 0) return p;
  return 0;
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* bias, const void* label,
               const void* g, const void* lse, void* out, void* db, int n_tok,
               int vocab, int h, int mode, int round_dl, cudaStream_t s) {
  // resident widths take NT = h / 64 (the whole width); streamed ones a piece
  const bool res = resident<T>(h, true);
  const int width = res ? h : piece_of(h);
#define PTT_CE_NT(NT)                                                                \
  case NT:                                                                           \
    return launch_bwd_nt<T, NT>(x, w, bias, label, g, lse, out, db, n_tok, vocab, h, \
                                mode, round_dl, res, s);
  switch (width / 64) {
    PTT_CE_NT(2)
    PTT_CE_NT(4)
    PTT_CE_NT(6)
    PTT_CE_NT(8)
    PTT_CE_NT(10)
    PTT_CE_NT(12)
    PTT_CE_NT(14)
    PTT_CE_NT(16)
  }
#undef PTT_CE_NT
  return cudaErrorInvalidValue;
}

bool hidden_ok(int h) { return h > 0 && h % 128 == 0; }

}  // namespace
}  // namespace ptt

// loss, lse: fp32 [n_tok]; label: int32 [n_tok] in [0, vocab); bias: fp32
// [vocab] or null. x [n_tok, hidden] and w [vocab, hidden] share `dtype`;
// hidden is any multiple of 128.
extern "C" int ptt_fused_ce_fwd(const void* x, const void* w, const void* bias,
                                const void* label, void* loss, void* lse, int n_tok,
                                int vocab, int hidden, int dtype, void* stream) {
  using namespace ptt;
  if (!hidden_ok(hidden) || n_tok <= 0 || vocab <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_fwd<float>(x, w, bias, label, loss, lse, n_tok, vocab, hidden, s);
    case kBFloat16: return launch_fwd<__nv_bfloat16>(x, w, bias, label, loss, lse, n_tok, vocab, hidden, s);
    case kFloat16: return launch_fwd<__half>(x, w, bias, label, loss, lse, n_tok, vocab, hidden, s);
  }
  return cudaErrorInvalidValue;
}

// mode 0: out = dx [n_tok, hidden]; mode 1: out = dw [vocab, hidden] and db
// (fp32 [vocab], or null). g and lse: fp32 [n_tok] (g already 0 at ignored
// labels). round_dl: round dl before the product to bf16 (1) or fp16 (2)
// (fp32 operands only).
extern "C" int ptt_fused_ce_bwd(const void* x, const void* w, const void* bias,
                                const void* label, const void* g, const void* lse,
                                void* out, void* db, int n_tok, int vocab, int hidden,
                                int mode, int round_dl, int dtype, void* stream) {
  using namespace ptt;
  if (!hidden_ok(hidden) || n_tok <= 0 || vocab <= 0 || (mode != 0 && mode != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_bwd<float>(x, w, bias, label, g, lse, out, db, n_tok, vocab, hidden, mode, round_dl, s);
    case kBFloat16:
      if (round_dl) return cudaErrorInvalidValue;
      return launch_bwd<__nv_bfloat16>(x, w, bias, label, g, lse, out, db, n_tok, vocab, hidden, mode, 0, s);
    case kFloat16:
      if (round_dl) return cudaErrorInvalidValue;
      return launch_bwd<__half>(x, w, bias, label, g, lse, out, db, n_tok, vocab, hidden, mode, 0, s);
  }
  return cudaErrorInvalidValue;
}
