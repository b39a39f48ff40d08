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
// (mma.sync m16n8k16, bf16 in, fp32 accumulate). The warps split the
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
// CTA's loop over T blocks. fp32 operands (the CPU-parity model, and a
// mixed x/w pair that the wrapper widens) run the same loop with plain FMA
// in place of mma.sync; round_dl rounds dl to bf16 there when the
// reference casts dl to a bf16 operand's type.
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace ptt {
namespace {

constexpr int kRows = 32;     // rows of R and of each T block
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy rows [row0, row0 + kRows) of src (rows of h elements) into dst (row
// stride `stride`) with 16-byte cp.async; rows >= nrows are zero-filled.
// Warp w copies rows w, w + 8, ..., its lanes neighbouring 16-byte pieces.
template <typename T>
__device__ void load_rows(T* dst, const T* src, int row0, int nrows, int h,
                          int stride) {
  const int per_row = h * static_cast<int>(sizeof(T)) / 16;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kRows; r += kThreads / 32) {
    const bool ok = row0 + r < nrows;
    const char* g = reinterpret_cast<const char*>(
        src + static_cast<size_t>(ok ? row0 + r : 0) * h);
    const uint32_t s = smem_addr(dst + r * stride);
    const int n = ok ? 16 : 0;
    for (int c = lane; c < per_row; c += 32)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s + c * 16),
                   "l"(g + c * 16), "r"(n)
                   : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// c (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulator layout of an m16n8 tile (mma.sync): thread (g = lane / 4,
// t = lane % 4) holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). The fp32
// versions below compute the same elements with FMA.

// Partial tile P[w] (fp32, row stride kPStride) = R[32 x kw] . T[32 x kw]^T
// over warp w's slice [w * kw, (w + 1) * kw) of the hidden width, kw = h / 8
// (a multiple of 16): two m16 halves times four n8 tiles, 8 mma a k16 step.
__device__ void s_tile(const __nv_bfloat16* R, const __nv_bfloat16* Tt, int h,
                       int stride, float* S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = h / s_parts<__nv_bfloat16>(), k0 = warp * kw;
  float c[2][4][4] = {};
  // A: rows lane & 15 (+16), k half lane >> 4. B (ldmatrix x4 = two n8
  // tiles x k16): rows (lane & 7) + 8 * (lane >> 4), k half (lane >> 3) & 1.
  const __nv_bfloat16* ap = R + (lane & 15) * stride + (lane >> 4) * 8 + k0;
  const __nv_bfloat16* bp =
      Tt + ((lane & 7) + ((lane >> 4) << 3)) * stride + ((lane >> 3) & 1) * 8 + k0;
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
        mma_bf16(c[mi][j], a[mi], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
  }
  const int g = lane >> 2, t = lane & 3;
  float* p = S + warp * kRows * kPStride + g * kPStride + 2 * t;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* q = p + mi * 16 * kPStride + j * 8;
      *reinterpret_cast<float2*>(q) = make_float2(c[mi][j][0], c[mi][j][1]);
      *reinterpret_cast<float2*>(q + 8 * kPStride) = make_float2(c[mi][j][2], c[mi][j][3]);
    }
}

// S[32 x 32] (fp32, stride kPStride) = R[32 x h] . T[32 x h]^T; warp w owns
// the 16 x 8 tile at rows 16 * (w & 1), cols 8 * (w >> 1).
__device__ void s_tile(const float* R, const float* Tt, int h, int stride, float* S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * 8;
  const int g = lane >> 2, t = lane & 3;
  const float* r0 = R + (m0 + g) * stride;
  const float* r1 = r0 + 8 * stride;
  const float* t0 = Tt + (n0 + 2 * t) * stride;
  const float* t1 = t0 + stride;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  for (int k = 0; k < h; ++k) {
    const float a = r0[k], b = r1[k], x = t0[k], y = t1[k];
    c0 = fmaf(a, x, c0);
    c1 = fmaf(a, y, c1);
    c2 = fmaf(b, x, c2);
    c3 = fmaf(b, y, c3);
  }
  float* s0 = S + (m0 + g) * kPStride + n0 + 2 * t;
  s0[0] = c0;
  s0[1] = c1;
  s0[8 * kPStride] = c2;
  s0[8 * kPStride + 1] = c3;
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
template <int NT>
__device__ void acc_product(float (&acc)[2][NT][4], const __nv_bfloat16* DL,
                            const __nv_bfloat16* Tt, int stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = warp * NT * 8;
  constexpr int dls = dl_stride<__nv_bfloat16>();
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
        mma_bf16(acc[mi][j], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][j + 1], a[mi], b[2], b[3]);
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
    __syncthreads();
  }
  picked = group8_sum(picked);
  if ((threadIdx.x & 7) == 0 && tok < n_tok) {
    const float v = m + logf(l);
    lse[tok] = v;
    loss[tok] = v - picked;
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
  constexpr int dls = dl_stride<T>();
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
  float row_lse = 0.f, row_g = 0.f, row_bias = 0.f;
  int row_lab = -1;
  if (dx_mode && rr < n_tok) {
    row_lse = lse[rr];
    row_g = g[rr];
    row_lab = label[rr];
  }
  if (!dx_mode && bias != nullptr && rr < vocab) row_bias = bias[rr];
  float db_acc = 0.f;
  float acc[2][NT][4] = {};
  for (int it = 0; it < nt; ++it) {
    const T* Tt = stage(Tb, tsrc, it, nt, t_total, h, stride, nbuf);
    s_tile(R, Tt, h, stride, S);
    __syncthreads();
    float sv[4];
    s_row4<T>(S, er, ec, sv);
    float rowsum = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = it * kRows + ec + q;
      int tok, voc, lab;
      float lv, gv, b;
      if (dx_mode) {
        tok = rr; voc = cc; lab = row_lab; lv = row_lse; gv = row_g;
        b = (bias != nullptr && voc < vocab) ? bias[voc] : 0.f;
      } else {
        tok = cc; voc = rr; b = row_bias;
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
      if (round_dl) d = __bfloat162float(__float2bfloat16(d));
      DL[er * dls + ec + q] = from_f32<T>(d);
    }
    if (!dx_mode) {
      rowsum = group8_sum(rowsum);
      if ((threadIdx.x & 7) == 0) db_acc += rowsum;
    }
    __syncthreads();
    acc_product<NT>(acc, DL, Tt, stride);
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + mi * 16 + gq + 8 * half;
      if (row >= r_total) continue;
      T* o = out + static_cast<size_t>(row) * h + warp * NT * 8 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j * 8] = from_f32<T>(acc[mi][j][2 * half]);
        o[j * 8 + 1] = from_f32<T>(acc[mi][j][2 * half + 1]);
      }
    }
  }
  if (!dx_mode && db != nullptr && (threadIdx.x & 7) == 0 && rr < vocab) db[rr] = db_acc;
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* bias, const void* label,
               void* loss, void* lse, int n_tok, int vocab, int h, cudaStream_t s) {
  const int nbuf = pick_nbuf<T>(h, false);
  if (nbuf == 0) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<T>(h, nbuf, false);
  cudaError_t e = cudaFuncSetAttribute(ce_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  ce_fwd_kernel<T><<<(n_tok + kRows - 1) / kRows, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(label),
      static_cast<float*>(loss), static_cast<float*>(lse), n_tok, vocab, h, nbuf);
  return cudaGetLastError();
}

template <typename T, int NT>
int launch_bwd_nt(const void* x, const void* w, const void* bias, const void* label,
                  const void* g, const void* lse, void* out, void* db, int n_tok,
                  int vocab, int h, int mode, int round_dl, cudaStream_t s) {
  const int nbuf = pick_nbuf<T>(h, true);
  if (nbuf == 0) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<T>(h, nbuf, true);
  cudaError_t e = cudaFuncSetAttribute(ce_bwd_kernel<T, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const int rows = mode == 0 ? n_tok : vocab;
  ce_bwd_kernel<T, NT><<<(rows + kRows - 1) / kRows, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(label),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<T*>(out), static_cast<float*>(db), n_tok, vocab, h, mode, nbuf,
      round_dl);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* bias, const void* label,
               const void* g, const void* lse, void* out, void* db, int n_tok,
               int vocab, int h, int mode, int round_dl, cudaStream_t s) {
#define PTT_CE_NT(NT)                                                                \
  case NT:                                                                           \
    return launch_bwd_nt<T, NT>(x, w, bias, label, g, lse, out, db, n_tok, vocab, h, \
                                mode, round_dl, s);
  switch (h / 64) {
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

bool hidden_ok(int h) { return h > 0 && h % 128 == 0 && h <= 1024; }

}  // namespace
}  // namespace ptt

// loss, lse: fp32 [n_tok]; label: int32 [n_tok] in [0, vocab); bias: fp32
// [vocab] or null. x [n_tok, hidden] and w [vocab, hidden] share `dtype`.
extern "C" int ptt_fused_ce_fwd(const void* x, const void* w, const void* bias,
                                const void* label, void* loss, void* lse, int n_tok,
                                int vocab, int hidden, int dtype, void* stream) {
  using namespace ptt;
  if (!hidden_ok(hidden) || n_tok <= 0 || vocab <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_fwd<float>(x, w, bias, label, loss, lse, n_tok, vocab, hidden, s);
    case kBFloat16: return launch_fwd<__nv_bfloat16>(x, w, bias, label, loss, lse, n_tok, vocab, hidden, s);
  }
  return cudaErrorInvalidValue;
}

// mode 0: out = dx [n_tok, hidden]; mode 1: out = dw [vocab, hidden] and db
// (fp32 [vocab], or null). g and lse: fp32 [n_tok] (g already 0 at ignored
// labels). round_dl: round dl to bf16 before the product (fp32 operands only).
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
  }
  return cudaErrorInvalidValue;
}
