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
// K9 at bf16/fp16 (ce_fwd_wgmma_kernel): S = x . w^T is the ordinary "TN"
// product, both operands K-major. A CTA's unit is a stripe of 128 tokens
// against a range of 256-column vocab tiles; a producer warp streams the x
// stripe and the w tile of every 64-column K stage by TMA into a 4-stage
// mbarrier ring (48 KB a stage) for every width, and two consumer
// warpgroups (64 rows each) form S with wgmma m64n256k16 into 128 fp32
// registers a thread. The logsumexp and the label pick run on those
// registers (no S in shared memory). L2 to SM traffic is (128 + 256) * H * 2
// bytes a 128 x 256 tile, 22 GB a call at the train shape. Persistent CTAs
// take units range-major, so the CTAs in flight meet the same w tiles in
// the same order; ranges split the vocabulary where that fills the last
// wave (the plan), their partials merged in range order by a second launch.
//
// K10 and K11 at bf16/fp16 (ce_bwd_cluster_kernel, one template for both
// modes; mode 0 = K10: R = x, T = w; mode 1 = K11: R = w, T = x): a
// thread-block cluster of C CTAs owns 64 R rows, and each CTA a slice of
// the hidden width (128, 256 or 384 columns; C = hidden / slice <= 8). So
// the streamed operand is read once per 64 R rows, and the 64 x slice fp32
// output accumulator fits two warpgroups' registers. A producer warpgroup
// (one working warp, its registers given to the consumers) loads the CTA's
// R slice once and streams its slice of each 64-row T block with TMA (64 x
// 64-element tiles, 128-byte swizzle) into a ring that fills the rest of
// shared memory (12-19 tiles), guarded by full and empty mbarriers, with
// the T rows' per-token terms beside them. Two consumer warpgroups, per T
// block j:
//  1. the CTA's S partial (64 R x 64 T over the slice), computed during
//     block j - 1 with wgmma m64n32k16, each warpgroup 32 of the T rows;
//  2. with C > 1 every CTA has stored its partial into each partner's
//     receive slot (st.async, completing on the partner's mbarrier) and
//     sums the C partials in cluster-rank order, so all hold the same S;
//  3. dl = (exp(s + b - lse) - onehot(y)) * g in fp32, masked at the edges,
//     row sums for K11's db in a fixed order, rounded to the operand type
//     into a swizzled shared tile (two buffers);
//  4. out_slice += dl . T_slice with wgmma m64n64k16, T read as the
//     MN-major operand from the ring, each warpgroup half of the slice,
//     in flight together with the next block's S.
// The epilogue stages the output through shared memory for coalesced
// rows; cluster rank 0 writes db. No atomics, every sum in a fixed order:
// the bits repeat from launch to launch. ptt_fused_ce_plan names the route
// of every width and type (the Python copy: ops/cuda/fused_ce.py::
// kernel_plan). What bounds it on the H100, measured: the T stream from L2
// (each 64 R rows meet all of T: 29.7 GB a call at the train shape; TMA
// delivers about 2.4 TB/s in this pattern) and, with C > 1, the exchange of
// the 16 KB partials between the cluster's CTAs.
//
// K9 at fp32, and the other routes of K10/K11: every CTA (256 threads, 8
// warps) holds one resident block R of
// 32 rows x H in shared memory and streams blocks T of 32 rows x H through
// one or two shared buffers (cp.async; two when they fit). Each step forms
// the 32 x 32 tile S = R . T^T with warp-level tensor-core products
// (mma.sync m16n8k16, bf16 in, fp32 accumulate; the cp.async, ldmatrix and
// mma primitives are shared with K1/K3 in csrc/mma.cuh). The warps split the
// hidden width: each forms the whole 32 x 32 tile over H / 8 of it (eight
// independent mma chains a warp, every R and T element read from shared
// memory once) and writes its fp32 partial tile; the consumers of S sum the
// eight partials in a fixed order.
//  - K9 (fp32): R = x tokens, T = w vocab blocks. 8 threads a token row
//    keep the running max, sum and picked logit with shuffles; loss and
//    lse are written once a row.
//  - K10 (fp32): R = x tokens, T = w vocab blocks. dl (32 tokens x 32
//    vocab) goes to shared memory, then dx[32 x H] += dl . T, the 32 x H
//    fp32 accumulator spread over the 8 warps' registers (H/8 values a
//    thread).
//  - K11 (fp32): R = w vocab rows, T = x token blocks: the same loop on the
//    transposed tile (dl^T), dw[32 x H] += dl^T . T, and db from the fp32
//    dl summed in a fixed order.
// Each CTA owns its output rows, so there are no atomics and every result
// is deterministic; the TPU kernels' sequential-grid scratch becomes the
// CTA's loop over T blocks.
// Widths whose R block and T buffers do not fit a CTA's shared memory (the
// fp32 K9 above 768; the fp32 backward above 768; 2-byte backward widths with no
// cluster split, such as 1408 or 4096) stream the hidden width instead:
// each T block's S is accumulated over 256-column chunks of R and T staged
// in turn (the same per-warp split, summed in a fixed order, so the bits
// repeat), and the backward splits its output columns over a second grid
// dimension in pieces of up to 768 (a piece's 32 x piece accumulator is
// what one CTA's registers hold): each piece's CTA recomputes S and dl and
// multiplies dl by the staged T columns of its piece.
// fp32 operands (the CPU-parity model, and a mixed x/w pair that the
// wrapper widens) run the same loops with plain FMA in place of mma.sync;
// round_dl rounds dl to bf16 or fp16 there when the reference casts dl to
// a 2-byte operand's type.
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace ptt {
namespace {

constexpr int kRows = 32;     // rows of R and of each T block
constexpr int kChunk = 256;   // hidden columns a streamed chunk
constexpr int kThreads = 256;
constexpr int kPStride = kRows + 8;  // fp32 row stride of a partial S tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
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

// ---------------------------------------------------------------------------
// K10 / K11 at bf16 and fp16: the cluster kernel
// ---------------------------------------------------------------------------
constexpr int kCRows = 64;            // R rows a cluster, rows a T block
constexpr int kCThreads = 384;        // two consumer warpgroups, a producer warpgroup
constexpr int kTile = 64 * 64 * 2;    // bytes of a 64 x 64 two-byte TMA tile
constexpr int kSpStride = 72;         // fp32 row stride of a received S partial
constexpr int kRxSlot = kCRows * kSpStride * 4;  // bytes of a received partial
constexpr int kMaxCluster = 8;        // portable cluster size
constexpr int kTermBufs = 4;          // T blocks of per-row terms in flight

// Shared memory of a CTA with NC 64-column chunks a slice in a cluster of C,
// from a 1024-byte aligned base: R slice (NC tiles), dl (2 tiles), T-row
// terms (4 blocks of 64 x {lse, g, label, bias}), db exchange, mbarriers,
// the S partials received from the C - 1 partners, then the ring: as many T
// tiles as the rest holds (17 at NC 6 and C 2, 12 at C 4), so the loads run
// more than a block ahead of the products.
struct ClusterLayout {
  int dl, terms, db, bars, rx, ring, slots;
  __host__ __device__ constexpr ClusterLayout(int nc, int c)
      : dl(nc * kTile),
        terms(dl + 2 * kTile),
        db(terms + kTermBufs * kCRows * 16),
        bars(db + 2 * kCRows * 4),
        rx(bars + 512),
        ring((rx + (c - 1) * kRxSlot + 1023) / 1024 * 1024),
        slots((static_cast<int>(kMaxSmem) - 1024 - ring) / kTile) {}
  // dynamic shared memory to ask for (+ 1024 to align the base)
  __host__ __device__ constexpr int bytes() const { return ring + slots * kTile + 1024; }
};

// the cluster kernel takes (NC, C) when its ring holds two T blocks
__host__ __device__ constexpr bool cluster_fits(int nc, int c) {
  return c >= 1 && c <= kMaxCluster && ClusterLayout(nc, c).slots >= 2 * nc;
}

// The ring position of a T block's first tile: its slot and how often the
// ring had wrapped before it (the parity of its tiles' mbarrier phases),
// advanced a block at a time without a division.
struct RingPos {
  int slot, wraps;
  __device__ __forceinline__ void tile(int c, int slots, int& s, unsigned& parity) const {
    s = slot + c;
    parity = wraps & 1;
    if (s >= slots) {
      s -= slots;
      parity ^= 1;
    }
  }
  __device__ __forceinline__ RingPos next(int nc, int slots) const {
    return slot + nc >= slots ? RingPos{slot + nc - slots, wraps + 1} : RingPos{slot + nc, wraps};
  }
};

// Start (and commit) S of the T block at ring position pos: the warpgroup's
// 32 T rows (wg) against the CTA's 64 R rows over the slice, into s; each
// ring tile is waited for before its products. The caller has fenced s and
// run wgmma.fence.
template <typename T, int NC>
__device__ __forceinline__ void s_start(float (&s)[16], const unsigned char* Rs,
                                        const unsigned char* ring, uint64_t* full, int slots,
                                        RingPos pos, int wg) {
  using namespace hopper;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    int slot;
    unsigned parity;
    pos.tile(c, slots, slot, parity);
    mbar_wait(full + slot, parity);
    const unsigned char* tile = ring + slot * kTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n32k16<T, 0>(s, sw128_desc(Rs + c * kTile + kk * 32),
                            sw128_desc(tile + wg * 4096 + kk * 32), (c | kk) != 0);
  }
  wg_commit();
}

// s = the sum of the cluster's partials at the thread's positions, in rank
// order (the thread's own from its registers, the partners' from the
// receive slots, slot q - (q > rank) for rank q): the same bits in every CTA
__device__ __forceinline__ void s_gather(float (&s)[16], const float* rx, int ra, int c0,
                                         int csize, int rank) {
  float tot[16];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    if (q >= csize) break;
    float part[16];
    if (q == rank) {
#pragma unroll
      for (int e = 0; e < 16; ++e) part[e] = s[e];
    } else {
      const float* sp = rx + (q - (q > rank)) * (kRxSlot / 4);
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        const int col = c0 + jt * 8;
        const float2 v0 = *reinterpret_cast<const float2*>(sp + ra * kSpStride + col);
        const float2 v1 = *reinterpret_cast<const float2*>(sp + (ra + 8) * kSpStride + col);
        part[4 * jt] = v0.x;
        part[4 * jt + 1] = v0.y;
        part[4 * jt + 2] = v1.x;
        part[4 * jt + 3] = v1.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) tot[e] = q == 0 ? part[e] : tot[e] + part[e];
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) s[e] = tot[e];
}

// mode 0 (K10): R = x, T = w, out = dx [n_tok, h].
// mode 1 (K11): R = w, T = x, out = dw [vocab, h], db [vocab] (or null).
// rmap / tmap: tensor maps of R and T ([rows, h], 64 x 64 boxes, 128-byte
// swizzle). Cluster CTA `rank` owns hidden columns [rank, rank + 1) * 64 NC
// of the cluster's 64 R rows.
// The producer warpgroup (one working warp) runs ahead through the ring,
// throttled only by free tiles and term buffers. The consumers' loop is
// software-pipelined: S of block j + 1 and block j's output product are in
// flight together; S(j + 1) is pushed to the partners while the product
// runs, and block j's tiles are released when it is done. With C > 1 every
// CTA stores its S partial into each partner's receive slot with st.async,
// which completes on the partner's `rx` mbarrier; a partner, having read
// it, arrives on the sender's `sfree` before the next partial is sent. The
// cluster barrier runs only at the start (barriers initialised) and at the
// end (no CTA leaves while a partner may still arrive on it).
template <typename T, int NC>
__global__ void __launch_bounds__(kCThreads, 1)
    ce_bwd_cluster_kernel(const __grid_constant__ CUtensorMap rmap,
                          const __grid_constant__ CUtensorMap tmap,
                          const float* __restrict__ bias, const int* __restrict__ label,
                          const float* __restrict__ g, const float* __restrict__ lse,
                          T* __restrict__ out, float* __restrict__ db, int n_tok, int vocab,
                          int h, int mode, int csize) {
  using namespace hopper;
  constexpr int kHalf = NC / 2;  // output chunks a consumer warpgroup
  const ClusterLayout L(NC, csize);
  const int slots = L.slots;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* rfull = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* full = rfull + 1;             // [slots]: ring tile landed
  uint64_t* empty = full + slots;         // [slots]: both warpgroups done with it
  uint64_t* tfull = empty + slots;        // [4]: T-row terms written
  uint64_t* tempty = tfull + kTermBufs;   // [4]: T-row terms read
  uint64_t* rx = tempty + kTermBufs;      // the partners' partials received
  uint64_t* sfree = rx + 1;               // the partners read this CTA's partial
  float4* terms_base = reinterpret_cast<float4*>(sm + L.terms);
  const bool dx_mode = mode == 0;
  const int r_total = dx_mode ? n_tok : vocab;
  const int t_total = dx_mode ? vocab : n_tok;
  const int rank = static_cast<int>(cluster_rank());
  const int r0 = static_cast<int>(cluster_id()) * kCRows;
  const int col0 = rank * NC * 64;
  // T blocks, rounded up to even: the consumers take blocks in pairs and
  // always start the next block's S, so no wgmma is under a branch; the
  // blocks past the tensor are TMA's zero fill, their dl masked to 0
  const int nt = (t_total + 2 * kCRows - 1) / (2 * kCRows) * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(rfull, 1);
    for (int i = 0; i < slots; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2);
    }
    for (int i = 0; i < kTermBufs; ++i) {
      mbar_init(tfull + i, 32);
      mbar_init(tempty + i, 1);
    }
    mbar_init(rx, 1);
    mbar_init(sfree, csize > 1 ? csize - 1 : 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (csize > 1) cluster_sync();  // every CTA's barriers initialised

  if (warp >= 8) {
    // ---- producer warpgroup: TMA and the T rows' terms (warp 8) ----
    setmaxnreg_dec<40>();
    if (warp == 8) {
      if (lane == 0) {
        mbar_expect_tx(rfull, NC * kTile);
        for (int c = 0; c < NC; ++c)
          tma_load_2d(sm + c * kTile, &rmap, rfull, col0 + 64 * c, r0);
      }
      int slot = 0, wraps = 0;  // the next tile's ring slot
      for (int j = 0; j <= nt; ++j) {  // block nt: S only
        for (int c = 0; c < NC; ++c) {
          if (wraps > 0) mbar_wait(empty + slot, (wraps - 1) & 1);
          if (lane == 0) {
            mbar_expect_tx(full + slot, kTile);
            tma_load_2d(sm + L.ring + slot * kTile, &tmap, full + slot, col0 + 64 * c,
                        j * kCRows);
          }
          if (++slot == slots) {
            slot = 0;
            ++wraps;
          }
        }
        if (j == nt) break;
        // terms of T rows j * 64 + i: lse, g, label (K11's tokens), bias
        // (K10's vocab)
        const int tb = j % kTermBufs;
        if (j >= kTermBufs) mbar_wait(tempty + tb, (j / kTermBufs - 1) & 1);
        for (int i = lane; i < kCRows; i += 32) {
          const int t = j * kCRows + i;
          const bool ok = t < t_total;
          float4 v = make_float4(0.f, 0.f, __int_as_float(-1), 0.f);
          if (dx_mode) {
            v.w = ok && bias != nullptr ? bias[t] : 0.f;
          } else if (ok) {
            v.x = lse[t];
            v.y = g[t];
            v.z = __int_as_float(label[t]);
          }
          terms_base[tb * kCRows + i] = v;
        }
        mbar_arrive(tfull + tb);
        __syncwarp();
      }
    }
    if (csize > 1) cluster_sync();  // the end
    return;
  }

  // ---- two consumer warpgroups ----
  setmaxnreg_inc<232>();
  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int ra = (warp & 3) * 16 + (lane >> 2);  // rows ra, ra + 8 of the block
  const int cq = 2 * (lane & 3);                 // column pair in an n8 tile
  const int c0 = wg * 32 + cq;                   // the thread's first S column
  // the R rows' terms: K10's tokens (lse, g, label), K11's vocab rows (bias)
  float rl[2] = {0.f, 0.f}, rgv[2] = {0.f, 0.f}, rb[2] = {0.f, 0.f};
  int rlab[2] = {-1, -1};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int rr = r0 + ra + 8 * q;
    if (rr < r_total) {
      if (dx_mode) {
        rl[q] = lse[rr];
        rgv[q] = g[rr];
        rlab[q] = label[rr];
      } else if (bias != nullptr) {
        rb[q] = bias[rr];
      }
    }
  }
  float dbs[2] = {0.f, 0.f};  // K11: this warpgroup's db of rows ra, ra + 8
  float acc[kHalf][32];
#pragma unroll
  for (int i = 0; i < kHalf; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
  const unsigned char* Rs = sm;
  const unsigned char* ring = sm + L.ring;
  float* rx_base = reinterpret_cast<float*>(sm + L.rx);

  // S(j) in sn, complete: stored into every partner's receive slot for this
  // rank, once the partners have read S(j - 1)
  auto publish = [&](float (&sn)[16], int j) {
    if (j >= 1) mbar_wait_cluster(sfree, (j - 1) & 1);
    for (int q = 0; q < csize; ++q) {
      if (q == rank) continue;
      float* sp = rx_base + (rank - (rank > q)) * (kRxSlot / 4);
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        const int col = c0 + jt * 8;
        st_async_f2(sp + ra * kSpStride + col, make_float2(sn[4 * jt], sn[4 * jt + 1]), rx, q);
        st_async_f2(sp + (ra + 8) * kSpStride + col, make_float2(sn[4 * jt + 2], sn[4 * jt + 3]),
                    rx, q);
      }
    }
  };
  RingPos pos{0, 0};  // block j's first tile
  // one T block: S(j) in sc (this CTA's partial, complete); starts S(j + 1)
  // into sn. Two register sets taken in turn, so no accumulator is copied
  // while its products are in flight.
  auto block = [&](float (&sc)[16], float (&sn)[16], int j) {
    const RingPos next = pos.next(NC, slots);
    const int half = j & 1;
    // S(j): the cluster's sum
    if (csize > 1) {
      if (threadIdx.x == 0) mbar_expect_tx(rx, (csize - 1) * kCRows * kCRows * 4);
      mbar_wait_cluster(rx, j & 1);
      s_gather(sc, rx_base, ra, c0, csize, rank);
    }
    // dl(j), rounded into the swizzled dl tile; K11's row sums
    const int tb = j % kTermBufs;
    mbar_wait(tfull + tb, (j / kTermBufs) & 1);
    const float4* terms = terms_base + tb * kCRows;
    unsigned char* dlt = sm + L.dl + half * kTile;
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int jt = 0; jt < 4; ++jt) {
      const int t = c0 + jt * 8;  // and t + 1
      const float4 tv[2] = {terms[t], terms[t + 1]};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = ra + 8 * q, rr = r0 + r;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tt = j * kCRows + t + e;
          float v = 0.f;
          if (rr < r_total && tt < t_total) {
            const float lv = dx_mode ? rl[q] : tv[e].x;
            const float gv = dx_mode ? rgv[q] : tv[e].y;
            const int lab = dx_mode ? rlab[q] : __float_as_int(tv[e].z);
            const float bv = dx_mode ? tv[e].w : rb[q];
            const int voc = dx_mode ? tt : rr;
            const float sv = sc[4 * jt + 2 * q + e] + bv;
            v = (exp2_approx((sv - lv) * kLog2e) - (voc == lab ? 1.f : 0.f)) * gv;
          }
          d[e] = v;
          rsum[q] += v;
        }
        *reinterpret_cast<uint32_t*>(dlt + r * 128 + (((wg * 4 + jt) ^ (r & 7)) << 4) +
                                     (lane & 3) * 4) = pack2<T>(d[0], d[1]);
      }
    }
    if (!dx_mode) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = rsum[q];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        dbs[q] += v;
      }
    }
    fence_proxy_async();
    named_sync(1, 256);
    // the terms and (C > 1) the partners' partials of block j are read
    if (threadIdx.x == 0) {
      mbar_arrive(tempty + tb);
      if (csize > 1)
        for (int q = 0; q < csize; ++q)
          if (q != rank) mbar_arrive_remote(sfree, q);
    }
    // out_slice[:, this warpgroup's half] += dl(j) . T_slice(j), then S(j + 1)
#pragma unroll
    for (int e = 0; e < 16; ++e) sn[e] = 0.f;
    fence_regs(sn);
#pragma unroll
    for (int i = 0; i < kHalf; ++i) fence_regs(acc[i]);
    wg_fence();
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      int slot;
      unsigned parity;
      pos.tile(wg * kHalf + i, slots, slot, parity);
      const unsigned char* tile = ring + slot * kTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16<T, 1>(acc[i], sw128_desc(dlt + kk * 32), sw128_desc(tile + kk * 2048),
                              1);
    }
    wg_commit();
    s_start<T, NC>(sn, Rs, ring, full, slots, next, wg);
    wg_wait<1>();
#pragma unroll
    for (int i = 0; i < kHalf; ++i) fence_regs(acc[i]);
    // block j's tiles are free once both warpgroups' products are done
    if (tid == 0)
      for (int c = 0; c < NC; ++c) {
        int slot;
        unsigned parity;
        pos.tile(c, slots, slot, parity);
        mbar_arrive(empty + slot);
      }
    wg_wait<0>();
    fence_regs(sn);
    if (csize > 1 && j + 1 < nt) publish(sn, j + 1);
    pos = next;
  };
  float sa[16], sb[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) sa[e] = 0.f;
  mbar_wait(rfull, 0);
  fence_regs(sa);
  wg_fence();
  s_start<T, NC>(sa, Rs, ring, full, slots, pos, wg);
  wg_wait<0>();
  fence_regs(sa);
  if (csize > 1) publish(sa, 0);
  for (int j = 0; j < nt; j += 2) {
    block(sa, sb, j);
    block(sb, sa, j + 1);
  }

  // epilogue: the accumulator rounded into a staging tile in the ring (both
  // warpgroups' products done), then whole rows to device memory
  named_sync(1, 256);
  unsigned char* stage = sm + L.ring;
  const int stride = NC * 64 * 2 + 16;  // staged row bytes: 16 of padding
#pragma unroll
  for (int i = 0; i < kHalf; ++i)
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const int col = (wg * kHalf + i) * 64 + jt * 8 + cq;
      *reinterpret_cast<uint32_t*>(stage + ra * stride + col * 2) =
          pack2<T>(acc[i][4 * jt], acc[i][4 * jt + 1]);
      *reinterpret_cast<uint32_t*>(stage + (ra + 8) * stride + col * 2) =
          pack2<T>(acc[i][4 * jt + 2], acc[i][4 * jt + 3]);
    }
  if (!dx_mode && (lane & 3) == 0) {
    float* dbx = reinterpret_cast<float*>(sm + L.db);
    dbx[wg * kCRows + ra] = dbs[0];
    dbx[wg * kCRows + ra + 8] = dbs[1];
  }
  named_sync(1, 256);
  constexpr int kPieces = NC * 8;  // 16-byte pieces a staged row
  const int ct = threadIdx.x;      // 0 .. 255
  for (int p = ct; p < kCRows * kPieces; p += 256) {
    const int row = p / kPieces, pc = p % kPieces;
    if (r0 + row < r_total)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r0 + row) * h + col0 + pc * 8) =
          *reinterpret_cast<const uint4*>(stage + row * stride + pc * 16);
  }
  if (!dx_mode && db != nullptr && rank == 0 && ct < kCRows && r0 + ct < r_total) {
    const float* dbx = reinterpret_cast<const float*>(sm + L.db);
    db[r0 + ct] = dbx[ct] + dbx[kCRows + ct];
  }
  if (csize > 1) cluster_sync();  // the end
}

// ---------------------------------------------------------------------------
// K9 at bf16 and fp16: the warp-specialised wgmma kernel
// ---------------------------------------------------------------------------
constexpr int kFRows = 128;                     // token rows a unit (a stripe)
constexpr int kFCols = 256;                     // vocab columns a tile
constexpr int kFStages = 4;                     // K stages in the ring
constexpr int kFXStage = kFRows * 64 * 2;       // x stage: 128 rows x 64 columns
constexpr int kFStage = kFXStage + kFCols * 64 * 2;  // + the w stage: 48 KB
constexpr int kFThreads = 384;                  // two consumer warpgroups, a producer
constexpr int kFMaxRanges = 8;                  // vocab ranges the plan may split into
constexpr float kLn2 = 0.6931471805599453f;

// dynamic shared memory of the forward kernel: the ring, its full and empty
// mbarriers, and 1024 bytes to align the base
constexpr int fwd_smem_bytes() { return kFStages * kFStage + 2 * kFStages * 8 + 1024; }

// first vocab tile of range r of `ranges` over `tiles` tiles (ranges differ
// by at most one tile)
__device__ __forceinline__ int range_begin(int tiles, int ranges, int r) {
  return static_cast<int>(static_cast<long long>(tiles) * r / ranges);
}

// S of one 128 x 256 tile: the warpgroup's 64 rows of every x stage against
// the 256 rows of its w stage, K stage by K stage from the ring; each stage
// is released (one arrival a warpgroup on `empty`) as soon as the products
// that read it have completed, one stage of products kept in flight.
template <typename T>
__device__ __forceinline__ void fwd_tile_product(float (&acc)[128], const unsigned char* sm,
                                                 uint64_t* full, uint64_t* empty, int& slot,
                                                 unsigned& phase, int ks_n, int wg, int tid) {
  using namespace hopper;
  auto mma_stage = [&](int k) {
    mbar_wait(full + slot, phase);
    const unsigned char* st = sm + slot * kFStage;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n256k16<T, 0>(acc, sw128_desc(st + wg * (kFXStage / 2) + kk * 32),
                             sw128_desc(st + kFXStage + kk * 32), (k | kk) != 0);
    wg_commit();
    if (++slot == kFStages) {
      slot = 0;
      phase ^= 1;
    }
  };
  fence_regs(acc);
  int prev = slot;
  mma_stage(0);
  for (int k = 1; k < ks_n; ++k) {
    const int cur = slot;
    mma_stage(k);
    wg_wait<1>();
    if (tid == 0) mbar_arrive(empty + prev);
    prev = cur;
  }
  wg_wait<0>();
  fence_regs(acc);
  if (tid == 0) mbar_arrive(empty + prev);
}

// The online logsumexp step of one tile on the accumulator registers. The
// thread holds rows (q = 0, 1) at columns col0 + cq + 8 j + e (j < 32,
// e < 2): d[4 j + 2 q + e]. The bias is added and columns >= vocab set to
// -inf; the label logit is taken from the one thread whose column is the
// label; the row max over the quad of threads sharing the row (two
// shuffles) raises the running max m (log2 units); the thread's own part of
// the running sum l is rescaled and extended with exp2 of its columns. The
// quad's l are summed once, at the end of the range.
// epilogue: begin
__device__ __forceinline__ void fwd_tile_lse(float (&d)[128], int col0, int cq, int vocab,
                                             const float* bias, const int (&lab)[2],
                                             float (&m)[2], float (&l)[2], float (&pk)[2]) {
  using namespace hopper;
  const int base = col0 + cq;
  if (bias != nullptr || col0 + kFCols > vocab) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = base + 8 * j + e;
        const float b =
            c < vocab ? (bias != nullptr ? __ldg(bias + c) : 0.f) : -CUDART_INF_F;
        d[4 * j + e] += b;
        d[4 * j + 2 + e] += b;
      }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (lab[q] >= col0 && lab[q] < col0 + kFCols) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (base + 8 * j + e == lab[q]) pk[q] += d[4 * j + 2 * q + e];
    }
    float mx[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 32; ++j)
      mx[j & 3] = fmaxf(mx[j & 3], fmaxf(d[4 * j + 2 * q], d[4 * j + 2 * q + 1]));
    float v = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float mn = fmaxf(m[q], v * kLog2e);
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j)
      sum[j & 3] += exp2_approx(fmaf(d[4 * j + 2 * q], kLog2e, -mn)) +
                    exp2_approx(fmaf(d[4 * j + 2 * q + 1], kLog2e, -mn));
    l[q] = l[q] * exp2_approx(m[q] - mn) + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
    m[q] = mn;
  }
}
// epilogue: end

// K9 at bf16/fp16. Units of work are (stripe of 128 token rows, range of
// vocab tiles), range-major: the CTAs in flight (one an SM, persistent, a
// unit at a time in grid-stride order) take the stripes of one range, so
// they meet the same w tiles in the same order and read them from L2
// together, while their x stripes (128 x hidden each) stay in L2. The
// producer warp streams the x stripe and the w tile of every K stage (64
// columns) by TMA into a ring of 4 stages (48 KB each, 128-byte swizzle),
// guarded by full and empty mbarriers; the two consumer warpgroups each own
// 64 of the stripe's rows and form their 64 x 256 part of S with wgmma
// m64n256k16 (both operands K-major in shared memory), the fp32 accumulator
// in 128 registers a thread, then run the logsumexp on it (fwd_tile_lse).
// Each row's (m, l, picked) stays in registers over the range; with one
// range loss and lse are written directly, with more the (m, l, picked)
// partials go to `part` [ranges, n_tok] and ce_fwd_merge_kernel folds them
// in range order. No atomics: the bits repeat from launch to launch.
template <typename T>
__global__ void __launch_bounds__(kFThreads, 1)
    ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const float* __restrict__ bias, const int* __restrict__ label,
                        float* __restrict__ loss, float* __restrict__ lse,
                        float4* __restrict__ part, int n_tok, int vocab, int h, int ranges) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kFStages * kFStage);
  uint64_t* empty = full + kFStages;
  const int stripes = (n_tok + kFRows - 1) / kFRows;
  const int tiles = (vocab + kFCols - 1) / kFCols;
  const int units = stripes * ranges;
  const int ks_n = h / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kFStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one thread starts every TMA ----
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      int slot = 0, wraps = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int stripe = u % stripes, range = u / stripes;
        const int t1 = range_begin(tiles, ranges, range + 1);
        for (int t = range_begin(tiles, ranges, range); t < t1; ++t)
          for (int k = 0; k < ks_n; ++k) {
            if (wraps > 0) mbar_wait(empty + slot, (wraps - 1) & 1);
            unsigned char* st = sm + slot * kFStage;
            mbar_expect_tx(full + slot, kFStage);
            tma_load_2d(st, &xmap, full + slot, 64 * k, stripe * kFRows);
            tma_load_2d(st + kFXStage, &wmap, full + slot, 64 * k, t * kFCols);
            if (++slot == kFStages) {
              slot = 0;
              ++wraps;
            }
          }
      }
    }
    return;
  }

  // ---- two consumer warpgroups ----
  setmaxnreg_inc<232>();
  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int rq = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // rows rq, rq + 8 of a stripe
  const int cq = 2 * (lane & 3);                           // column pair in an n8 tile
  float acc[128];
  int slot = 0;
  unsigned phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int stripe = u % stripes, range = u / stripes;
    const int t1 = range_begin(tiles, ranges, range + 1);
    const int row0 = stripe * kFRows + rq;
    int lab[2];
    float m[2], l[2], pk[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      lab[q] = row0 + 8 * q < n_tok ? label[row0 + 8 * q] : -1;
      m[q] = kNegInf;
      l[q] = 0.f;
      pk[q] = 0.f;
    }
    for (int t = range_begin(tiles, ranges, range); t < t1; ++t) {
      fwd_tile_product<T>(acc, sm, full, empty, slot, phase, ks_n, wg, tid);
      fwd_tile_lse(acc, t * kFCols, cq, vocab, bias, lab, m, l, pk);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      l[q] += __shfl_xor_sync(0xffffffffu, l[q], 1);
      l[q] += __shfl_xor_sync(0xffffffffu, l[q], 2);
      pk[q] += __shfl_xor_sync(0xffffffffu, pk[q], 1);
      pk[q] += __shfl_xor_sync(0xffffffffu, pk[q], 2);
      const int row = row0 + 8 * q;
      if ((lane & 3) == 0 && row < n_tok) {
        if (ranges == 1) {
          const float v = (m[q] + log2f(l[q])) * kLn2;
          lse[row] = v;
          loss[row] = v - pk[q];
        } else {
          part[static_cast<size_t>(range) * n_tok + row] = make_float4(m[q], l[q], pk[q], 0.f);
        }
      }
    }
  }
}

// loss and lse of each token from its ranges' (m, l, picked), in range
// order
__global__ void ce_fwd_merge_kernel(const float4* __restrict__ part, float* __restrict__ loss,
                                    float* __restrict__ lse, int n_tok, int ranges) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_tok) return;
  float mx = kNegInf;
  for (int r = 0; r < ranges; ++r) mx = fmaxf(mx, part[static_cast<size_t>(r) * n_tok + row].x);
  float l = 0.f, pk = 0.f;
  for (int r = 0; r < ranges; ++r) {
    const float4 p = part[static_cast<size_t>(r) * n_tok + row];
    l += p.y * exp2f(p.x - mx);
    pk += p.z;
  }
  const float v = (mx + log2f(l)) * kLn2;
  lse[row] = v;
  loss[row] = v - pk;
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

// K9 at fp32 (the CPU-parity model): the FMA kernels, 32-row blocks
template <typename T>
int launch_fwd_fma(const void* x, const void* w, const void* bias, const void* label,
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
int launch_resident(const void* x, const void* w, const void* bias, const void* label,
                    const void* g, const void* lse, void* out, void* db, int n_tok, int vocab,
                    int h, int mode, int round_dl, unsigned grid, cudaStream_t s) {
  const int nbuf = pick_nbuf<T>(h, true);
  const size_t bytes = smem_bytes<T>(h, nbuf, true);
  cudaError_t e = cudaFuncSetAttribute(ce_bwd_kernel<T, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  ce_bwd_kernel<T, NT><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(label), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<T*>(out), static_cast<float*>(db), n_tok,
      vocab, h, mode, nbuf, round_dl);
  return cudaGetLastError();
}

template <typename T, int NT>
int launch_streamed(const void* x, const void* w, const void* bias, const void* label,
                    const void* g, const void* lse, void* out, void* db, int n_tok, int vocab,
                    int h, int mode, int round_dl, unsigned grid, cudaStream_t s) {
  const size_t bytes = stream_smem_bytes<T>(NT * 64);
  cudaError_t e = cudaFuncSetAttribute(ce_bwd_stream_kernel<T, NT>,
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

// K9-K11's routes (ptt_fused_ce_plan reports them)
enum Route : int { kRouteCluster = 0, kRouteStreamed = 1, kRouteResident = 2, kRouteWgmma = 3 };

struct BwdPlan {
  int route;    // Route
  int cluster;  // CTAs sharing a block of R rows (1 off the cluster route)
  int slice;    // output columns a CTA
  int ctas;     // CTAs launched
};

// The route of a K10 (mode 0) / K11 (mode 1) launch. bf16/fp16: the cluster
// kernel wherever a slice of 6, 4 or 2 64-column chunks (384, 256, 128
// columns: even, so the two consumer warpgroups take half each) splits the
// hidden width over at most 8 CTAs, the fewest CTAs first; else the
// streamed kernel. fp32: the resident FMA kernel up to 768 columns (its
// buffers fit), the streamed one above.
BwdPlan plan_bwd(int n_tok, int vocab, int h, int dtype, int mode) {
  const int rows = mode == 0 ? n_tok : vocab;
  const int blocks = (rows + kRows - 1) / kRows;
  if (dtype != kFloat32) {
    const int chunks = h / 64;
    for (int nc = 6; nc >= 2; nc -= 2) {
      if (chunks % nc != 0) continue;
      const int c = chunks / nc;
      if (cluster_fits(nc, c))
        return {kRouteCluster, c, nc * 64, c * ((rows + kCRows - 1) / kCRows)};
    }
  } else if (resident<float>(h, true)) {
    return {kRouteResident, 1, h, blocks};
  }
  const int piece = piece_of(h);
  return {kRouteStreamed, 1, piece, blocks * (h / piece)};
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// so the library needs no link against libcuda; null where it is missing
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// tensor map of a row-major [rows, h] two-byte operand: boxes of 64
// columns and `box_rows` rows (K10/K11: 64; K9: 128 of x, 256 of w),
// 128-byte swizzle, rows past the end read as zeros
template <typename T>
cudaError_t tile_map(CUtensorMap* map, const void* p, int rows, int h, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(h) * sizeof(T)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult r = encode(map, type, 2, const_cast<void*>(p), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int NC>
int launch_cluster(const void* x, const void* w, const void* bias, const void* label,
                   const void* g, const void* lse, void* out, void* db, int n_tok, int vocab,
                   int h, int mode, const BwdPlan& p, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  cudaError_t e = tile_map<T>(&xmap, x, n_tok, h, kCRows);
  if (e != cudaSuccess) return e;
  e = tile_map<T>(&wmap, w, vocab, h, kCRows);
  if (e != cudaSuccess) return e;
  const size_t bytes = ClusterLayout(NC, p.cluster).bytes();
  auto* kernel = ce_bwd_cluster_kernel<T, NC>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool dx = mode == 0;
  e = cudaLaunchKernelEx(&cfg, kernel, dx ? xmap : wmap, dx ? wmap : xmap,
                         static_cast<const float*>(bias), static_cast<const int*>(label),
                         static_cast<const float*>(g), static_cast<const float*>(lse),
                         static_cast<T*>(out), static_cast<float*>(db), n_tok, vocab, h, mode,
                         p.cluster);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

struct FwdPlan {
  int route;   // Route: wgmma (bf16/fp16), resident or streamed (fp32)
  int ranges;  // vocab ranges (1 off the wgmma route)
  int tile;    // vocab columns a tile
  int ctas;    // CTAs launched
};

// The SMs of the current device (the persistent K9 launches one CTA an SM)
int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// The route of a K9 launch. bf16/fp16: the wgmma kernel, its units (128-row
// stripes x vocab ranges) over at most one CTA an SM; the ranges (1 to 8,
// at most one a tile) minimise the units a CTA takes times the tiles of a
// range, the fewest ranges on a tie (24576 x 50304 on 132 SMs: 192 stripes
// x 2 ranges = 384 units, 3 a CTA, 99 tiles a range). fp32: the resident
// FMA kernel up to hidden 768 (its buffers fit), the streamed one above,
// 32-row blocks.
FwdPlan plan_fwd(int n_tok, int vocab, int h, int dtype, int sms) {
  if (dtype == kFloat32)
    return {resident<float>(h, false) ? kRouteResident : kRouteStreamed, 1, kRows,
            (n_tok + kRows - 1) / kRows};
  const int stripes = (n_tok + kFRows - 1) / kFRows;
  const int tiles = (vocab + kFCols - 1) / kFCols;
  int ranges = 1;
  long long best = -1;
  for (int r = 1; r <= kFMaxRanges && r <= tiles; ++r) {
    const long long waves = (static_cast<long long>(stripes) * r + sms - 1) / sms;
    const long long cost = waves * ((tiles + r - 1) / r);
    if (best < 0 || cost < best) {
      best = cost;
      ranges = r;
    }
  }
  const long long units = static_cast<long long>(stripes) * ranges;
  return {kRouteWgmma, ranges, kFCols, static_cast<int>(units < sms ? units : sms)};
}

// fp32 workspace floats of K9's range partials (0 with one range)
long long fwd_part_floats(int n_tok, int ranges) {
  return ranges > 1 ? 4LL * ranges * n_tok : 0;
}

template <typename T>
int launch_fwd_wgmma(const void* x, const void* w, const void* bias, const void* label,
                     void* loss, void* lse, void* part, long long part_floats, int n_tok,
                     int vocab, int h, const FwdPlan& p, cudaStream_t s) {
  if (part_floats < fwd_part_floats(n_tok, p.ranges) || (p.ranges > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  cudaError_t e = tile_map<T>(&xmap, x, n_tok, h, kFRows);
  if (e != cudaSuccess) return e;
  e = tile_map<T>(&wmap, w, vocab, h, kFCols);
  if (e != cudaSuccess) return e;
  constexpr int bytes = fwd_smem_bytes();
  e = cudaFuncSetAttribute(ce_fwd_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return e;
  ce_fwd_wgmma_kernel<T><<<p.ctas, kFThreads, bytes, s>>>(
      xmap, wmap, static_cast<const float*>(bias), static_cast<const int*>(label),
      static_cast<float*>(loss), static_cast<float*>(lse), static_cast<float4*>(part), n_tok,
      vocab, h, p.ranges);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.ranges == 1) return e;
  ce_fwd_merge_kernel<<<(n_tok + 255) / 256, 256, 0, s>>>(
      static_cast<const float4*>(part), static_cast<float*>(loss), static_cast<float*>(lse),
      n_tok, p.ranges);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* bias, const void* label,
               const void* g, const void* lse, void* out, void* db, int n_tok,
               int vocab, int h, int mode, int round_dl, int dtype, cudaStream_t s) {
  const BwdPlan p = plan_bwd(n_tok, vocab, h, dtype, mode);
  const unsigned blocks = (mode == 0 ? n_tok + kRows - 1 : vocab + kRows - 1) / kRows;
  if constexpr (sizeof(T) == 2) {
    if (p.route == kRouteCluster) {
      switch (p.slice / 64) {
        case 2: return launch_cluster<T, 2>(x, w, bias, label, g, lse, out, db, n_tok, vocab, h, mode, p, s);
        case 4: return launch_cluster<T, 4>(x, w, bias, label, g, lse, out, db, n_tok, vocab, h, mode, p, s);
        case 6: return launch_cluster<T, 6>(x, w, bias, label, g, lse, out, db, n_tok, vocab, h, mode, p, s);
      }
      return cudaErrorInvalidValue;
    }
  } else {
    if (p.route == kRouteResident) {
#define PTT_CE_NT(NT) \
  case NT: return launch_resident<T, NT>(x, w, bias, label, g, lse, out, db, n_tok, vocab, h, mode, round_dl, blocks, s);
      switch (p.slice / 64) {
        PTT_CE_NT(2) PTT_CE_NT(4) PTT_CE_NT(6) PTT_CE_NT(8) PTT_CE_NT(10) PTT_CE_NT(12)
      }
#undef PTT_CE_NT
      return cudaErrorInvalidValue;
    }
  }
#define PTT_CE_NT(NT) \
  case NT: return launch_streamed<T, NT>(x, w, bias, label, g, lse, out, db, n_tok, vocab, h, mode, round_dl, blocks, s);
  switch (p.slice / 64) {
    PTT_CE_NT(2) PTT_CE_NT(4) PTT_CE_NT(6) PTT_CE_NT(8) PTT_CE_NT(10) PTT_CE_NT(12)
  }
#undef PTT_CE_NT
  return cudaErrorInvalidValue;
}

bool hidden_ok(int h) { return h > 0 && h % 128 == 0; }

}  // namespace
}  // namespace ptt

// loss, lse: fp32 [n_tok]; label: int32 [n_tok] in [0, vocab); bias: fp32
// [vocab] or null. x [n_tok, hidden] and w [vocab, hidden] share `dtype`;
// hidden is any multiple of 128; x and w 16-byte aligned. part: fp32
// workspace of part_floats floats for the range partials of the bf16/fp16
// kernel (4 * ranges * n_tok with more than one range in the plan; a
// shorter one is refused).
extern "C" int ptt_fused_ce_fwd(const void* x, const void* w, const void* bias,
                                const void* label, void* loss, void* lse, void* part,
                                long long part_floats, int n_tok, int vocab, int hidden,
                                int dtype, void* stream) {
  using namespace ptt;
  if (!hidden_ok(hidden) || n_tok <= 0 || vocab <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_fwd_fma<float>(x, w, bias, label, loss, lse, n_tok, vocab, hidden, s);
  const int sms = device_sms();
  if (sms <= 0) return cudaErrorInvalidValue;
  const FwdPlan p = plan_fwd(n_tok, vocab, hidden, dtype, sms);
  switch (dtype) {
    case kBFloat16: return launch_fwd_wgmma<__nv_bfloat16>(x, w, bias, label, loss, lse, part, part_floats, n_tok, vocab, hidden, p, s);
    case kFloat16: return launch_fwd_wgmma<__half>(x, w, bias, label, loss, lse, part, part_floats, n_tok, vocab, hidden, p, s);
  }
  return cudaErrorInvalidValue;
}

// K10 (mode 0) / K11 (mode 1)'s plan for these sizes and dtype code:
// plan[0] the route (0 cluster, 1 streamed, 2 resident), plan[1] the CTAs
// of a cluster, plan[2] the output columns a CTA, plan[3] the CTAs launched.
// K9's (mode 2), on the current device: plan[0] the route (3 wgmma, or 2
// resident, 1 streamed at fp32), plan[1] the vocab ranges, plan[2] the
// vocab columns a tile, plan[3] the CTAs launched.
extern "C" int ptt_fused_ce_plan(int n_tok, int vocab, int hidden, int dtype, int mode,
                                 int* plan) {
  using namespace ptt;
  if (!hidden_ok(hidden) || n_tok <= 0 || vocab <= 0 || mode < 0 || mode > 2 ||
      dtype < kFloat32 || dtype > kFloat16)
    return cudaErrorInvalidValue;
  if (mode == 2) {
    const int sms = device_sms();
    if (sms <= 0) return cudaErrorInvalidValue;
    const FwdPlan p = plan_fwd(n_tok, vocab, hidden, dtype, sms);
    plan[0] = p.route;
    plan[1] = p.ranges;
    plan[2] = p.tile;
    plan[3] = p.ctas;
    return cudaSuccess;
  }
  const BwdPlan p = plan_bwd(n_tok, vocab, hidden, dtype, mode);
  plan[0] = p.route;
  plan[1] = p.cluster;
  plan[2] = p.slice;
  plan[3] = p.ctas;
  return cudaSuccess;
}

// mode 0: out = dx [n_tok, hidden]; mode 1: out = dw [vocab, hidden] and db
// (fp32 [vocab], or null). g and lse: fp32 [n_tok] (g already 0 at ignored
// labels). round_dl: round dl before the product to bf16 (1) or fp16 (2)
// (fp32 operands only). x and w 16-byte aligned.
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
      return launch_bwd<float>(x, w, bias, label, g, lse, out, db, n_tok, vocab, hidden, mode, round_dl, dtype, s);
    case kBFloat16:
      if (round_dl) return cudaErrorInvalidValue;
      return launch_bwd<__nv_bfloat16>(x, w, bias, label, g, lse, out, db, n_tok, vocab, hidden, mode, 0, dtype, s);
    case kFloat16:
      if (round_dl) return cudaErrorInvalidValue;
      return launch_bwd<__half>(x, w, bias, label, g, lse, out, db, n_tok, vocab, hidden, mode, 0, dtype, s);
  }
  return cudaErrorInvalidValue;
}
