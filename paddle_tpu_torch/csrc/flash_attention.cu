// Layout-swapping flash attention: forward (kernel K1), dq (K2) and dk/dv
// (K3) of the port.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (K1),
// ::_bwd_dq_kernel (K2) and ::_bwd_dkv_kernel (K3), the custom-vjp triple
// behind every uncached attention call the packed kernels cannot take: a
// head dim that does not pack into 128 lanes (GPT-3 Large's 96), a
// per-batch or per-head (B|1, H|1, sq, sk) bias, or a trainable bias.
//
// Layout: q, k and v are read in the paddle layout (batch, seq, heads,
// head_dim) through their batch, row and head strides, so the three views of
// one fused qkv projection go in without a copy. The bias is fp32, read
// through its (batch, head, row) strides with stride 0 on a broadcast dim
// (never expanded in memory), columns contiguous. out, dout, dq, dk and dv
// are contiguous (b, s, h, d); lse is fp32 (b, h, sq).
//
// Semantics (the JAX kernels'): logits s = q.k * scale + bias, causal
// masking bottom-right aligned (key j is visible to query row i iff
// j <= i + sk - sq), online softmax in fp32. A row with no visible key gives
// output 0, lse -1e30 and zero gradients (`_zero_masked_rows`). The backward
// recomputes p = exp(s - lse) tile by tile; delta = rowsum(dout * out) is
// recomputed per tile from out and dout, as the TPU kernels do;
// ds = p * (dp - delta); dq = ds k * scale (K2, swept over key tiles),
// dk = ds^T q * scale and dv = p^T dout (K3, swept over query tiles). With
// that split nothing is summed across CTAs: no atomics, and the gradients
// are the same bit for bit from run to run. Unlike the TPU kernels, p and
// ds stay fp32 in the products (the JAX kernels round them to the input
// dtype before their matmuls).
//
// Bound on the H100 (GPT-3 Large, b = 8, s = 2048, h = 16, d = 96, bf16,
// causal): K1 does ~103 GFLOP of causal score work over ~0.2 GB, ~0.10 ms
// at 989 TFLOP/s; K2 and K3 each recompute the scores and dp and do one or
// two more products, ~0.16 and ~0.21 ms by operations. All three need the
// tensor cores to come near their bound.
//
// Design (simple and right first: fp32 FMA on CUDA cores, no tensor cores),
// the tile scheme and tile helpers K5/K6 (csrc/flash_attention_packed.cu)
// share through csrc/flash_tile.cuh:
//  * A CTA of 256 threads is a 16 x 16 grid; each thread owns a 4 x 4
//    micro-tile of every 64 x 64 score tile (rows ty*4+i, columns tx+16*j)
//    and the same 4 rows (or keys) of every 64 x d product, d/16 columns a
//    thread (6 at d = 96), so any d that is a multiple of 16 works.
//  * Tiles live in shared memory as fp32; k and v tiles are stored
//    transposed with a padded stride (65), so both the score product (lanes
//    along keys) and p v or ds k (lanes along head_dim) read them without
//    bank conflicts. At d = 96 that is 91 KB (K1) and 117 KB (K2, K3) of dynamic
//    shared memory, raised above the 48 KB default once a kernel.
//  * K1 and K2: one CTA per (64-row query tile, head, batch), streaming the
//    64-key tiles up to the last key its rows can see (causal tiles above
//    the diagonal are skipped). K3: one CTA per (64-key tile, head, batch),
//    streaming the query tiles from the first row that sees its first key.
//  * Row and column guards on every load and store: any sq and sk.
#include "flash_tile.cuh"

namespace ptt {
namespace {

using namespace flash;

struct Args {
  const void *q, *k, *v;
  const float* bias;          // nullptr: no bias
  int b, sq, sk, h;
  long long qs[3], ks[3], vs[3];  // (batch, seq, head) strides, in elements
  long long bs[3];                // bias (batch, head, row) strides
  float scale;
  int causal;
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
template <typename T, int D>
__device__ __forceinline__ void load_q_tile(const T* qb, long long qss, const T* ob,
                                            const T* gb, long long hd, const float* lb,
                                            int q0, int sq, float* qs, float* gs,
                                            float* ls, float* dl) {
  load_rows<T, D>(qb, qss, q0, sq, 1.f, qs);
  load_rows<T, D>(gb, hd, q0, sq, 1.f, gs);
  const int t = threadIdx.x;
  if (t < kBQ) ls[t] = q0 + t < sq ? lb[q0 + t] : kNegInf;
  row_delta<T, D>(ob, gb, hd, q0, sq, dl);
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(Args a, T* __restrict__ out, float* __restrict__ lse) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBQ][D + 1] q rows
  float* kt = qs + kBQ * (D + 1);   // [D][kPad]  k tile, transposed
  float* vt = kt + D * kPad;        // [D][kPad]  v tile, transposed
  float* ps = vt + D * kPad;        // [kBQ][kPad] probabilities

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bb = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const Slice<T> in(a, bb, hh);
  load_rows<T, D>(in.q, a.qs[1], q0, a.sq, 1.f, qs);
  const int kend = in.lg.key_end(q0);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    load_kv_t<T, D>(in.k, in.v, a.ks[1], a.vs[1], k0, a.sk, kt, vt);
    __syncthreads();
    float s[4][4];
    score_tile<D>(qs, kt, ty, tx, s);
    in.lg.mask(s, q0, k0, ty, tx);
    softmax_step<D>(s, m, l, acc, ps, ty, tx);
    __syncthreads();
    acc_rows<D>(ps, vt, ty, tx, acc);
  }
  store_out<T, D>(acc, m, l, out, lse, bb, hh, a.h, q0, a.sq, ty, tx);
}

// ---------------------------------------------------------------------------
// K2: dq, one CTA per query tile, swept over key tiles
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(Args a, const T* __restrict__ out, const T* __restrict__ dout,
          const float* __restrict__ lse, T* __restrict__ dq) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ float smem[];
  float* kt = smem;                 // [D][kPad]  k tile, transposed
  float* vt = kt + D * kPad;        // [D][kPad]  v tile, transposed
  float* qs = vt + D * kPad;        // [kBQ][D + 1] q rows
  float* gs = qs + kBQ * (D + 1);   // [kBQ][D + 1] dout rows
  float* ps = gs + kBQ * (D + 1);   // [kBQ][kPad] ds
  float* ls = ps + kBQ * kPad;      // [kBQ] lse
  float* dl = ls + kBQ;             // [kBQ] delta

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bb = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const long long hd = static_cast<long long>(a.h) * D;  // contiguous row
  const Slice<T> in(a, bb, hh);
  const long long orow0 = static_cast<long long>(bb) * a.sq * hd + hh * D;
  const float* lb = lse + (static_cast<long long>(bb) * a.h + hh) * a.sq;

  load_q_tile<T, D>(in.q, a.qs[1], out + orow0, dout + orow0, hd, lb, q0, a.sq,
                    qs, gs, ls, dl);
  const int kend = in.lg.key_end(q0);

  float dqa[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dqa[i][c] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    load_kv_t<T, D>(in.k, in.v, a.ks[1], a.vs[1], k0, a.sk, kt, vt);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tiles<D>(qs, gs, kt, vt, ty, tx, s, dp);
    probs_ds(in.lg, q0, k0, ls, dl, s, dp, ps, false, ty, tx);
    store_tile(s, ps, ty, tx);
    __syncthreads();
    acc_rows<D>(ps, kt, ty, tx, dqa);  // dq[q] += sum_key ds[q][key] k[key]
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.sq) continue;
    T* drow = dq + orow0 + row * hd;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) drow[tx + 16 * c] = from_f32<T>(dqa[i][c] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// K3: dk and dv, one CTA per key tile, swept over query tiles
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(Args a, const T* __restrict__ out, const T* __restrict__ dout,
           const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ float smem[];
  float* kt = smem;                 // [D][kPad]  k tile, transposed
  float* vt = kt + D * kPad;        // [D][kPad]  v tile, transposed
  float* qs = vt + D * kPad;        // [kBQ][D + 1] q rows
  float* gs = qs + kBQ * (D + 1);   // [kBQ][D + 1] dout rows
  float* ps = gs + kBQ * (D + 1);   // [kBQ][kPad] p, then ds
  float* ls = ps + kBQ * kPad;      // [kBQ] lse
  float* dl = ls + kBQ;             // [kBQ] delta

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bb = blockIdx.z, hh = blockIdx.y, k0 = blockIdx.x * kBK;
  const long long hd = static_cast<long long>(a.h) * D;
  const Slice<T> in(a, bb, hh);
  const long long orow0 = static_cast<long long>(bb) * a.sq * hd + hh * D;
  const float* lb = lse + (static_cast<long long>(bb) * a.h + hh) * a.sq;

  load_kv_t<T, D>(in.k, in.v, a.ks[1], a.vs[1], k0, a.sk, kt, vt);

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int q0 = in.lg.first_q_tile(k0); q0 < a.sq; q0 += kBQ) {
    __syncthreads();  // the previous tile is no longer read
    load_q_tile<T, D>(in.q, a.qs[1], out + orow0, dout + orow0, hd, lb, q0, a.sq,
                      qs, gs, ls, dl);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tiles<D>(qs, gs, kt, vt, ty, tx, s, dp);
    // p to shared memory for dv first; ds kept in s until p is consumed
    probs_ds(in.lg, q0, k0, ls, dl, s, dp, ps, true, ty, tx);
    __syncthreads();
    acc_keys<D>(ps, gs, ty, tx, dva);  // dv[key] += sum_q p[q][key] dout[q]
    __syncthreads();
    store_tile(s, ps, ty, tx);
    __syncthreads();
    acc_keys<D>(ps, qs, ty, tx, dka);  // dk[key] += sum_q ds[q][key] q[q]
  }
  store_dkv<T, D>(dka, dva, dk, dv, bb, hh, a.h, k0, a.sk, a.scale, ty, tx);
}

template <typename T, int D>
cudaError_t fwd(const Args& a, void* out, float* lse, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats<D>();
  auto kern = fwd_kernel<T, D>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a, static_cast<T*>(out), lse);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const Args& a, const void* out, const void* dout,
                   const float* lse, void* dq, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats<D>();
  auto kern = dq_kernel<T, D>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a, static_cast<const T*>(out),
                                         static_cast<const T*>(dout), lse,
                                         static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const Args& a, const void* out, const void* dout,
                    const float* lse, void* dk, void* dv, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats<D>();
  auto kern = dkv_kernel<T, D>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sk + kBK - 1) / kBK, a.h, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a, static_cast<const T*>(out),
                                         static_cast<const T*>(dout), lse,
                                         static_cast<T*>(dk), static_cast<T*>(dv));
  return cudaGetLastError();
}

// the head dims the kernels are instantiated for
// (paddle_tpu_torch/ops/cuda/flash_attention.py::FLASH_HEAD_DIMS)
#define PTT_FLASH_HEAD_DIMS(X) X(32) X(64) X(80) X(96) X(128)

template <typename T>
cudaError_t fwd_d(const Args& a, int d, void* out, float* lse, cudaStream_t s) {
#define PTT_CASE(D) \
  case D: return fwd<T, D>(a, out, lse, s);
  switch (d) { PTT_FLASH_HEAD_DIMS(PTT_CASE) }
#undef PTT_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dq_d(const Args& a, int d, const void* out, const void* dout,
                 const float* lse, void* dq, cudaStream_t s) {
#define PTT_CASE(D) \
  case D: return bwd_dq<T, D>(a, out, dout, lse, dq, s);
  switch (d) { PTT_FLASH_HEAD_DIMS(PTT_CASE) }
#undef PTT_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dkv_d(const Args& a, int d, const void* out, const void* dout,
                  const float* lse, void* dk, void* dv, cudaStream_t s) {
#define PTT_CASE(D) \
  case D: return bwd_dkv<T, D>(a, out, dout, lse, dk, dv, s);
  switch (d) { PTT_FLASH_HEAD_DIMS(PTT_CASE) }
#undef PTT_CASE
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               int b, int sq, int sk, int h, const long long* st, float scale,
               int causal) {
  return Args{q, k, v, static_cast<const float*>(bias), b, sq, sk, h,
              {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
              {st[6], st[7], st[8]}, {st[9], st[10], st[11]}, scale, causal};
}

}  // namespace
}  // namespace ptt

// Strides (in elements): q, k and v each (batch, seq, head), then the bias
// (batch, head, row), 0 on a broadcast dim.

extern "C" int ptt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* lse, int b, int sq, int sk, int h, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long bsb, long long bsh,
    long long bsr, float scale, int causal, int dtype, void* stream) {
  using namespace ptt;
  if (b == 0 || sq == 0 || h == 0) return cudaSuccess;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsr};
  const Args a = make_args(q, k, v, bias, b, sq, sk, h, st, scale, causal);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return fwd_d<float>(a, d, out, l, s);
    case kBFloat16: return fwd_d<__nv_bfloat16>(a, d, out, l, s);
    case kFloat16: return fwd_d<__half>(a, d, out, l, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, void* dq, int b,
    int sq, int sk, int h, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long bsb, long long bsh, long long bsr, float scale,
    int causal, int dtype, void* stream) {
  using namespace ptt;
  if (b == 0 || sq == 0 || h == 0) return cudaSuccess;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsr};
  const Args a = make_args(q, k, v, bias, b, sq, sk, h, st, scale, causal);
  const float* l = static_cast<const float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dq_d<float>(a, d, out, dout, l, dq, s);
    case kBFloat16: return dq_d<__nv_bfloat16>(a, d, out, dout, l, dq, s);
    case kFloat16: return dq_d<__half>(a, d, out, dout, l, dq, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int ptt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, void* dk, void* dv,
    int b, int sq, int sk, int h, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long bsb, long long bsh, long long bsr,
    float scale, int causal, int dtype, void* stream) {
  using namespace ptt;
  if (b == 0 || sk == 0 || h == 0) return cudaSuccess;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsr};
  const Args a = make_args(q, k, v, bias, b, sq, sk, h, st, scale, causal);
  const float* l = static_cast<const float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dkv_d<float>(a, d, out, dout, l, dk, dv, s);
    case kBFloat16: return dkv_d<__nv_bfloat16>(a, d, out, dout, l, dk, dv, s);
    case kFloat16: return dkv_d<__half>(a, d, out, dout, l, dk, dv, s);
  }
  return cudaErrorInvalidValue;
}
