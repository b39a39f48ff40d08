// Packed (seq-major) flash attention backward: kernel K6 of the port.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention_packed.py::_bwd_fused_kernel
// (K6), the backward of the custom-vjp pair behind every uncached attention
// call of a GPT train step (12 forward and 12 backward calls a step for
// GPT-2 124M at s = 1024). Its forward, K5 (::_fwd_kernel), runs K1's
// kernels (csrc/flash_attention.cu): a (batch, seq, heads * head_dim) view
// read through its row stride is a (batch, seq, heads, head_dim) view with
// head stride head_dim, and the shared (sq, sk) bias is K1's bias with
// batch and head strides 0 (ops/cuda/flash_attention_packed.py).
//
// Layout: q, k and v are (batch, seq, heads * head_dim) views read through
// their batch and row strides, so the three views of one fused qkv projection
// ((b, s, 3, h, d), row stride 3*h*d) go in without a copy. out, dout, dq, dk
// and dv are contiguous (b, s, h * d); lse and delta are fp32 (b, h, sq).
//
// Semantics (the JAX kernel's): logits s = q.k * scale + bias[i, j] (an
// optional shared fp32 (sq, sk) bias), causal masking bottom-right aligned
// (key j is visible to query row i iff j <= i + sk - sq). A row with no
// visible key (lse -1e30) gives zero gradients (`_zero_masked_rows`). The
// backward recomputes p = exp(s - lse) tile by tile; delta = rowsum(dout *
// out); ds = p * (dp - delta); dq = ds k * scale, dk = ds^T q * scale,
// dv = p^T dout. Unlike the TPU kernel, p and ds stay fp32 in the products
// (the JAX kernel rounds them to the input dtype before its matmuls).
//
// Attention dropout (the TPU kernel's in-kernel PRNG): with p > 0 each
// tile's keep bits come from the counter-based Philox of csrc/philox.cuh,
// keyed by two seed words and counted from (batch, head, row, column), so
// K6 regenerates K5's mask whatever its tiling; it forms the dropped p for
// dv and masks and scales dp before ds (:286-290). Dropout is a template
// switch: the p = 0 kernels are the code they were.
//
// Bound on the H100 (GPT-2 124M, b = 24, s = 1024, h = 12, d = 64, bf16):
// K6 does ~5 products' worth of the ~39 GFLOP causal score work (~98 GFLOP)
// over ~302 MB: ~0.1 ms. It needs the tensor cores to come near its bound.
//
// Design (simple and right first: fp32 FMA on CUDA cores, no tensor cores):
//  * A CTA of 256 threads is a 16 x 16 grid; each thread owns a 4 x 4
//    micro-tile of every 64 x 64 score tile (rows ty*4+i, columns tx+16*j)
//    and the same 4 keys of every 64 x d product.
//  * Tiles live in shared memory as fp32; k and v tiles are stored
//    transposed with a padded stride (65), so both the score product
//    (lanes along keys) and ds k (lanes along head_dim) read them without
//    bank conflicts. The tile loads and products are shared with K1-K3
//    (csrc/flash_tile.cuh).
//  * One CTA per (64-key block, head, batch); dk and dv accumulate in
//    registers over the q tiles that can see the block, dq is added into an
//    fp32 workspace with atomicAdd (so its summation order varies from run
//    to run), and a cast pass writes dq in the input dtype. delta comes from
//    a pre-pass (one warp a row). The TPU kernel's resident dq slab and its
//    block sizes are VMEM tuning and have no counterpart here.
#include "flash_tile.cuh"

namespace ptt {
namespace {

using namespace flash;

constexpr int kM = 4;  // 64 x 64 tiles at every packed head dim (<= 128)
constexpr int kBQ = Tile<kM>::B, kBK = Tile<kM>::B, kPad = Tile<kM>::Pad;

// ---------------------------------------------------------------------------
// K6: backward (delta pre-pass, main sweep over k blocks, dq cast pass)
// ---------------------------------------------------------------------------

// delta[b, h, i] = sum_c dout[b, i, h, c] * out[b, i, h, c]; one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
packed_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                    float* __restrict__ delta, int b, int sq, int h) {
  const long long wrow = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wrow >= static_cast<long long>(b) * sq * h) return;
  // wrow enumerates (b, i, h) in memory order of out
  const T* o = out + wrow * D;
  const T* g = dout + wrow * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f32(o[c]), to_f32(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int hh = static_cast<int>(wrow % h);
    const long long bi = wrow / h;  // b * sq + i
    const int i = static_cast<int>(bi % sq);
    const long long bb = bi / sq;
    delta[(bb * h + hh) * sq + i] = acc;
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kThreads)
packed_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ bias,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq_ws,
                  T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
                  long long qsb, long long qss, long long ksb, long long kss,
                  long long vsb, long long vss, float scale, int causal,
                  Dropout drp) {
  extern __shared__ float smem[];
  float* kt = smem;                 // [D][kPad]  k block, transposed
  float* vt = kt + D * kPad;        // [D][kPad]  v block, transposed
  float* qs = vt + D * kPad;        // [kBQ][D + 1] q tile
  float* gs = qs + kBQ * (D + 1);   // [kBQ][D + 1] dout tile
  float* ps = gs + kBQ * (D + 1);   // [kBQ][kPad] p, then ds
  float* ls = ps + kBQ * kPad;      // [kBQ] lse
  float* dl = ls + kBQ;             // [kBQ] delta
  uint8_t* kb = reinterpret_cast<uint8_t*>(dl + kBQ);  // keep bits

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bb = blockIdx.z, hh = blockIdx.y, k0 = blockIdx.x * kBK;
  const uint32_t bh = static_cast<uint32_t>(bb * h + hh);
  const long long hd = static_cast<long long>(h) * D;  // contiguous row
  const T* qb = q + bb * qsb + hh * D;
  const T* gb = dout + static_cast<long long>(bb) * sq * hd + hh * D;
  const float* lb = lse + (static_cast<long long>(bb) * h + hh) * sq;
  const float* db = delta + (static_cast<long long>(bb) * h + hh) * sq;
  float* dqb = dq_ws + static_cast<long long>(bb) * sq * hd + hh * D;
  const Logits lg{sq, sk, causal, scale, bias, sk};

  load_kv_t<T, D, kM>(k + bb * ksb + hh * D, v + bb * vsb + hh * D, kss, vss, k0,
                      sk, D, kt, vt);

  float dka[kM][D / 16], dva[kM][D / 16];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int q0 = lg.first_q_tile(k0, kBQ); q0 < sq; q0 += kBQ) {
    __syncthreads();  // the previous tile is no longer read
    load_rows<T, D, kM>(qb, qss, q0, sq, D, 1.f, qs);
    load_rows<T, D, kM>(gb, hd, q0, sq, D, 1.f, gs);
    if (tid < kBQ) {
      const int row = q0 + tid;
      ls[tid] = row < sq ? lb[row] : kNegInf;
      dl[tid] = row < sq ? db[row] : 0.f;
    }
    if constexpr (DROP) fill_keep<kM>(drp, bh, q0, k0, kb);
    __syncthreads();
    float s[kM][kM], dp[kM][kM];
    score_tiles<D, kM>(qs, gs, kt, vt, ty, tx, s, dp);
    // p (dropped) to shared memory for dv first; ds kept in s until p is
    // consumed
    probs_ds<kM, DROP>(lg, q0, k0, ls, dl, s, dp, ps, true, ty, tx, drp, kb);
    __syncthreads();
    acc_keys<D, kM>(ps, gs, ty, tx, dva);  // dv[key] += sum_q p[q][key] dout[q]
    __syncthreads();
    store_tile<kM>(s, ps, ty, tx);
    __syncthreads();
    acc_keys<D, kM>(ps, qs, ty, tx, dka);  // dk[key] += sum_q ds[q][key] q[q]
    // dq[q] += sum_key ds[q][key] k[key] * scale, into the fp32 workspace
    float dqa[kM][D / 16];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) dqa[i][c] = 0.f;
    acc_rows<D, kM>(ps, kt, ty, tx, dqa);
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const int row = q0 + ty * kM + i;
      if (row >= sq) continue;
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        atomicAdd(dqb + row * hd + tx + 16 * c, dqa[i][c] * scale);
    }
  }
  store_dkv<T, D, kM>(dka, dva, dk, dv, bb, hh, h, k0, sk, D, scale, ty, tx);
}

template <typename T>
__global__ void cast_kernel(const float* __restrict__ src, T* __restrict__ dst,
                            long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = from_f32<T>(src[i]);
}

struct Args {
  const void *q, *k, *v;
  const float* bias;
  int b, sq, sk, h;
  long long qsb, qss, ksb, kss, vsb, vss;
  float scale;
  int causal;
  Dropout drp;
};

template <typename T, int D, bool DROP>
cudaError_t bwd(const Args& a, const void* out, const void* dout,
                const float* lse, float* delta, float* dq_ws, void* dq,
                void* dk, void* dv, cudaStream_t stream) {
  const long long n = static_cast<long long>(a.b) * a.sq * a.h * D;
  cudaError_t e = cudaSuccess;
  if (n > 0) {
    if ((e = cudaMemsetAsync(dq_ws, 0, sizeof(float) * n, stream)) != cudaSuccess) return e;
    const long long rows = static_cast<long long>(a.b) * a.sq * a.h;
    const int warps = kThreads / 32;
    packed_delta_kernel<T, D><<<static_cast<unsigned>((rows + warps - 1) / warps),
                                kThreads, 0, stream>>>(
        static_cast<const T*>(out), static_cast<const T*>(dout), delta, a.b,
        a.sq, a.h);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (a.sk > 0) {
    const size_t smem = sizeof(float) * bwd_smem_floats<D, kM, DROP>();
    auto kern = packed_bwd_kernel<T, D, DROP>;
    static bool configured = false;
    if ((e = allow_smem(kern, smem, configured)) != cudaSuccess) return e;
    dim3 grid((a.sk + kBK - 1) / kBK, a.h, a.b);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.bias, static_cast<const T*>(dout), lse,
        delta, dq_ws, static_cast<T*>(dk), static_cast<T*>(dv), a.sq, a.sk,
        a.h, a.qsb, a.qss, a.ksb, a.kss, a.vsb, a.vss, a.scale, a.causal, a.drp);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (n > 0) {
    cast_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
        dq_ws, static_cast<T*>(dq), n);
    e = cudaGetLastError();
  }
  return e;
}

template <typename T, bool DROP>
cudaError_t bwd_d(const Args& a, int d, const void* out, const void* dout,
                  const float* lse, float* delta, float* dq_ws, void* dq,
                  void* dk, void* dv, cudaStream_t s) {
  switch (d) {
    case 32: return bwd<T, 32, DROP>(a, out, dout, lse, delta, dq_ws, dq, dk, dv, s);
    case 64: return bwd<T, 64, DROP>(a, out, dout, lse, delta, dq_ws, dq, dk, dv, s);
    case 128: return bwd<T, 128, DROP>(a, out, dout, lse, delta, dq_ws, dq, dk, dv, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_t(const Args& a, int d, const void* out, const void* dout,
                  const float* lse, float* delta, float* dq_ws, void* dq, void* dk,
                  void* dv, cudaStream_t s) {
  return a.drp.thr < 65536u
             ? bwd_d<T, true>(a, d, out, dout, lse, delta, dq_ws, dq, dk, dv, s)
             : bwd_d<T, false>(a, d, out, dout, lse, delta, dq_ws, dq, dk, dv, s);
}

}  // namespace
}  // namespace ptt

// Dropout: seed0, seed1 and the keep threshold thr of csrc/philox.cuh, and
// inv_keep = 1 / (1 - p); thr = 65536 (no 16-bit value is below it) means
// no dropout and takes the p = 0 kernels.
extern "C" int ptt_flash_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, void* delta,
    void* dq_ws, void* dq, void* dk, void* dv, int b, int sq, int sk, int h,
    int d, long long qsb, long long qss, long long ksb, long long kss,
    long long vsb, long long vss, float scale, int causal, unsigned int seed0,
    unsigned int seed1, unsigned int thr, float inv_keep, int dtype,
    void* stream) {
  using namespace ptt;
  if (b == 0 || h == 0) return cudaSuccess;
  const Args a{q, k, v, static_cast<const float*>(bias), b, sq, sk, h,
               qsb, qss, ksb, kss, vsb, vss, scale, causal,
               Dropout{seed0, seed1, thr, inv_keep}};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* ws = static_cast<float*>(dq_ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return bwd_t<float>(a, d, out, dout, l, dl, ws, dq, dk, dv, s);
    case kBFloat16: return bwd_t<__nv_bfloat16>(a, d, out, dout, l, dl, ws, dq, dk, dv, s);
    case kFloat16: return bwd_t<__half>(a, d, out, dout, l, dl, ws, dq, dk, dv, s);
  }
  return cudaErrorInvalidValue;
}
