// Packed (seq-major) flash attention backward: kernel K6 of the port.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention_packed.py::_bwd_fused_kernel
// (K6), the backward of the custom-vjp pair behind every uncached attention
// call of a GPT train step (12 forward and 12 backward calls a step for
// GPT-2 124M at s = 1024). Its forward, K5 (::_fwd_kernel), runs K1's
// kernels (csrc/flash_attention.cu). Both read a (batch, seq, heads *
// head_dim) view through its row stride as a (batch, seq, heads, head_dim)
// view with head stride head_dim (K1's Args), and the shared (sq, sk) bias
// as K1's bias with batch and head strides 0
// (ops/cuda/flash_attention_packed.py), so the three views of one fused qkv
// projection ((b, s, 3, h, d), row stride 3*h*d) go in without a copy.
// out, dout, dq, dk and dv are contiguous (b, s, h * d); lse and delta are
// fp32 (b, h, sq).
//
// Semantics (the JAX kernel's): logits s = q.k * scale + bias[i, j],
// causal masking bottom-right aligned (key j is visible to query row i iff
// j <= i + sk - sq). A row with no visible key (lse -1e30) gives zero
// gradients (`_zero_masked_rows`). The backward recomputes p = exp(s -
// lse) tile by tile; delta = rowsum(dout * out); ds = p * (dp - delta);
// dq = ds k * scale, dk = ds^T q * scale, dv = p^T dout, in one pass: s,
// p, dp and ds are computed once for all three (the JAX kernel's reason
// for one pass, :239-249). With dropout each tile's keep bits come from the
// counter-based Philox of csrc/philox.cuh, counted from (col >> 3, row,
// b * h + head), so K6 regenerates K5's mask whatever its tiling; dv takes
// the dropped p and ds the masked and scaled dp (:286-290). Dropout is a
// template switch.
//
// Bound on the H100 (GPT-2 124M, b = 24, s = 1024, h = 12, d = 64, bf16):
// five products' worth of the causal score work (~98 GFLOP) over ~302 MB:
// ~0.1 ms by operations. It needs the tensor cores to come near it.
//
// Two routes, by input type:
//  * bf16 and fp16 (packed_bwd_tc_kernel): K3's tensor-core kernel body
//    (flash_attention.cuh::dkv_tc) with its dq product, FlashAttention-2's
//    backward. One CTA of 4 warps a 64-key tile, 16 keys a warp, k and v
//    fragments in registers, swept over the query tiles that see it (q,
//    dout and out through a two-stage cp.async ring, rows padded by 16 B);
//    delta recomputed a tile from out and dout (no pre-pass); dk and dv
//    accumulated in registers and written once; p and ds * scale rounded
//    to the input type before their products, as the TPU kernel rounds
//    them (:295, :304, :312). Each warp writes its ds * scale (rounded) to
//    a shared ds tile beside the CTA's k tile; after both 32-query halves
//    each warp computes dq for 16 query rows over the CTA's 64 keys with
//    mma.sync (ldmatrix.trans operands) and adds it to a zeroed fp32
//    workspace with 8-byte vector reductions (red.global.add.v2.f32, one a
//    column pair); a cast pass writes dq in the input type. The order of
//    those additions varies from run to run, so dq's last fp32 bits do.
//  * fp32 (packed_bwd_kernel): fp32 FMA on CUDA cores with the tile scheme
//    of K1-K3's FMA route (csrc/flash_tile.cuh: 16 x 16 threads, 4 x 4
//    micro-tiles of 64 x 64 tiles, fp32 tiles in shared memory, k and v
//    transposed at stride 65), since TF32 tensor cores would not hold the
//    fp32 limits: a delta pre-pass, one CTA a 64-key tile with dq added
//    into the fp32 workspace by atomicAdd, and the cast pass. p and ds stay
//    fp32 (rounding to fp32 is exact).
#include "flash_attention.cuh"

namespace ptt {
namespace {

using namespace flash;

constexpr int kM = 4;  // FMA: 64 x 64 tiles at every packed head dim (<= 128)
static_assert(Tile<kM>::B == kBQ && Tile<kM>::B == kBK, "the FMA route's tiles are 64 x 64");
constexpr int kPad = Tile<kM>::Pad;

// ---------------------------------------------------------------------------
// K6 on FMA (fp32): delta pre-pass, main sweep over k blocks, dq cast pass
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
packed_bwd_kernel(Args a, const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq_ws,
                  T* __restrict__ dk, T* __restrict__ dv) {
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
  const int sq = a.sq, sk = a.sk;
  const uint32_t bh = static_cast<uint32_t>(bb * a.h + hh);
  const long long hd = static_cast<long long>(a.h) * D;  // contiguous row
  const Slice<T> in(a, bb, hh);
  const Logits& lg = in.lg;
  const T* gb = dout + static_cast<long long>(bb) * sq * hd + hh * D;
  const float* lb = lse + (static_cast<long long>(bb) * a.h + hh) * sq;
  const float* db = delta + (static_cast<long long>(bb) * a.h + hh) * sq;
  float* dqb = dq_ws + static_cast<long long>(bb) * sq * hd + hh * D;

  load_kv_t<T, D, kM>(in.k, in.v, a.ks[1], a.vs[1], k0, sk, D, kt, vt);

  float dka[kM][D / 16], dva[kM][D / 16];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int q0 = lg.first_q_tile(k0, kBQ); q0 < sq; q0 += kBQ) {
    __syncthreads();  // the previous tile is no longer read
    load_rows<T, D, kM>(in.q, a.qs[1], q0, sq, D, 1.f, qs);
    load_rows<T, D, kM>(gb, hd, q0, sq, D, 1.f, gs);
    if (tid < kBQ) {
      const int row = q0 + tid;
      ls[tid] = row < sq ? lb[row] : kNegInf;
      dl[tid] = row < sq ? db[row] : 0.f;
    }
    if constexpr (DROP) fill_keep<kM>(a.drp, bh, q0, k0, kb);
    __syncthreads();
    float s[kM][kM], dp[kM][kM];
    score_tiles<D, kM>(qs, gs, kt, vt, ty, tx, s, dp);
    // p (dropped) to shared memory for dv first; ds kept in s until p is
    // consumed
    probs_ds<kM, DROP>(lg, q0, k0, ls, dl, s, dp, ps, true, ty, tx, a.drp, kb);
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
        atomicAdd(dqb + row * hd + tx + 16 * c, dqa[i][c] * a.scale);
    }
  }
  store_dkv<T, D, kM>(dka, dva, dk, dv, bb, hh, a.h, k0, sk, D, a.scale, ty, tx);
}

template <typename T>
__global__ void cast_kernel(const float* __restrict__ src, T* __restrict__ dst,
                            long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = from_f32<T>(src[i]);
}

// K6 on the tensor cores (bf16, fp16): grid (key tiles, h, b), as K3's
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kTcThreads, 2)
packed_bwd_tc_kernel(Args a, const T* __restrict__ out, const T* __restrict__ dout,
                     const float* __restrict__ lse, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dq_ws, int vec) {
  dkv_tc<T, D, DROP, true>(a, out, dout, lse, dk, dv, dq_ws, vec);
}

// dq's fp32 workspace is zeroed before the sweep and cast to the input type
// after it
template <typename T>
cudaError_t cast_dq(const float* dq_ws, void* dq, long long n, cudaStream_t stream) {
  cast_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      dq_ws, static_cast<T*>(dq), n);
  return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t bwd(const Args& a, const void* out, const void* dout, const float* lse,
                float* delta, float* dq_ws, void* dq, void* dk, void* dv,
                cudaStream_t stream) {
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
    kern<<<grid, kThreads, smem, stream>>>(a, static_cast<const T*>(dout), lse, delta,
                                           dq_ws, static_cast<T*>(dk), static_cast<T*>(dv));
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return n > 0 ? cast_dq<T>(dq_ws, dq, n, stream) : e;
}

template <typename T, int D, bool DROP>
cudaError_t bwd_tc(const Args& a, const void* out, const void* dout, const float* lse,
                   float* dq_ws, void* dq, void* dk, void* dv, int vec,
                   cudaStream_t stream) {
  const long long n = static_cast<long long>(a.b) * a.sq * a.h * D;
  cudaError_t e = cudaSuccess;
  if (n > 0 && (e = cudaMemsetAsync(dq_ws, 0, sizeof(float) * n, stream)) != cudaSuccess)
    return e;
  if (a.sk > 0) {
    const size_t smem = dkv_tc_smem_bytes<T, D, DROP, true>();
    auto kern = packed_bwd_tc_kernel<T, D, DROP>;
    static bool configured = false;
    if ((e = allow_smem(kern, smem, configured)) != cudaSuccess) return e;
    dim3 grid((a.sk + kBK - 1) / kBK, a.h, a.b);
    kern<<<grid, kTcThreads, smem, stream>>>(
        a, static_cast<const T*>(out), static_cast<const T*>(dout), lse,
        static_cast<T*>(dk), static_cast<T*>(dv), dq_ws, vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return n > 0 ? cast_dq<T>(dq_ws, dq, n, stream) : e;
}

// the packed head dims (ops/cuda/flash_attention_packed.py::HEAD_DIMS)
#define PTT_PACKED_DIMS(X) X(32) X(64) X(128)

template <typename T, bool DROP>
cudaError_t bwd_d(const Args& a, const void* out, const void* dout, const float* lse,
                  float* delta, float* dq_ws, void* dq, void* dk, void* dv, int vec,
                  cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    switch (a.dn) {
#define PTT_CASE(D) \
  case D: return bwd_tc<T, D, DROP>(a, out, dout, lse, dq_ws, dq, dk, dv, vec, s);
      PTT_PACKED_DIMS(PTT_CASE)
#undef PTT_CASE
    }
  } else {
    switch (a.dn) {
#define PTT_CASE(D) \
  case D: return bwd<T, D, DROP>(a, out, dout, lse, delta, dq_ws, dq, dk, dv, s);
      PTT_PACKED_DIMS(PTT_CASE)
#undef PTT_CASE
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_t(const Args& a, const void* out, const void* dout, const float* lse,
                  float* delta, float* dq_ws, void* dq, void* dk, void* dv, int vec,
                  cudaStream_t s) {
  return a.drp.thr < 65536u
             ? bwd_d<T, true>(a, out, dout, lse, delta, dq_ws, dq, dk, dv, vec, s)
             : bwd_d<T, false>(a, out, dout, lse, delta, dq_ws, dq, dk, dv, vec, s);
}

}  // namespace
}  // namespace ptt

// Strides (in elements) as K1's: q, k and v each (batch, seq, head) — the
// packed views' batch and row strides and head stride d — then the bias
// (batch, head, row): 0, 0, sk for the shared bias. fp32 takes the FMA
// route and needs delta (b, h, sq); bf16 and fp16 the tensor-core route
// (delta unused). Dropout: seed0, seed1 and the keep threshold thr of
// csrc/philox.cuh, and inv_keep = 1 / (1 - p); thr = 65536 (no 16-bit value
// is below it) means no dropout and takes the p = 0 kernels.
extern "C" int ptt_flash_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, void* delta,
    void* dq_ws, void* dq, void* dk, void* dv, int b, int sq, int sk, int h,
    int d, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    long long bsb, long long bsh, long long bsr, float scale, int causal,
    unsigned int seed0, unsigned int seed1, unsigned int thr, float inv_keep,
    int dtype, void* stream) {
  using namespace ptt;
  if (b == 0 || h == 0) return cudaSuccess;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsr};
  const Args a = make_args(q, k, v, bias, b, sq, sk, h, d, st, scale, causal, seed0,
                           seed1, thr, inv_keep);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* ws = static_cast<float*>(dq_ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = rows_aligned(a) && aligned16(out) && aligned16(dout);
  switch (dtype) {
    case kFloat32: return bwd_t<float>(a, out, dout, l, dl, ws, dq, dk, dv, vec, s);
    case kBFloat16:
      return bwd_t<__nv_bfloat16>(a, out, dout, l, dl, ws, dq, dk, dv, vec, s);
    case kFloat16: return bwd_t<__half>(a, out, dout, l, dl, ws, dq, dk, dv, vec, s);
  }
  return cudaErrorInvalidValue;
}
