// dk and dv of the layout-swapping flash attention: kernel K3 of the port,
// beside K1 (flash_attention.cu, which describes the three kernels) and K2
// (flash_attention_dq.cu).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_bwd_dkv_kernel.
// bf16 and fp16 up to width 128 on the tensor cores (csrc/flash_mma.cuh),
// fp32 and width 256 on fp32 FMA (csrc/flash_tile.cuh), above 256 FMA with
// the head dim in 256-column chunks (flash_attention.cuh::kWide); one CTA
// per key tile swept over the query tiles that see it; with dropout, the
// dropped p goes into dv and the masked, scaled dp into ds (:246-251).
#include "flash_attention.cuh"

namespace ptt {
namespace {

// ---------------------------------------------------------------------------
// K3: dk and dv, one CTA per key tile, swept over query tiles
// ---------------------------------------------------------------------------
template <typename T, int D, int M, bool DROP>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(Args a, const T* __restrict__ out, const T* __restrict__ dout,
           const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int B = Tile<M>::B, P = Tile<M>::Pad;
  extern __shared__ float smem[];
  float* kt = smem;                 // [D][P]  k tile, transposed
  float* vt = kt + D * P;           // [D][P]  v tile, transposed
  float* qs = vt + D * P;           // [B][D + 1] q rows
  float* gs = qs + B * (D + 1);     // [B][D + 1] dout rows
  float* ps = gs + B * (D + 1);     // [B][P] p, then ds
  float* ls = ps + B * P;           // [B] lse
  float* dl = ls + B;               // [B] delta
  uint8_t* kb = reinterpret_cast<uint8_t*>(dl + B);  // keep bits

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bb = blockIdx.z, hh = blockIdx.y, k0 = blockIdx.x * B;
  const uint32_t bh = static_cast<uint32_t>(bb * a.h + hh);
  const long long hd = static_cast<long long>(a.h) * a.dn;
  const Slice<T> in(a, bb, hh);
  const long long orow0 = static_cast<long long>(bb) * a.sq * hd + hh * a.dn;
  const float* lb = lse + (static_cast<long long>(bb) * a.h + hh) * a.sq;

  load_kv_t<T, D, M>(in.k, in.v, a.ks[1], a.vs[1], k0, a.sk, a.dn, kt, vt);

  float dka[M][D / 16], dva[M][D / 16];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int q0 = in.lg.first_q_tile(k0, B); q0 < a.sq; q0 += B) {
    __syncthreads();  // the previous tile is no longer read
    load_q_tile<T, D, M>(in.q, a.qs[1], out + orow0, dout + orow0, hd, lb, q0, a.sq,
                         a.dn, qs, gs, ls, dl);
    if constexpr (DROP) fill_keep<M>(a.drp, bh, q0, k0, kb);
    __syncthreads();
    float s[M][M], dp[M][M];
    score_tiles<D, M>(qs, gs, kt, vt, ty, tx, s, dp);
    // p (dropped) to shared memory for dv first; ds kept in s until p is
    // consumed
    probs_ds<M, DROP>(in.lg, q0, k0, ls, dl, s, dp, ps, true, ty, tx, a.drp, kb);
    __syncthreads();
    acc_keys<D, M>(ps, gs, ty, tx, dva);  // dv[key] += sum_q p[q][key] dout[q]
    __syncthreads();
    store_tile<M>(s, ps, ty, tx);
    __syncthreads();
    acc_keys<D, M>(ps, qs, ty, tx, dka);  // dk[key] += sum_q ds[q][key] q[q]
  }
  store_dkv<T, D, M>(dka, dva, dk, dv, bb, hh, a.h, k0, a.sk, a.dn, a.scale, ty, tx);
}

// ---------------------------------------------------------------------------
// K3 above width 256 (every type): the head dim in kWide-column chunks
// ---------------------------------------------------------------------------
// grid (key tiles x output slices, h, b): a CTA writes the kWide columns of
// dk and dv in its slice; for every query tile it accumulates s and dp over
// the chunks of q, dout, k and v, then takes its slice of q and dout for
// dv += p^T dout and dk += ds^T q
template <typename T, bool DROP>
__global__ void __launch_bounds__(kThreads)
dkv_wide_kernel(Args a, const T* __restrict__ out, const T* __restrict__ dout,
                const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv) {
  constexpr int D = kWide, M = tile_m(D), B = Tile<M>::B, P = Tile<M>::Pad;
  extern __shared__ float smem[];
  float* kt = smem;                 // [D][P]  a chunk of k, transposed
  float* vt = kt + D * P;           // [D][P]  a chunk of v, transposed
  float* qs = vt + D * P;           // [B][D + 1] a chunk (then the slice) of q
  float* gs = qs + B * (D + 1);     // [B][D + 1] a chunk (then the slice) of dout
  float* ps = gs + B * (D + 1);     // [B][P] p, then ds
  float* ls = ps + B * P;           // [B] lse
  float* dl = ls + B;               // [B] delta
  uint8_t* kb = reinterpret_cast<uint8_t*>(dl + B);  // keep bits

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nsl = wide_slices(a.dn), c1 = (blockIdx.x % nsl) * D;
  const int bb = blockIdx.z, hh = blockIdx.y, k0 = (blockIdx.x / nsl) * B;
  const uint32_t bh = static_cast<uint32_t>(bb * a.h + hh);
  const long long hd = static_cast<long long>(a.h) * a.dn;
  const Slice<T> in(a, bb, hh);
  const long long orow0 = static_cast<long long>(bb) * a.sq * hd + hh * a.dn;
  const T* gb = dout + orow0;
  const float* lb = lse + (static_cast<long long>(bb) * a.h + hh) * a.sq;

  float dka[M][D / 16], dva[M][D / 16];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int q0 = in.lg.first_q_tile(k0, B); q0 < a.sq; q0 += B) {
    __syncthreads();  // the previous tile is no longer read
    if (tid < B) ls[tid] = q0 + tid < a.sq ? lb[q0 + tid] : kNegInf;
    row_delta<T, M>(out + orow0, gb, hd, q0, a.sq, a.dn, dl);
    float s[M][M] = {}, dp[M][M] = {};
    for (int c0 = 0; c0 < a.dn; c0 += D) {
      if (c0 > 0) __syncthreads();  // the previous chunk is no longer read
      load_rows<T, D, M>(in.q + c0, a.qs[1], q0, a.sq, a.dn - c0, 1.f, qs);
      load_rows<T, D, M>(gb + c0, hd, q0, a.sq, a.dn - c0, 1.f, gs);
      load_kv_t<T, D, M>(in.k + c0, in.v + c0, a.ks[1], a.vs[1], k0, a.sk, a.dn - c0,
                         kt, vt);
      if (DROP && c0 == 0) fill_keep<M>(a.drp, bh, q0, k0, kb);
      __syncthreads();
      score_tiles<D, M, true>(qs, gs, kt, vt, ty, tx, s, dp);
    }
    __syncthreads();  // the last chunk of q and dout is no longer read
    load_rows<T, D, M>(in.q + c1, a.qs[1], q0, a.sq, a.dn - c1, 1.f, qs);
    load_rows<T, D, M>(gb + c1, hd, q0, a.sq, a.dn - c1, 1.f, gs);
    // p (dropped) to shared memory for dv first; ds kept in s until p is
    // consumed
    probs_ds<M, DROP>(in.lg, q0, k0, ls, dl, s, dp, ps, true, ty, tx, a.drp, kb);
    __syncthreads();
    acc_keys<D, M>(ps, gs, ty, tx, dva);  // dv[key] += sum_q p[q][key] dout[q]
    __syncthreads();
    store_tile<M>(s, ps, ty, tx);
    __syncthreads();
    acc_keys<D, M>(ps, qs, ty, tx, dka);  // dk[key] += sum_q ds[q][key] q[q]
  }
  store_dkv<T, D, M>(dka, dva, dk, dv, bb, hh, a.h, k0, a.sk, a.dn, a.scale, ty, tx, c1);
}

// ---------------------------------------------------------------------------
// K3 on the tensor cores (bf16, fp16)
// ---------------------------------------------------------------------------
// grid (key tiles, h, b): the CTAs of one (batch, head) share its q, dout
// and out in L2; under causal masking the first key tiles are seen by the
// most query tiles, and they go first. The body (flash_attention.cuh::dkv_tc)
// with its dq product is K6's one-pass backward.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kTcThreads, 2)
dkv_tc_kernel(Args a, const T* __restrict__ out, const T* __restrict__ dout,
              const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv,
              int vec) {
  dkv_tc<T, D, DROP, false>(a, out, dout, lse, dk, dv, nullptr, vec);
}

template <typename T, int D, bool DROP>
cudaError_t bwd_dkv(const Args& a, const void* out, const void* dout,
                    const float* lse, void* dk, void* dv, cudaStream_t stream) {
  constexpr int M = tile_m(D);
  const size_t smem = sizeof(float) * bwd_smem_floats<D, M, DROP>();
  auto kern = dkv_kernel<T, D, M, DROP>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sk + Tile<M>::B - 1) / Tile<M>::B, a.h, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a, static_cast<const T*>(out),
                                         static_cast<const T*>(dout), lse,
                                         static_cast<T*>(dk), static_cast<T*>(dv));
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t bwd_dkv_wide(const Args& a, const void* out, const void* dout,
                         const float* lse, void* dk, void* dv, cudaStream_t stream) {
  constexpr int M = tile_m(kWide);
  const size_t smem = sizeof(float) * bwd_smem_floats<kWide, M, DROP>();
  auto kern = dkv_wide_kernel<T, DROP>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sk + Tile<M>::B - 1) / Tile<M>::B * wide_slices(a.dn), a.h, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a, static_cast<const T*>(out),
                                         static_cast<const T*>(dout), lse,
                                         static_cast<T*>(dk), static_cast<T*>(dv));
  return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t bwd_dkv_tc(const Args& a, const void* out, const void* dout,
                       const float* lse, void* dk, void* dv, int vec,
                       cudaStream_t stream) {
  const size_t smem = dkv_tc_smem_bytes<T, D, DROP, false>();
  auto kern = dkv_tc_kernel<T, D, DROP>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sk + kBK - 1) / kBK, a.h, a.b);
  kern<<<grid, kTcThreads, smem, stream>>>(a, static_cast<const T*>(out),
                                           static_cast<const T*>(dout), lse,
                                           static_cast<T*>(dk), static_cast<T*>(dv), vec);
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t dkv_any(const Args& a, const void* out, const void* dout, const float* lse,
                    void* dk, void* dv, int vec, cudaStream_t s) {
  const int w = width_of(a.dn);
  if (w == 0) return bwd_dkv_wide<T, DROP>(a, out, dout, lse, dk, dv, s);
  if constexpr (sizeof(T) == 2) {
    switch (w) {
#define PTT_CASE(D) \
  case D: return bwd_dkv_tc<T, D, DROP>(a, out, dout, lse, dk, dv, vec, s);
      PTT_TC_WIDTHS(PTT_CASE)
#undef PTT_CASE
      case 256: return bwd_dkv<T, 256, DROP>(a, out, dout, lse, dk, dv, s);
    }
  } else {
    switch (w) {
#define PTT_CASE(D) \
  case D: return bwd_dkv<T, D, DROP>(a, out, dout, lse, dk, dv, s);
      PTT_FLASH_WIDTHS(PTT_CASE)
#undef PTT_CASE
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ptt

extern "C" int ptt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, void* dk, void* dv,
    int b, int sq, int sk, int h, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long bsb, long long bsh, long long bsr,
    float scale, int causal, unsigned int seed0, unsigned int seed1, unsigned int thr,
    float inv_keep, int dtype, void* stream) {
  using namespace ptt;
  if (b == 0 || sk == 0 || h == 0) return cudaSuccess;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsr};
  const Args a = make_args(q, k, v, bias, b, sq, sk, h, d, st, scale, causal, seed0,
                           seed1, thr, inv_keep);
  const float* l = static_cast<const float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = rows_aligned(a) && aligned16(out) && aligned16(dout);
  const bool drop = thr < 65536u;
  switch (dtype) {
    case kFloat32:
      return drop ? dkv_any<float, true>(a, out, dout, l, dk, dv, vec, s)
                  : dkv_any<float, false>(a, out, dout, l, dk, dv, vec, s);
    case kBFloat16:
      return drop ? dkv_any<__nv_bfloat16, true>(a, out, dout, l, dk, dv, vec, s)
                  : dkv_any<__nv_bfloat16, false>(a, out, dout, l, dk, dv, vec, s);
    case kFloat16:
      return drop ? dkv_any<__half, true>(a, out, dout, l, dk, dv, vec, s)
                  : dkv_any<__half, false>(a, out, dout, l, dk, dv, vec, s);
  }
  return cudaErrorInvalidValue;
}
