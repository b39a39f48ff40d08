// dq of the layout-swapping flash attention: kernel K2 of the port, beside
// K1 (flash_attention.cu, which describes the three kernels) and K3
// (flash_attention_dkv.cu).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel. fp32
// FMA in every type (csrc/flash_tile.cuh), one CTA per query tile swept over
// the key tiles its rows can see; with dropout, dp is masked and scaled by
// the tile's keep bits (:204-206).
#include "flash_attention.cuh"

namespace ptt {
namespace {

// ---------------------------------------------------------------------------
// K2: dq, one CTA per query tile, swept over key tiles
// ---------------------------------------------------------------------------
template <typename T, int D, int M, bool DROP>
__global__ void __launch_bounds__(kThreads)
dq_kernel(Args a, const T* __restrict__ out, const T* __restrict__ dout,
          const float* __restrict__ lse, T* __restrict__ dq) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int B = Tile<M>::B, P = Tile<M>::Pad;
  extern __shared__ float smem[];
  float* kt = smem;                 // [D][P]  k tile, transposed
  float* vt = kt + D * P;           // [D][P]  v tile, transposed
  float* qs = vt + D * P;           // [B][D + 1] q rows
  float* gs = qs + B * (D + 1);     // [B][D + 1] dout rows
  float* ps = gs + B * (D + 1);     // [B][P] ds
  float* ls = ps + B * P;           // [B] lse
  float* dl = ls + B;               // [B] delta
  uint8_t* kb = reinterpret_cast<uint8_t*>(dl + B);  // keep bits

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bb = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * B;
  const uint32_t bh = static_cast<uint32_t>(bb * a.h + hh);
  const long long hd = static_cast<long long>(a.h) * a.dn;  // contiguous row
  const Slice<T> in(a, bb, hh);
  const long long orow0 = static_cast<long long>(bb) * a.sq * hd + hh * a.dn;
  const float* lb = lse + (static_cast<long long>(bb) * a.h + hh) * a.sq;

  load_q_tile<T, D, M>(in.q, a.qs[1], out + orow0, dout + orow0, hd, lb, q0, a.sq,
                       a.dn, qs, gs, ls, dl);
  const int kend = in.lg.key_end(q0, B);

  float dqa[M][D / 16];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dqa[i][c] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += B) {
    __syncthreads();  // the previous tile is no longer read
    load_kv_t<T, D, M>(in.k, in.v, a.ks[1], a.vs[1], k0, a.sk, a.dn, kt, vt);
    if constexpr (DROP) fill_keep<M>(a.drp, bh, q0, k0, kb);
    __syncthreads();
    float s[M][M], dp[M][M];
    score_tiles<D, M>(qs, gs, kt, vt, ty, tx, s, dp);
    probs_ds<M, DROP>(in.lg, q0, k0, ls, dl, s, dp, ps, false, ty, tx, a.drp, kb);
    store_tile<M>(s, ps, ty, tx);
    __syncthreads();
    acc_rows<D, M>(ps, kt, ty, tx, dqa);  // dq[q] += sum_key ds[q][key] k[key]
  }

#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int row = q0 + ty * M + i;
    if (row >= a.sq) continue;
    T* drow = dq + orow0 + row * hd;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      if (tx + 16 * c < a.dn) drow[tx + 16 * c] = from_f32<T>(dqa[i][c] * a.scale);
  }
}

template <typename T, int D, bool DROP>
cudaError_t bwd_dq(const Args& a, const void* out, const void* dout,
                   const float* lse, void* dq, cudaStream_t stream) {
  constexpr int M = tile_m(D);
  const size_t smem = sizeof(float) * bwd_smem_floats<D, M, DROP>();
  auto kern = dq_kernel<T, D, M, DROP>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + Tile<M>::B - 1) / Tile<M>::B, a.h, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a, static_cast<const T*>(out),
                                         static_cast<const T*>(dout), lse,
                                         static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t dq_any(const Args& a, const void* out, const void* dout, const float* lse,
                   void* dq, cudaStream_t s) {
  switch (width_of(a.dn)) {
#define PTT_CASE(D) \
  case D: return bwd_dq<T, D, DROP>(a, out, dout, lse, dq, s);
    PTT_FLASH_WIDTHS(PTT_CASE)
#undef PTT_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ptt

extern "C" int ptt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* bias,
    const void* out, const void* dout, const void* lse, void* dq, int b,
    int sq, int sk, int h, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long bsb, long long bsh, long long bsr, float scale,
    int causal, unsigned int seed0, unsigned int seed1, unsigned int thr,
    float inv_keep, int dtype, void* stream) {
  using namespace ptt;
  if (b == 0 || sq == 0 || h == 0) return cudaSuccess;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsr};
  const Args a = make_args(q, k, v, bias, b, sq, sk, h, d, st, scale, causal, seed0,
                           seed1, thr, inv_keep);
  const float* l = static_cast<const float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = thr < 65536u;
  switch (dtype) {
    case kFloat32:
      return drop ? dq_any<float, true>(a, out, dout, l, dq, s)
                  : dq_any<float, false>(a, out, dout, l, dq, s);
    case kBFloat16:
      return drop ? dq_any<__nv_bfloat16, true>(a, out, dout, l, dq, s)
                  : dq_any<__nv_bfloat16, false>(a, out, dout, l, dq, s);
    case kFloat16:
      return drop ? dq_any<__half, true>(a, out, dout, l, dq, s)
                  : dq_any<__half, false>(a, out, dout, l, dq, s);
  }
  return cudaErrorInvalidValue;
}
