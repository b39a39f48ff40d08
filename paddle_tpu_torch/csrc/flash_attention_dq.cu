// dq of the layout-swapping flash attention: kernel K2 of the port, beside
// K1 (flash_attention.cu, which describes the three kernels) and K3
// (flash_attention_dkv.cu).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel. One
// CTA per query tile swept over the key tiles its rows can see, so nothing
// is summed across CTAs and dq is the same bits from run to run; with
// dropout, dp is masked and scaled by the keep bits (:204-206).
//
// Bound on the H100 (GPT-3 Large, b 8, s 2048, 16 heads of 96, bf16,
// causal): three products over the visible (query, key) pairs (s = q k^T,
// dp = dout v^T, dq += ds k), ~155 GFLOP, ~0.16 ms at 989 TFLOP/s against
// ~0.03 ms of bytes: the tensor cores bound it.
//
// Routes:
//  * bf16 and fp16 up to width 128: tensor cores (csrc/flash_mma.cuh), K1's
//    scheme. A CTA of 4 warps owns a 64-query tile, 16 rows a warp; the
//    warp's q and dout A fragments are loaded once and stay in registers,
//    as do its rows' lse (in log2 units) and delta = rowsum(dout * out),
//    computed once from device memory while the first tiles land. k and v
//    stream through K1's two-stage cp.async ring in the input type, rows
//    padded by 16 bytes (plain loads for a misaligned view). Each 64-key
//    tile: s and dp as C fragments; scale, bias and mask in registers (the
//    mask only where the tile crosses the diagonal or the ragged end);
//    p = 2^(s log2e - lse log2e) with ex2 (0 on a row with no visible key:
//    its lse is +inf here); with dropout dp masked and scaled from the
//    warp's own keep bits (K1's row_keep_bits); ds * scale = p (dp - delta)
//    scale rounded to the input type in registers, as the TPU kernel rounds
//    it (flash_attention.py:207-209), is the A fragment of dq += ds k, with
//    k read transposed by ldmatrix.trans as K1 reads v. Above width 96 the
//    key tile is taken in halves of 32 (s and dp of a whole tile with q,
//    dout and dq fragments would not fit 255 registers). Query tiles go
//    longest first, as in K1.
//  * fp32, and width 256: fp32 FMA (csrc/flash_tile.cuh), fp32 ds (TF32
//    would not hold fp32's limits), dq scaled at the store.
//  * above width 256 (every type): FMA, the head dim in 256-column chunks
//    (flash_attention.cuh::kWide), a CTA a 256-column slice of dq.
#include "flash_attention.cuh"

namespace ptt {
namespace {

// ---------------------------------------------------------------------------
// K2 on fp32 FMA: one CTA per query tile, swept over key tiles
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

// ---------------------------------------------------------------------------
// K2 above width 256 (every type): the head dim in kWide-column chunks
// ---------------------------------------------------------------------------
// grid (query tiles x output slices, h, b): a CTA writes the kWide columns
// of dq in its slice; for every key tile it accumulates s and dp over the
// chunks of q, dout, k and v, then takes its slice of k for dq += ds k
template <typename T, bool DROP>
__global__ void __launch_bounds__(kThreads)
dq_wide_kernel(Args a, const T* __restrict__ out, const T* __restrict__ dout,
               const float* __restrict__ lse, T* __restrict__ dq) {
  constexpr int D = kWide, M = tile_m(D), B = Tile<M>::B, P = Tile<M>::Pad;
  extern __shared__ float smem[];
  float* kt = smem;                 // [D][P]  a chunk (then the slice) of k, transposed
  float* vt = kt + D * P;           // [D][P]  a chunk of v, transposed
  float* qs = vt + D * P;           // [B][D + 1] a chunk of the q rows
  float* gs = qs + B * (D + 1);     // [B][D + 1] a chunk of the dout rows
  float* ps = gs + B * (D + 1);     // [B][P] ds
  float* ls = ps + B * P;           // [B] lse
  float* dl = ls + B;               // [B] delta
  uint8_t* kb = reinterpret_cast<uint8_t*>(dl + B);  // keep bits

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nsl = wide_slices(a.dn), c1 = (blockIdx.x % nsl) * D;
  const int bb = blockIdx.z, hh = blockIdx.y, q0 = (blockIdx.x / nsl) * B;
  const uint32_t bh = static_cast<uint32_t>(bb * a.h + hh);
  const long long hd = static_cast<long long>(a.h) * a.dn;
  const Slice<T> in(a, bb, hh);
  const long long orow0 = static_cast<long long>(bb) * a.sq * hd + hh * a.dn;
  const float* lb = lse + (static_cast<long long>(bb) * a.h + hh) * a.sq;

  if (tid < B) ls[tid] = q0 + tid < a.sq ? lb[q0 + tid] : kNegInf;
  row_delta<T, M>(out + orow0, dout + orow0, hd, q0, a.sq, a.dn, dl);
  const int kend = in.lg.key_end(q0, B);

  float dqa[M][D / 16];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dqa[i][c] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += B) {
    float s[M][M] = {}, dp[M][M] = {};
    for (int c0 = 0; c0 < a.dn; c0 += D) {
      __syncthreads();  // the previous chunk (or tile) is no longer read
      load_rows<T, D, M>(in.q + c0, a.qs[1], q0, a.sq, a.dn - c0, 1.f, qs);
      load_rows<T, D, M>(dout + orow0 + c0, hd, q0, a.sq, a.dn - c0, 1.f, gs);
      load_kv_t<T, D, M>(in.k + c0, in.v + c0, a.ks[1], a.vs[1], k0, a.sk, a.dn - c0,
                         kt, vt);
      if (DROP && c0 == 0) fill_keep<M>(a.drp, bh, q0, k0, kb);
      __syncthreads();
      score_tiles<D, M, true>(qs, gs, kt, vt, ty, tx, s, dp);
    }
    __syncthreads();  // the last chunk of k is no longer read
    load_t<T, D, M>(in.k + c1, a.ks[1], k0, a.sk, a.dn - c1, kt);
    probs_ds<M, DROP>(in.lg, q0, k0, ls, dl, s, dp, ps, false, ty, tx, a.drp, kb);
    store_tile<M>(s, ps, ty, tx);
    __syncthreads();
    acc_rows<D, M>(ps, kt, ty, tx, dqa);  // dq[q] += sum_key ds[q][key] k[key]
  }

#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int row = q0 + ty * M + i;
    if (row >= a.sq) continue;
    T* drow = dq + orow0 + row * hd + c1;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      if (c1 + tx + 16 * c < a.dn) drow[tx + 16 * c] = from_f32<T>(dqa[i][c] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// K2 on the tensor cores (bf16, fp16)
// ---------------------------------------------------------------------------
// grid (query tiles, h, b), blockIdx.x = 0 the last (longest) tile, as K1
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kTcThreads, 2)
dq_tc_kernel(Args a, const T* __restrict__ out, const T* __restrict__ dout,
             const float* __restrict__ lse, T* __restrict__ dq, int vec) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int S = tc_stride<D>(), KT = D / 16, NT = D / 8, kTile = kBK * S;
  // keys a pass: the whole tile up to width 96, halves of 32 above
  constexpr int KP = D <= 96 ? kBK : kBK / 2, NP = kBK / KP, NJ = KP / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* const ring = reinterpret_cast<T*>(tc_smem);  // stage s: k tile, v tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bb = blockIdx.z, hh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const uint32_t bh = static_cast<uint32_t>(bb * a.h + hh);
  const Slice<T> in(a, bb, hh);
  const long long hd = static_cast<long long>(a.h) * a.dn;  // out, dout, dq rows
  const long long orow0 = static_cast<long long>(bb) * a.sq * hd + hh * a.dn;
  const float* lb = lse + (static_cast<long long>(bb) * a.h + hh) * a.sq;
  const int nk = (in.lg.key_end(q0, kBQ) + kBK - 1) / kBK;
  // this warp's keep bits: row r (of its 16) at kw + 8 r
  uint8_t* const kw = tc_smem + qrow_ring_bytes<T, D>() + warp * kQRowKeepBytes;

  // q and dout land in stage 1, are taken into registers, then the ring
  // starts
  T* qs = ring + 2 * kTile;
  tile_rows<T, D>(qs, in.q, a.qs[1], q0, a.sq, a, vec);
  tile_rows<T, D>(qs + kTile, dout + orow0, hd, q0, a.sq, a, vec);
  if (nk > 0) load_kv_rows<T, D>(in, a, 0, vec, ring, ring + kTile);
  cp_commit();

  // while they land: this thread's rows' lse in log2 units (+inf on a row
  // with no visible key or past sq, so p = 0) and delta = rowsum(dout *
  // out), a lane pair a row of the warp's 16, each every other column
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float l2[2], dl[2];
  {
    const int r = q0 + warp * 16 + (lane >> 1);
    float d = 0.f;
    if (r < a.sq) {
      const T* o = out + orow0 + r * hd;
      const T* gr = dout + orow0 + r * hd;
      for (int c = lane & 1; c < a.dn; c += 2) d = fmaf(to_f32(o[c]), to_f32(gr[c]), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      dl[rr] = __shfl_sync(0xffffffffu, d, 2 * (g + 8 * rr));
      const int row = row0 + 8 * rr;
      const float lr = row < a.sq ? lb[row] : kNegInf;
      l2[rr] = lr > 0.5f * kNegInf ? lr * kLog2e : CUDART_INF_F;
    }
  }
  cp_wait<0>();
  __syncthreads();
  uint32_t qf[KT][4], gf[KT][4];
  load_a(qf, qs, warp * 16, S);
  load_a(gf, qs + kTile, warp * 16, S);
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int k0 = i * kBK;
    if (i > 0) {
      cp_wait<0>();     // tile i has landed
      __syncthreads();  // ... for every thread, and tile i - 1 is no longer read
    }
    if (i + 1 < nk) {
      T* nxt = ring + ((i + 1) & 1) * 2 * kTile;
      load_kv_rows<T, D>(in, a, k0 + kBK, vec, nxt, nxt + kTile);
    }
    cp_commit();
    const T* ks = ring + (i & 1) * 2 * kTile;
    // keep bits of this thread's rows: byte j of keep[r] is key group j
    uint2 keep[2];
    if constexpr (DROP) row_keep_bits(a.drp, kw, k0, q0 + warp * 16, bh, keep);
#pragma unroll
    for (int hp = 0; hp < NP; ++hp) {
      const int kp = hp * KP;  // keys kp .. kp + KP of the tile
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<T, KT, NJ>(s, qf, ks, kp, S);           // s = q k^T
      mma_abt<T, KT, NJ>(dp, gf, ks + kTile, kp, S);  // dp = dout v^T
      log2_logits<NJ>(s, CausalBias{in.lg, q0, row0}, k0 + kp, a.scale);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = ex2(s[j][e] - l2[r]);
          float gd = dp[j][e];
          if constexpr (DROP)
            gd = drop(a.drp, keep_group(keep[r], hp * NJ + j), 2 * t + (e & 1), gd);
          s[j][e] = p * (gd - dl[r]) * a.scale;  // ds * scale
        }
      mma_pb<T, NJ / 2, NT>(acc, s, ks, kp, S);  // dq += (ds * scale) k
    }
  }
  const float one[2] = {1.f, 1.f};
  store_acc<T, NT>(acc, one, dq + orow0, hd, q0 + warp * 16, a.sq, a.dn);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
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
cudaError_t bwd_dq_wide(const Args& a, const void* out, const void* dout,
                        const float* lse, void* dq, cudaStream_t stream) {
  constexpr int M = tile_m(kWide);
  const size_t smem = sizeof(float) * bwd_smem_floats<kWide, M, DROP>();
  auto kern = dq_wide_kernel<T, DROP>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + Tile<M>::B - 1) / Tile<M>::B * wide_slices(a.dn), a.h, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a, static_cast<const T*>(out),
                                         static_cast<const T*>(dout), lse,
                                         static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t bwd_dq_tc(const Args& a, const void* out, const void* dout,
                      const float* lse, void* dq, int vec, cudaStream_t stream) {
  const size_t smem = qrow_smem_bytes<T, D, DROP>();
  auto kern = dq_tc_kernel<T, D, DROP>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  kern<<<grid, kTcThreads, smem, stream>>>(a, static_cast<const T*>(out),
                                           static_cast<const T*>(dout), lse,
                                           static_cast<T*>(dq), vec);
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t dq_any(const Args& a, const void* out, const void* dout, const float* lse,
                   void* dq, int vec, cudaStream_t s) {
  const int w = width_of(a.dn);
  if (w == 0) return bwd_dq_wide<T, DROP>(a, out, dout, lse, dq, s);
  if constexpr (sizeof(T) == 2) {
    switch (w) {
#define PTT_CASE(D) \
  case D: return bwd_dq_tc<T, D, DROP>(a, out, dout, lse, dq, vec, s);
      PTT_TC_WIDTHS(PTT_CASE)
#undef PTT_CASE
      case 256: return bwd_dq<T, 256, DROP>(a, out, dout, lse, dq, s);
    }
  } else {
    switch (w) {
#define PTT_CASE(D) \
  case D: return bwd_dq<T, D, DROP>(a, out, dout, lse, dq, s);
      PTT_FLASH_WIDTHS(PTT_CASE)
#undef PTT_CASE
    }
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
  // dout's rows stream through the ring beside q's (out is read directly)
  const int vec = rows_aligned(a) && aligned16(dout);
  const bool drop = thr < 65536u;
  switch (dtype) {
    case kFloat32:
      return drop ? dq_any<float, true>(a, out, dout, l, dq, vec, s)
                  : dq_any<float, false>(a, out, dout, l, dq, vec, s);
    case kBFloat16:
      return drop ? dq_any<__nv_bfloat16, true>(a, out, dout, l, dq, vec, s)
                  : dq_any<__nv_bfloat16, false>(a, out, dout, l, dq, vec, s);
    case kFloat16:
      return drop ? dq_any<__half, true>(a, out, dout, l, dq, vec, s)
                  : dq_any<__half, false>(a, out, dout, l, dq, vec, s);
  }
  return cudaErrorInvalidValue;
}
