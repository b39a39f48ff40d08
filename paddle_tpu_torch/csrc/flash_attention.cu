// Layout-swapping flash attention: forward (kernel K1), dq (K2) and dk/dv
// (K3) of the port.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (K1),
// ::_bwd_dq_kernel (K2) and ::_bwd_dkv_kernel (K3), the custom-vjp triple
// behind every uncached attention call the packed kernels cannot take: a
// head dim that does not pack into 128 lanes (GPT-3 Large's 96), a
// per-batch or per-head (B|1, H|1, sq, sk) bias, or a trainable bias. K1
// also runs the packed forward K5
// (paddle_tpu/ops/pallas/flash_attention_packed.py::_fwd_kernel): its
// (b, s, h * d) views are (b, s, h, d) views with head stride d, and its
// shared (sq, sk) bias has batch and head strides 0
// (ops/cuda/flash_attention_packed.py).
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
// recomputed per query tile from out and dout, as the TPU kernels do;
// ds = p * (dp - delta); dq = ds k * scale (K2, swept over key tiles),
// dk = (ds * scale)^T q and dv = p^T dout (K3, swept over query tiles). With
// that split nothing is summed across CTAs: no atomics, and the gradients
// are the same bits from run to run. On the tensor-core route, as in the
// TPU kernels, K1 rounds p to the input type before p v
// (flash_attention.py:156), K2 rounds ds * scale before ds k (:207-209),
// and K3 rounds p before p^T dout and ds * scale before ds^T q (:254,
// :257-259).
//
// Attention dropout (the TPU kernels' in-kernel PRNG, :84-113): with p > 0
// the keep bits come from the counter-based Philox of csrc/philox.cuh, keyed
// by two seed words and counted from (batch, head, row, column), so K1, K2
// and K3 regenerate one mask whatever their tiling (K3 takes its query
// tiles in halves of 32). K1 scales the kept p by 1 / (1 - p) after l took
// the undropped p (:148-154); K2 masks and scales dp (:204-206); K3 does
// that and forms the dropped p for dv (:246-251). On the FMA route a tile's
// keep bits are drawn into shared memory by the whole CTA; on the mma.sync
// route each warp draws the bits of its own fragment rows (K1 and K2: 16
// query rows of 8-key groups, K3: 32 queries of its 16 keys) into a small
// warp-private buffer and reads each fragment element's bit from it.
// Dropout is a template switch: the p = 0 kernels are the code they were.
//
// Head dims: the kernels are instantiated at widths 16, 32, 64, 80, 96, 128
// and 256; a head dim d runs in the smallest width >= d, its columns >= d
// zero-filled on load (they add nothing to a dot product) and skipped on
// store. Width 256 takes the FMA route in every type with 32 x 32 tiles
// (64-row fp32 tiles would not fit a CTA's shared memory, and the mma.sync
// route's fragments would not fit 255 registers). Above 256 one chunked FMA
// kernel a type (flash_attention.cuh::kWide) takes any head dim: the head
// dim in 256-column chunks staged in turn through the width-256 buffers,
// the scores (and dp) summed over the chunks, and the output columns split
// over the grid into 256-column slices, each CTA recomputing the scores
// for its slice; K1 writes lse from slice 0.
//
// Bound on the H100 (GPT-3 Large, b = 8, s = 2048, h = 16, d = 96, bf16,
// causal): K1 does ~103 GFLOP of causal score work over ~0.2 GB, ~0.10 ms
// at 989 TFLOP/s; K2 and K3 each recompute the scores and dp and do one or
// two more products, ~0.16 and ~0.21 ms by operations. All three need the
// tensor cores to come near their bound.
//
// Two routes, chosen by the input type and width in the launcher; both
// hand-written:
//  * bf16 and fp16, widths up to 128: tensor cores (csrc/flash_mma.cuh;
//    K2's in flash_attention_dq.cu). A CTA of
//    4 warps owns a 64-row tile, 16 rows a warp; the warp's q fragments (K1),
//    q and dout fragments (K2) or k and v fragments (K3) stay in registers;
//    the streamed 64-row tiles (k, v in K1 and K2; q, dout, out in K3) come
//    through a two-stage cp.async ring
//    in the input type, rows padded by 16 bytes (no swizzle), so the copy of
//    tile i + 1 overlaps the products of tile i with one barrier a tile (K3
//    adds one for its delta). Products are mma.sync m16n8k16 with fp32
//    accumulation; scale, bias and the mask are applied to the fp32 score
//    fragments in registers, the mask only on tiles that cross the diagonal
//    or the ragged end; the online softmax (K1) reduces over the 4 threads
//    of a row with shuffles, in log2 units (ex2.approx). p (K1, K3) and
//    ds * scale (K2, K3) are rounded to the input type in registers and used
//    as the A fragments of the next product. K3 computes delta for each query tile
//    from its out and dout tiles in shared memory (16-byte loads, two threads
//    a row) and prefetches the tile's lse into registers a tile ahead. A
//    misaligned view (base or row stride not a multiple of 16 bytes) loads
//    its tiles with plain loads inside the same kernels. K1 and K2 launch
//    their query tiles longest first (causal tiles differ up to 32x in
//    length).
//    Shared memory at d = 96: K1 52 KB (q lands in the second stage before
//    the ring starts), K3 79 KB (k and v likewise).
//  * fp32, width 256 and above: fp32 FMA on CUDA cores with the tile
//    scheme K6 (csrc/flash_attention_packed.cu) shares through
//    csrc/flash_tile.cuh, so fp32 results keep fp32 products (TF32 tensor
//    cores would not hold the fp32 models' limits):
//    - a CTA of 256 threads is a 16 x 16 grid; each thread owns a 4 x 4
//      micro-tile of every 64 x 64 score tile (rows ty*4+i, columns tx+16*j)
//      and the same 4 rows (or keys) of every 64 x d product, d/16 columns a
//      thread (6 at d = 96), so any width that is a multiple of 16 works
//      (at width 256: 2 x 2 micro-tiles of 32 x 32 tiles);
//    - tiles live in shared memory as fp32; k and v tiles are stored
//      transposed with a padded stride (65), so both the score product
//      (lanes along keys) and p v or ds k (lanes along head_dim) read them
//      without bank conflicts (117 KB for K2 at d = 96);
//    - K1 and K2: one CTA per (64-row query tile, head, batch), streaming the
//      64-key tiles up to the last key its rows can see (causal tiles above
//      the diagonal are skipped). K3: one CTA per (64-key tile, head, batch),
//      streaming the query tiles from the first row that sees its first key.
//  * Row and column guards on every load and store: any sq and sk.
#include "flash_attention.cuh"

namespace ptt {
namespace {

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------
template <typename T, int D, int M, bool DROP>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(Args a, T* __restrict__ out, float* __restrict__ lse) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int B = Tile<M>::B, P = Tile<M>::Pad;
  extern __shared__ float smem[];
  float* qs = smem;                 // [B][D + 1] q rows
  float* kt = qs + B * (D + 1);     // [D][P]  k tile, transposed
  float* vt = kt + D * P;           // [D][P]  v tile, transposed
  float* ps = vt + D * P;           // [B][P] probabilities
  uint8_t* kb = reinterpret_cast<uint8_t*>(ps + B * P);  // keep bits

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bb = blockIdx.z, hh = blockIdx.y, q0 = blockIdx.x * B;
  const uint32_t bh = static_cast<uint32_t>(bb * a.h + hh);
  const Slice<T> in(a, bb, hh);
  load_rows<T, D, M>(in.q, a.qs[1], q0, a.sq, a.dn, 1.f, qs);
  const int kend = in.lg.key_end(q0, B);

  float m[M], l[M], acc[M][D / 16];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += B) {
    __syncthreads();  // the previous tile is no longer read
    load_kv_t<T, D, M>(in.k, in.v, a.ks[1], a.vs[1], k0, a.sk, a.dn, kt, vt);
    if constexpr (DROP) fill_keep<M>(a.drp, bh, q0, k0, kb);
    __syncthreads();
    float s[M][M];
    score_tile<D, M>(qs, kt, ty, tx, s);
    in.lg.mask(s, q0, k0, ty, tx);
    softmax_step<D, M, DROP>(s, m, l, acc, ps, ty, tx, a.drp, kb);
    __syncthreads();
    acc_rows<D, M>(ps, vt, ty, tx, acc);
  }
  store_out<T, D, M>(acc, m, l, out, lse, bb, hh, a.h, q0, a.sq, a.dn, ty, tx);
}

// ---------------------------------------------------------------------------
// K1 above width 256 (every type): the head dim in kWide-column chunks
// ---------------------------------------------------------------------------
// grid (query tiles x output slices, h, b): a CTA writes the kWide output
// columns of its slice; for every key tile it accumulates the scores over
// the chunks of q and k, staged in turn through the same buffers
template <typename T, bool DROP>
__global__ void __launch_bounds__(kThreads)
fwd_wide_kernel(Args a, T* __restrict__ out, float* __restrict__ lse) {
  constexpr int D = kWide, M = tile_m(D), B = Tile<M>::B, P = Tile<M>::Pad;
  extern __shared__ float smem[];
  float* qs = smem;                 // [B][D + 1] a chunk of the q rows
  float* kt = qs + B * (D + 1);     // [D][P]  a chunk of the k tile, transposed
  float* vt = kt + D * P;           // [D][P]  the slice of the v tile, transposed
  float* ps = vt + D * P;           // [B][P] probabilities
  uint8_t* kb = reinterpret_cast<uint8_t*>(ps + B * P);  // keep bits

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nsl = wide_slices(a.dn), c1 = (blockIdx.x % nsl) * D;
  const int bb = blockIdx.z, hh = blockIdx.y, q0 = (blockIdx.x / nsl) * B;
  const uint32_t bh = static_cast<uint32_t>(bb * a.h + hh);
  const Slice<T> in(a, bb, hh);
  const int kend = in.lg.key_end(q0, B);

  float m[M], l[M], acc[M][D / 16];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += B) {
    float s[M][M] = {};
    for (int c0 = 0; c0 < a.dn; c0 += D) {
      __syncthreads();  // the previous chunk (or tile) is no longer read
      load_rows<T, D, M>(in.q + c0, a.qs[1], q0, a.sq, a.dn - c0, 1.f, qs);
      load_t<T, D, M>(in.k + c0, a.ks[1], k0, a.sk, a.dn - c0, kt);
      if (c0 == 0) {
        load_t<T, D, M>(in.v + c1, a.vs[1], k0, a.sk, a.dn - c1, vt);
        if constexpr (DROP) fill_keep<M>(a.drp, bh, q0, k0, kb);
      }
      __syncthreads();
      score_tile<D, M, true>(qs, kt, ty, tx, s);
    }
    in.lg.mask(s, q0, k0, ty, tx);
    softmax_step<D, M, DROP>(s, m, l, acc, ps, ty, tx, a.drp, kb);
    __syncthreads();
    acc_rows<D, M>(ps, vt, ty, tx, acc);
  }
  store_out<T, D, M>(acc, m, l, out, lse, bb, hh, a.h, q0, a.sq, a.dn, ty, tx, c1);
}

// ---------------------------------------------------------------------------
// K1 on the tensor cores (bf16, fp16)
// ---------------------------------------------------------------------------
// grid (query tiles, h, b): the CTAs of one (batch, head) run side by side
// and share its k and v in L2; blockIdx.x = 0 takes the last (longest) tile.
// The body (flash_attention.cuh::fwd_tc) also runs K4's prefill.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(kTcThreads, D <= 96 ? 3 : 2)
fwd_tc_kernel(Args a, T* __restrict__ out, float* __restrict__ lse, int vec) {
  const int bb = blockIdx.z, hh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const Slice<T> in(a, bb, hh);
  const int row0 = q0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
  fwd_tc<T, D, DROP>(a, in, CausalBias{in.lg, q0, row0}, bb, hh, q0, out, lse, vec);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename T, int D, bool DROP>
cudaError_t fwd(const Args& a, void* out, float* lse, cudaStream_t stream) {
  constexpr int M = tile_m(D);
  const size_t smem = sizeof(float) * fwd_smem_floats<D, M, DROP>();
  auto kern = fwd_kernel<T, D, M, DROP>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + Tile<M>::B - 1) / Tile<M>::B, a.h, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a, static_cast<T*>(out), lse);
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t fwd_wide(const Args& a, void* out, float* lse, cudaStream_t stream) {
  constexpr int M = tile_m(kWide);
  const size_t smem = sizeof(float) * fwd_smem_floats<kWide, M, DROP>();
  auto kern = fwd_wide_kernel<T, DROP>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + Tile<M>::B - 1) / Tile<M>::B * wide_slices(a.dn), a.h, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a, static_cast<T*>(out), lse);
  return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t fwd_tc(const Args& a, void* out, float* lse, int vec, cudaStream_t stream) {
  const size_t smem = qrow_smem_bytes<T, D, DROP>();
  auto kern = fwd_tc_kernel<T, D, DROP>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  kern<<<grid, kTcThreads, smem, stream>>>(a, static_cast<T*>(out), lse, vec);
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t fwd_any(const Args& a, void* out, float* lse, int vec, cudaStream_t s) {
  const int w = width_of(a.dn);
  if (w == 0) return fwd_wide<T, DROP>(a, out, lse, s);
  if constexpr (sizeof(T) == 2) {
    switch (w) {
#define PTT_CASE(D) \
  case D: return fwd_tc<T, D, DROP>(a, out, lse, vec, s);
      PTT_TC_WIDTHS(PTT_CASE)
#undef PTT_CASE
      case 256: return fwd<T, 256, DROP>(a, out, lse, s);
    }
  } else {
    switch (w) {
#define PTT_CASE(D) \
  case D: return fwd<T, D, DROP>(a, out, lse, s);
      PTT_FLASH_WIDTHS(PTT_CASE)
#undef PTT_CASE
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ptt

// Strides (in elements): q, k and v each (batch, seq, head), then the bias
// (batch, head, row), 0 on a broadcast dim. d: any head dim. fp32 takes the
// FMA kernels; bf16 and fp16 take the tensor-core K1-K3 up to width 128,
// FMA above. Dropout: seed0, seed1 and the keep
// threshold thr of csrc/philox.cuh, and inv_keep = 1 / (1 - p); thr = 65536
// (no 16-bit value is below it) means no dropout and takes the p = 0
// kernels.

extern "C" int ptt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* lse, int b, int sq, int sk, int h, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long bsb, long long bsh,
    long long bsr, float scale, int causal, unsigned int seed0, unsigned int seed1,
    unsigned int thr, float inv_keep, int dtype, void* stream) {
  using namespace ptt;
  if (b == 0 || sq == 0 || h == 0) return cudaSuccess;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, bsb, bsh, bsr};
  const Args a = make_args(q, k, v, bias, b, sq, sk, h, d, st, scale, causal, seed0,
                           seed1, thr, inv_keep);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = thr < 65536u;
  const int vec = rows_aligned(a);
  switch (dtype) {
    case kFloat32:
      return drop ? fwd_any<float, true>(a, out, l, vec, s) : fwd_any<float, false>(a, out, l, vec, s);
    case kBFloat16:
      return drop ? fwd_any<__nv_bfloat16, true>(a, out, l, vec, s)
                  : fwd_any<__nv_bfloat16, false>(a, out, l, vec, s);
    case kFloat16:
      return drop ? fwd_any<__half, true>(a, out, l, vec, s) : fwd_any<__half, false>(a, out, l, vec, s);
  }
  return cudaErrorInvalidValue;
}
