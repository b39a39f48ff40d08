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
// recomputed per query tile from out and dout, as the TPU kernels do;
// ds = p * (dp - delta); dq = ds k * scale (K2, swept over key tiles),
// dk = (ds * scale)^T q and dv = p^T dout (K3, swept over query tiles). With
// that split nothing is summed across CTAs: no atomics, and the gradients
// are the same bits from run to run. As in the TPU kernels, K1 rounds p to
// the input type before p v (flash_attention.py:156) and K3 rounds p before
// p^T dout and ds * scale before ds^T q (:254, :257-259); K2 keeps p and ds
// in fp32.
//
// Bound on the H100 (GPT-3 Large, b = 8, s = 2048, h = 16, d = 96, bf16,
// causal): K1 does ~103 GFLOP of causal score work over ~0.2 GB, ~0.10 ms
// at 989 TFLOP/s; K2 and K3 each recompute the scores and dp and do one or
// two more products, ~0.16 and ~0.21 ms by operations. All three need the
// tensor cores to come near their bound.
//
// Two routes, chosen by the input type in the launcher; both hand-written:
//  * bf16 and fp16, K1 and K3: tensor cores (csrc/flash_mma.cuh). A CTA of
//    4 warps owns a 64-row tile, 16 rows a warp; the warp's q fragments (K1)
//    or k and v fragments (K3) stay in registers; the streamed 64-row tiles
//    (k, v in K1; q, dout, out in K3) come through a two-stage cp.async ring
//    in the input type, rows padded by 16 bytes (no swizzle), so the copy of
//    tile i + 1 overlaps the products of tile i with one barrier a tile (K3
//    adds one for its delta). Products are mma.sync m16n8k16 with fp32
//    accumulation; scale, bias and the mask are applied to the fp32 score
//    fragments in registers, the mask only on tiles that cross the diagonal
//    or the ragged end; the online softmax (K1) reduces over the 4 threads
//    of a row with shuffles, in log2 units (ex2.approx). p (K1, K3) and
//    ds * scale (K3) are rounded to the input type in registers and used as
//    the A fragments of the next product. K3 computes delta for each query tile
//    from its out and dout tiles in shared memory (16-byte loads, two threads
//    a row) and prefetches the tile's lse into registers a tile ahead. A
//    misaligned view (base or row stride not a multiple of 16 bytes) loads
//    its tiles with plain loads inside the same kernels. K1 launches its
//    query tiles longest first (causal tiles differ up to 32x in length).
//    Shared memory at d = 96: K1 52 KB (q lands in the second stage before
//    the ring starts), K3 79 KB (k and v likewise).
//  * fp32 (and K2 in every type): fp32 FMA on CUDA cores with the tile
//    scheme K5/K6 (csrc/flash_attention_packed.cu) share through
//    csrc/flash_tile.cuh, so fp32 results keep fp32 products (TF32 tensor
//    cores would not hold the fp32 models' limits):
//    - a CTA of 256 threads is a 16 x 16 grid; each thread owns a 4 x 4
//      micro-tile of every 64 x 64 score tile (rows ty*4+i, columns tx+16*j)
//      and the same 4 rows (or keys) of every 64 x d product, d/16 columns a
//      thread (6 at d = 96), so any d that is a multiple of 16 works;
//    - tiles live in shared memory as fp32; k and v tiles are stored
//      transposed with a padded stride (65), so both the score product
//      (lanes along keys) and p v or ds k (lanes along head_dim) read them
//      without bank conflicts (117 KB for K2 at d = 96);
//    - K1 and K2: one CTA per (64-row query tile, head, batch), streaming the
//      64-key tiles up to the last key its rows can see (causal tiles above
//      the diagonal are skipped). K3: one CTA per (64-key tile, head, batch),
//      streaming the query tiles from the first row that sees its first key.
//  * Row and column guards on every load and store: any sq and sk.
#include <math_constants.h>

#include <cstdint>

#include "flash_mma.cuh"

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

// ---------------------------------------------------------------------------
// K1 and K3 on the tensor cores (bf16, fp16)
// ---------------------------------------------------------------------------
// keys k0 .. k0 + kBK of k and v into kdst and vdst (row stride tc_stride)
template <typename T, int D>
__device__ __forceinline__ void load_kv_rows(const Slice<T>& in, const Args& a, int k0,
                                             bool vec, T* kdst, T* vdst) {
  constexpr int S = tc_stride<D>();
  copy_rows(kdst, S, in.k, a.ks[1], k0, kBK, a.sk, D, kTcThreads, vec);
  copy_rows(vdst, S, in.v, a.vs[1], k0, kBK, a.sk, D, kTcThreads, vec);
}

template <typename T, int D>
__host__ __device__ constexpr int fwd_tc_smem_bytes() {
  return 2 * 2 * kBK * tc_stride<D>() * static_cast<int>(sizeof(T));
}

// grid (query tiles, h, b): the CTAs of one (batch, head) run side by side
// and share its k and v in L2; blockIdx.x = 0 takes the last (longest) tile
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, D <= 96 ? 3 : 2)
fwd_tc_kernel(Args a, T* __restrict__ out, float* __restrict__ lse, int vec) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int S = tc_stride<D>(), KT = D / 16, NT = D / 8, kTile = kBK * S;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* const ring = reinterpret_cast<T*>(tc_smem);  // stage s: k tile, v tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bb = blockIdx.z, hh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const Slice<T> in(a, bb, hh);
  const int nk = (in.lg.key_end(q0) + kBK - 1) / kBK;

  // q lands in stage 1, is taken into registers, then the ring starts
  T* qs = ring + 2 * kTile;
  copy_rows(qs, S, in.q, a.qs[1], q0, kBQ, a.sq, D, kTcThreads, vec);
  if (nk > 0) load_kv_rows<T, D>(in, a, 0, vec, ring, ring + kTile);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  uint32_t qf[KT][4];
  load_a(qf, qs, warp * 16, S);
  __syncthreads();

  float acc[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

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
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<T, KT, kBK / 8>(s, qf, ks, 0, S);

    // logits in log2 units; kNegInf where masked
    const bool edge = a.bias != nullptr || k0 + kBK > a.sk ||
                      (a.causal && k0 + kBK - 1 > q0 + (a.sk - a.sq));
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8, col = k0 + j * 8 + 2 * t + (e & 1);
          s[j][e] = in.lg.visible(row, col) ? in.lg.at(s[j][e], row, col) * kLog2e
                                            : kNegInf;
        }
    } else {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
    }

    // online softmax; l keeps this thread's partial row sums (summed over
    // the quad at the end: every term shares the row's rescaling)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      const bool live = m_new > 0.5f * kNegInf;
      const float alpha = ex2(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = live ? ex2(s[j][e] - m_new) : 0.f;
          s[j][e] = p;
          rs += p;
        }
      l[r] = l[r] * alpha + rs;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        acc[c][2 * r] *= alpha;
        acc[c][2 * r + 1] *= alpha;
      }
    }
    mma_pb<T, kBK / 16, NT>(acc, s, ks + kTile, 0, S);  // o += p v
  }

  // out = acc / l (0 on a row with no visible key), lse = m + log l
  float mul[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    mul[r] = lr > 0.f ? 1.f / lr : 0.f;
    const int row = row0 + 8 * r;
    if (t == 0 && row < a.sq)
      lse[(static_cast<long long>(bb) * a.h + hh) * a.sq + row] =
          lr > 0.f ? m[r] * kLn2 + logf(lr) : kNegInf;
  }
  const long long hd = static_cast<long long>(a.h) * D;
  store_acc<T, NT>(acc, mul, out + static_cast<long long>(bb) * a.sq * hd + hh * D, hd,
                   q0 + warp * 16, a.sq);
}

// a K3 stage: q, dout and out tiles (row stride tc_stride), then the tile's
// lse in log2 units and delta, kBQ floats each
template <typename T, int D>
__host__ __device__ constexpr int dkv_tc_stage_bytes() {
  return 3 * kBQ * tc_stride<D>() * static_cast<int>(sizeof(T)) +
         2 * kBQ * static_cast<int>(sizeof(float));
}

// grid (key tiles, h, b): the CTAs of one (batch, head) share its q, dout
// and out in L2; under causal masking the first key tiles are seen by the
// most query tiles, and they go first
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 2)
dkv_tc_kernel(Args a, const T* __restrict__ out, const T* __restrict__ dout,
              const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv,
              int vec) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int S = tc_stride<D>(), KT = D / 16, NT = D / 8, kTile = kBQ * S;
  constexpr int kStage = dkv_tc_stage_bytes<T, D>();
  static_assert(kStage % 16 == 0, "stages stay 16-byte aligned");
  extern __shared__ __align__(16) unsigned char tc_smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bb = blockIdx.z, hh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const Slice<T> in(a, bb, hh);
  const long long hd = static_cast<long long>(a.h) * D;
  const long long orow0 = static_cast<long long>(bb) * a.sq * hd + hh * D;
  const T* ob = out + orow0;
  const T* gb = dout + orow0;
  const float* lb = lse + (static_cast<long long>(bb) * a.h + hh) * a.sq;
  const int qfirst = in.lg.first_q_tile(k0);
  const int nq = qfirst < a.sq ? (a.sq - qfirst + kBQ - 1) / kBQ : 0;

  auto tiles = [&](int st) { return reinterpret_cast<T*>(tc_smem + st * kStage); };
  auto load_stage = [&](int st, int q0) {
    T* d = tiles(st);
    copy_rows(d, S, in.q, a.qs[1], q0, kBQ, a.sq, D, kTcThreads, vec);
    copy_rows(d + kTile, S, gb, hd, q0, kBQ, a.sq, D, kTcThreads, vec);
    copy_rows(d + 2 * kTile, S, ob, hd, q0, kBQ, a.sq, D, kTcThreads, vec);
  };
  auto lse_at = [&](int row) { return row < a.sq ? lb[row] : kNegInf; };

  // k and v land in stage 1, are taken into registers, then the ring starts
  load_kv_rows<T, D>(in, a, k0, vec, tiles(1), tiles(1) + kTile);
  if (nq > 0) load_stage(0, qfirst);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  uint32_t kf[KT][4], vf[KT][4];
  load_a(kf, tiles(1), warp * 16, S);
  load_a(vf, tiles(1) + kTile, warp * 16, S);
  __syncthreads();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  // the next tile's lse, a register a row (threads < kBQ), loaded a tile ahead
  float lnext = threadIdx.x < kBQ && nq > 0 ? lse_at(qfirst + threadIdx.x) : 0.f;

  for (int i = 0; i < nq; ++i) {
    const int q0 = qfirst + i * kBQ;
    cp_wait<0>();     // tile i has landed
    __syncthreads();  // ... for every thread, and tile i - 1 is no longer read
    if (i + 1 < nq) load_stage((i + 1) & 1, q0 + kBQ);
    cp_commit();
    const T* qs = tiles(i & 1);
    const T* gs = qs + kTile;
    const T* os = qs + 2 * kTile;
    float* ls = reinterpret_cast<float*>(tiles(i & 1) + 3 * kTile);
    float* dl = ls + kBQ;
    // lse in log2 units, +inf on a row with no visible key or past sq (p = 0)
    if (threadIdx.x < kBQ) {
      ls[threadIdx.x] = lnext > 0.5f * kNegInf ? lnext * kLog2e : CUDART_INF_F;
      if (i + 1 < nq) lnext = lse_at(q0 + kBQ + threadIdx.x);
    }
    {  // delta = rowsum(dout * out): two threads a row, 16-byte loads
      const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
      float d = 0.f;
#pragma unroll
      for (int c = c0; c < c0 + D / 2; c += 8) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gs + r * S + c);
        const uint4 ov = *reinterpret_cast<const uint4*>(os + r * S + c);
        const T* gp = reinterpret_cast<const T*>(&gv);
        const T* op = reinterpret_cast<const T*>(&ov);
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(to_f32(gp[e]), to_f32(op[e]), d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if ((threadIdx.x & 1) == 0) dl[r] = d;
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * (kBQ / 2);  // query rows q0 + c0 .. + 31
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<T, KT, 4>(s, kf, qs, c0, S);   // s^T = k q^T
      mma_abt<T, KT, 4>(dp, vf, gs, c0, S);  // dp^T = v dout^T
      const bool edge = a.bias != nullptr || k0 + kBK > a.sk ||
                        (a.causal && k0 + kBK - 1 > q0 + c0 + (a.sk - a.sq));
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c0 + j * 8 + 2 * t + (e & 1);
          const int key = key0 + (e >> 1) * 8, row = q0 + qc;
          float x = s[j][e] * sl2;
          if (edge)
            x = in.lg.visible(row, key) ? in.lg.at(s[j][e], row, key) * kLog2e : -CUDART_INF_F;
          const float p = ex2(x - ls[qc]);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl[qc]) * a.scale;  // ds * scale
        }
      mma_pb<T, 2, NT>(dva, s, gs, c0, S);   // dv += p^T dout
      mma_pb<T, 2, NT>(dka, dp, qs, c0, S);  // dk += (ds * scale)^T q
    }
  }
  const float one[2] = {1.f, 1.f};
  const long long krow0 = static_cast<long long>(bb) * a.sk * hd + hh * D;
  store_acc<T, NT>(dka, one, dk + krow0, hd, k0 + warp * 16, a.sk);
  store_acc<T, NT>(dva, one, dv + krow0, hd, k0 + warp * 16, a.sk);
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

template <typename T, int D>
cudaError_t fwd_tc(const Args& a, void* out, float* lse, int vec, cudaStream_t stream) {
  const size_t smem = fwd_tc_smem_bytes<T, D>();
  auto kern = fwd_tc_kernel<T, D>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  kern<<<grid, kTcThreads, smem, stream>>>(a, static_cast<T*>(out), lse, vec);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv_tc(const Args& a, const void* out, const void* dout,
                       const float* lse, void* dk, void* dv, int vec,
                       cudaStream_t stream) {
  const size_t smem = 2 * dkv_tc_stage_bytes<T, D>();
  auto kern = dkv_tc_kernel<T, D>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sk + kBK - 1) / kBK, a.h, a.b);
  kern<<<grid, kTcThreads, smem, stream>>>(a, static_cast<const T*>(out),
                                           static_cast<const T*>(dout), lse,
                                           static_cast<T*>(dk), static_cast<T*>(dv), vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_tc_d(const Args& a, int d, void* out, float* lse, int vec,
                     cudaStream_t s) {
#define PTT_CASE(D) \
  case D: return fwd_tc<T, D>(a, out, lse, vec, s);
  switch (d) { PTT_FLASH_HEAD_DIMS(PTT_CASE) }
#undef PTT_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dkv_tc_d(const Args& a, int d, const void* out, const void* dout,
                     const float* lse, void* dk, void* dv, int vec, cudaStream_t s) {
#define PTT_CASE(D) \
  case D: return bwd_dkv_tc<T, D>(a, out, dout, lse, dk, dv, vec, s);
  switch (d) { PTT_FLASH_HEAD_DIMS(PTT_CASE) }
#undef PTT_CASE
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// whether every q, k and v row the tensor-core kernels copy is 16-byte
// aligned (2-byte elements): base pointers and (batch, seq, head) strides
int rows_aligned(const Args& a) {
  bool ok = aligned16(a.q) && aligned16(a.k) && aligned16(a.v);
  for (int i = 0; i < 3; ++i) ok = ok && a.qs[i] % 8 == 0 && a.ks[i] % 8 == 0 && a.vs[i] % 8 == 0;
  return ok ? 1 : 0;
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
// (batch, head, row), 0 on a broadcast dim. fp32 takes the FMA kernels;
// bf16 and fp16 take the tensor-core K1 and K3 (K2: FMA in every type).

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
    case kBFloat16: return fwd_tc_d<__nv_bfloat16>(a, d, out, l, rows_aligned(a), s);
    case kFloat16: return fwd_tc_d<__half>(a, d, out, l, rows_aligned(a), s);
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
  const int vec = rows_aligned(a) && aligned16(out) && aligned16(dout);
  switch (dtype) {
    case kFloat32: return dkv_d<float>(a, d, out, dout, l, dk, dv, s);
    case kBFloat16: return dkv_tc_d<__nv_bfloat16>(a, d, out, dout, l, dk, dv, vec, s);
    case kFloat16: return dkv_tc_d<__half>(a, d, out, dout, l, dk, dv, vec, s);
  }
  return cudaErrorInvalidValue;
}
