// Length-masked (cached) attention forward (kernel K4 of the port).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_cached_fwd_kernel,
// which serves prefill, chunked prefill and speculative verify on the TPU.
// Here it serves every LengthMask attention call on the card: prefill,
// chunked prefill, decode (sq = 1) and verify (sq = spec_k + 1).
//
// Semantics (the LengthMask contract): key j attends to query row i of batch
// b iff j <= q_pos[b, i] and j < kv_len[b] (kv_len absent: j < sk). Scores
// and the softmax are fp32; a row with no valid key gives 0. q, k and v are
// read in the paddle layout [b, s, h, d] through their strides, so no
// transposed copy is made and a cache row view is read in place; out is
// contiguous [b, sq, h, d].
//
// Bound on the H100: at decode and verify, bytes: the valid prefix of every
// slot's K/V rows is read once (up to 2 x 8 x 1024 x 12 x 64 x 2 B = 25 MB a
// layer, ~7.5 us at 3.35 TB/s) for 1 to 5 query rows. At prefill (sq = sk =
// 1024) the causal score work, 4*d flops a valid (q, k) pair, is about
// 3.2 GFLOP a layer: operations, which need the tensor cores.
//
// Three routes, chosen by query rows, type and head dim in the launcher:
//  * sq > 8 (prefill, chunked prefill), bf16 and fp16, widths 16-128:
//    cached_tc_kernel, K1's tensor-core forward (flash_attention.cuh::
//    fwd_tc: 64 query rows a CTA, 16 a warp, q fragments in registers; K/V
//    64-key tiles through a two-stage cp.async ring in the input type,
//    rows padded by 16 B; the online softmax in log2 units; p rounded to
//    v's type as the A fragment of p v, as the TPU kernel rounds it, :575)
//    under the LengthMask policy: each thread loads its two rows' q_pos
//    once, the CTA takes the tile's largest, and the sweep stops at
//    min(kv_len, that + 1). No lse. Misaligned views take plain loads.
//  * sq <= 8 (decode, verify), every type, widths to 256: split keys
//    (flash-decoding). Grid (key parts, heads, slots), kPartKeys keys a
//    part; a part past its slot's last visible key exits at once, so the
//    slot with the longest prefix no longer sets the pace of the launch.
//    A CTA of 4 warps copies its part's K rows and V rows with 16-byte
//    cp.async in two groups, kept in the input type, so the scores (FMA,
//    lane = key, 32 keys a warp, bytes-bound: no tensor cores) run while V
//    lands. Each warp's 32 keys take their own row maxima, p is rounded to
//    v's type before p v; the 4 warps merge in shared memory and the part
//    writes its (m, l, acc) to an fp32 workspace. A second launch merges
//    the parts of each row in part order, so the bits repeat from run to
//    run.
//  * otherwise (fp32 and width 256 at sq > 8; every head dim above 256):
//    fp32 FMA, below.
//
// The FMA route (simple and right first):
//  * One CTA of 4 warps per (32-row q tile, head, batch); each warp owns 8
//    query rows and stages its own 32-key K/V tile in its private slice of
//    shared memory (fp32; K rows padded to d + 1 floats so that the 32
//    lanes, one key each, hit 32 banks). Warps never wait for each other.
//  * Scores: lane = key; the q rows are broadcast from shared memory. The
//    online-softmax update uses warp shuffles; acc holds d / 32 columns a
//    lane for each row. A warp stops at the last tile any of its rows can
//    see (max q_pos and kv_len).
//  * Head dims: instantiated at widths 32, 64, 96, 128 and 256; a head dim d
//    runs in the smallest width >= d, its columns >= d zero-filled on load
//    and skipped on store. At width 256 the K tile is staged 128 columns at
//    a time (the score sums the two halves). Above 256 (WIDE, one
//    instantiation a type): q and K stream in 128-column chunks over the
//    whole head dim, staged in turn through the same buffers, and the output
//    columns split over the grid's x dimension into 256-column slices, each
//    CTA recomputing the scores for its slice of V and out. Rows whose base
//    or stride is not 16-byte aligned, or whose head dim is not a whole
//    number of 16-byte pieces, load element by element.
#include "flash_attention.cuh"

namespace ptt {
namespace {

// ---------------------------------------------------------------------------
// sq > 8 at bf16/fp16 to width 128: K1's tensor-core forward under the
// length mask
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, D <= 96 ? 3 : 2)
cached_tc_kernel(Args a, const int* __restrict__ q_pos, const int* __restrict__ kv_len,
                 T* __restrict__ out, int vec) {
  __shared__ int tile_max[kTcWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bb = blockIdx.z, hh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int* qp = q_pos + static_cast<long long>(bb) * a.sq;
  const int klen = kv_len == nullptr ? a.sk : min(kv_len[bb], a.sk);
  // the tile's largest position: each warp over its 16 rows, then the CTA
  const int rw = q0 + warp * 16 + (lane & 15);
  const int wmax = __reduce_max_sync(0xffffffffu, rw < a.sq ? qp[rw] : -1);
  if (lane == 0) tile_max[warp] = wmax;
  __syncthreads();
  const int tmax = max(max(tile_max[0], tile_max[1]), max(tile_max[2], tile_max[3]));
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const LengthMask mk{max(0, min(klen, tmax + 1)), klen,
                      {row0 < a.sq ? qp[row0] : -1, row0 + 8 < a.sq ? qp[row0 + 8] : -1},
                      a.scale};
  fwd_tc<T, D, false>(a, Slice<T>(a, bb, hh), mk, bb, hh, q0, out, nullptr, vec);
}

// ---------------------------------------------------------------------------
// sq <= 8 to width 256, every type: split keys
// ---------------------------------------------------------------------------
constexpr int kDecodeRows = 8;   // query rows the split route takes
constexpr int kSplitWarps = 4;   // 32 keys a warp, one a lane
constexpr int kPartKeys = 32 * kSplitWarps;

// K and V of a part in the input type (row stride tc_stride), then the
// query rows in fp32; above 160 KB (fp32 at width 256) V reuses K's buffer
// after the scores
template <typename T, int D>
__host__ __device__ constexpr int part_tile_bytes() {
  return kPartKeys * tc_stride<D>() * static_cast<int>(sizeof(T));
}
template <typename T, int D>
__host__ __device__ constexpr bool part_shares_kv() {
  return 2 * part_tile_bytes<T, D>() > 160 * 1024;
}
template <typename T, int D>
__host__ __device__ constexpr int split_smem_bytes() {
  return (part_shares_kv<T, D>() ? 1 : 2) * part_tile_bytes<T, D>() +
         kDecodeRows * D * static_cast<int>(sizeof(float));
}

// one past the last key any row of slot bb sees: max over its rows of
// min(q_pos, klen - 1) + 1
__device__ __forceinline__ int slot_need(const int* qp, int sq, int klen) {
  int need = 0;
  for (int r = 0; r < sq; ++r) need = max(need, min(qp[r], klen - 1) + 1);
  return need;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the workspace record of (slot bb, head hh, part, row r): m (log2 units),
// l, then dn accumulator columns
__device__ __forceinline__ long long part_record(int bb, int hh, int part, int r,
                                                 const Args& a, int parts) {
  return ((static_cast<long long>(bb) * a.h + hh) * parts + part) * a.sq + r;
}

// grid (parts, h, b): the part-th kPartKeys keys of slot bb, head hh
template <typename T, int D>
__global__ void __launch_bounds__(32 * kSplitWarps)
cached_split_kernel(Args a, const int* __restrict__ q_pos, const int* __restrict__ kv_len,
                    float* __restrict__ ws, int vec) {
  static_assert(D % 8 == 0, "K rows go in 16-byte pieces");
  constexpr int S = tc_stride<D>(), CPL = (D + 31) / 32;  // acc columns a lane
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte piece
  constexpr bool kShare = part_shares_kv<T, D>();
  extern __shared__ __align__(16) unsigned char sp_smem[];
  T* const ks = reinterpret_cast<T*>(sp_smem);
  T* const vs = kShare ? ks : ks + kPartKeys * S;
  float* const qs =
      reinterpret_cast<float*>(sp_smem + (kShare ? 1 : 2) * part_tile_bytes<T, D>());

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int sq = a.sq;
  const int* qp = q_pos + static_cast<long long>(bb) * sq;
  const int klen = kv_len == nullptr ? a.sk : min(kv_len[bb], a.sk);
  const int need = slot_need(qp, sq, klen);
  const int j0 = part * kPartKeys;
  if (j0 >= need) return;  // no row of the slot sees a key of this part
  const Slice<T> in(a, bb, hh);

  // K, then V, rows j0 .. j0 + kPartKeys (zero-filled from need on)
  copy_rows(ks, S, in.k, a.ks[1], j0, kPartKeys, need, D, 32 * kSplitWarps, vec, a.dn);
  cp_commit();
  if (!kShare)
    copy_rows(vs, S, in.v, a.vs[1], j0, kPartKeys, need, D, 32 * kSplitWarps, vec, a.dn);
  cp_commit();
  // the query rows, times scale / ln 2 (logits in log2 units)
  const float sl2 = a.scale * kLog2e;
  for (int i = threadIdx.x; i < sq * D; i += 32 * kSplitWarps) {
    const int r = i / D, c = i % D;
    qs[r * D + c] = c < a.dn ? to_f32(in.q[r * a.qs[1] + c]) * sl2 : 0.f;
  }
  int pos[kDecodeRows];
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r) pos[r] = r < sq ? qp[r] : -1;
  cp_wait<1>();  // K has landed
  __syncthreads();

  // scores of this lane's key against every row
  const int kk = warp * 32 + lane, j = j0 + kk;
  float s[kDecodeRows];
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r) s[r] = 0.f;
  const T* krow = ks + kk * S;
#pragma unroll 2
  for (int c0 = 0; c0 < D; c0 += kPer) {
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + c0);
    const T* kv = reinterpret_cast<const T*>(&raw);
    float kx[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) kx[e] = to_f32(kv[e]);
#pragma unroll
    for (int r = 0; r < kDecodeRows; ++r) {
      if (r >= sq) break;
      const float4* qr = reinterpret_cast<const float4*>(qs + r * D + c0);
#pragma unroll
      for (int e4 = 0; e4 < kPer / 4; ++e4) {
        const float4 qv = qr[e4];
        s[r] = fmaf(qv.x, kx[4 * e4], s[r]);
        s[r] = fmaf(qv.y, kx[4 * e4 + 1], s[r]);
        s[r] = fmaf(qv.z, kx[4 * e4 + 2], s[r]);
        s[r] = fmaf(qv.w, kx[4 * e4 + 3], s[r]);
      }
    }
  }
  // the warp's 32 keys: their own row maxima, sums of the unrounded p, and p
  // rounded to v's type for p v
  float m[kDecodeRows], l[kDecodeRows], p[kDecodeRows];
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r) {
    m[r] = kNegInf;
    l[r] = p[r] = 0.f;
    if (r >= sq) continue;
    const float x = j <= pos[r] && j < klen ? s[r] : kNegInf;
    m[r] = warp_max(x);
    const float pr = m[r] > 0.5f * kNegInf ? ex2(x - m[r]) : 0.f;
    l[r] = warp_sum(pr);
    p[r] = to_f32(from_f32<T>(pr));
  }
  if (kShare) {
    __syncthreads();  // every warp's scores are done with K
    copy_rows(vs, S, in.v, a.vs[1], j0, kPartKeys, need, D, 32 * kSplitWarps, vec, a.dn);
    cp_commit();
  }
  cp_wait<0>();  // V has landed
  __syncthreads();

  // acc[r][c] (columns lane + 32 c) = sum over the warp's keys of p v
  float acc[kDecodeRows][CPL];
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
  const T* vw = vs + warp * 32 * S;
#pragma unroll 4
  for (int jj = 0; jj < 32; ++jj) {
    float vv[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      vv[c] = lane + 32 * c < D ? to_f32(vw[jj * S + lane + 32 * c]) : 0.f;
#pragma unroll
    for (int r = 0; r < kDecodeRows; ++r) {
      if (r >= sq) break;
      const float pj = __shfl_sync(0xffffffffu, p[r], jj);
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
    }
  }

  // merge the 4 warps through shared memory (K's buffer), warp by warp in
  // order: warp w's m and l at red[w * 2 kDecodeRows ..], its acc rows after
  __syncthreads();  // K and V are no longer read
  float* const red = reinterpret_cast<float*>(sp_smem);
  float* const racc = red + kSplitWarps * 2 * kDecodeRows;
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r) {
    if (r >= sq) break;
    if (lane == 0) {
      red[(warp * 2) * kDecodeRows + r] = m[r];
      red[(warp * 2 + 1) * kDecodeRows + r] = l[r];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (lane + 32 * c < D) racc[(warp * kDecodeRows + r) * D + lane + 32 * c] = acc[r][c];
  }
  __syncthreads();
  const int parts = gridDim.x;
  for (int i = threadIdx.x; i < sq * a.dn; i += 32 * kSplitWarps) {
    const int r = i / a.dn, c = i % a.dn;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, red[(w * 2) * kDecodeRows + r]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float f = ex2(red[(w * 2) * kDecodeRows + r] - mx);
      lsum += red[(w * 2 + 1) * kDecodeRows + r] * f;
      asum += racc[(w * kDecodeRows + r) * D + c] * f;
    }
    float* rec = ws + part_record(bb, hh, part, r, a, parts) * (a.dn + 2);
    if (c == 0) {
      rec[0] = mx;
      rec[1] = lsum;
    }
    rec[2 + c] = asum;
  }
}

// grid (h, b): the parts of each row of slot bb, head hh, merged in part
// order into out (contiguous (b, sq, h, dn)); 0 on a row with no visible key
template <typename T>
__global__ void __launch_bounds__(128)
cached_merge_kernel(Args a, const int* __restrict__ q_pos, const int* __restrict__ kv_len,
                    const float* __restrict__ ws, int parts, T* __restrict__ out) {
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int* qp = q_pos + static_cast<long long>(bb) * a.sq;
  const int klen = kv_len == nullptr ? a.sk : min(kv_len[bb], a.sk);
  const int np = (slot_need(qp, a.sq, klen) + kPartKeys - 1) / kPartKeys;
  for (int i = threadIdx.x; i < a.sq * a.dn; i += blockDim.x) {
    const int r = i / a.dn, c = i % a.dn;
    float mx = kNegInf;
    for (int pt = 0; pt < np; ++pt)
      mx = fmaxf(mx, ws[part_record(bb, hh, pt, r, a, parts) * (a.dn + 2)]);
    float lsum = 0.f, asum = 0.f;
    for (int pt = 0; pt < np; ++pt) {
      const float* rec = ws + part_record(bb, hh, pt, r, a, parts) * (a.dn + 2);
      const float f = ex2(rec[0] - mx);
      lsum += rec[1] * f;
      asum += rec[2 + c] * f;
    }
    out[((static_cast<long long>(bb) * a.sq + r) * a.h + hh) * a.dn + c] =
        from_f32<T>(lsum > 0.f ? asum / lsum : 0.f);
  }
}

// ---------------------------------------------------------------------------
// the FMA route: fp32, width 256 at sq > 8, every head dim above 256
// ---------------------------------------------------------------------------
constexpr int kFmaWarps = 4;
constexpr int kRPW = 8;     // query rows a warp holds
constexpr int kTile = 32;   // keys a tile (one a lane)

// 16 bytes of T -> floats
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  constexpr int n = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < n; ++i) dst[i] = to_f32(e[i]);
}

// the columns of K staged at once: all of them up to 128, half at 256
template <int D>
__host__ __device__ constexpr int k_chunk() {
  return D > 128 ? 128 : D;
}

template <int D>
__host__ __device__ constexpr int warp_smem_floats() {
  return kRPW * D + kTile * (k_chunk<D>() + 1) + kTile * D;
}

// keys j0 .. j0 + kTile of a K or V row block, columns c0 .. c0 + W, into
// dst[key][c] at stride `stride` (0 past sk and in columns >= dn): 16-byte
// loads when `vec`, element loads otherwise
template <typename T, int W>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const T* base,
                                           long long rs, int j0, int sk, int c0, int dn,
                                           bool vec) {
  constexpr int CH = 16 / sizeof(T);  // elements in a 16-byte load
  constexpr int CPR = W / CH;         // 16-byte pieces a row
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < kTile * CPR; idx += 32) {
    const int key = idx / CPR, c = (idx % CPR) * CH;
    const int j = j0 + key, col = c0 + c;
    float x[CH];
    const T* src = base + static_cast<long long>(j) * rs + col;
    if (j < sk && vec && col + CH <= dn) {
      load16(src, x);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) x[e] = j < sk && col + e < dn ? to_f32(src[e]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < CH; ++e) dst[key * stride + c + e] = x[e];
  }
}

// keys j0 .. j0 + kTile of K and V together (all D columns of both; the
// loads of a key's K and V pieces in flight at once), as stage_rows does
// for one of them
template <typename T, int D>
__device__ __forceinline__ void stage_kv(float* ks, float* vs, const T* kb, const T* vb,
                                         long long kss, long long vss, int j0, int sk,
                                         int dn, bool vec) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int CPR = D / CH;
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < kTile * CPR; idx += 32) {
    const int key = idx / CPR, c = (idx % CPR) * CH;
    const int j = j0 + key;
    float kx[CH], vx[CH];
    const T* ksrc = kb + static_cast<long long>(j) * kss + c;
    const T* vsrc = vb + static_cast<long long>(j) * vss + c;
    if (j < sk && vec && c + CH <= dn) {
      load16(ksrc, kx);
      load16(vsrc, vx);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        const bool ok = j < sk && c + e < dn;
        kx[e] = ok ? to_f32(ksrc[e]) : 0.f;
        vx[e] = ok ? to_f32(vsrc[e]) : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      ks[key * (D + 1) + c + e] = kx[e];
      vs[key * D + c + e] = vx[e];
    }
  }
}

template <typename T, int D, bool WIDE>
__global__ void __launch_bounds__(kFmaWarps * 32)
cached_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ q_pos,
                  const int* __restrict__ kv_len, T* __restrict__ out,
                  int sq, int sk, int h, int dn,
                  long long qsb, long long qss, long long qsh,
                  long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh, float scale, int vec) {
  static_assert(D % 32 == 0 && D <= 256, "width must be a multiple of 32, at most 256");
  static_assert(!WIDE || D == 256, "WIDE: width 256");
  constexpr int DPL = D / 32;             // acc columns a lane
  constexpr int KC = k_chunk<D>();        // K columns staged at once
  constexpr int NKC = D / KC;             // K chunks a tile
  constexpr int QT = kRPW * kFmaWarps;    // query rows a CTA

  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bb = blockIdx.z, hh = blockIdx.y;
  // WIDE: the CTA's output columns c1 .. c1 + D (slice blockIdx.x % nsl),
  // and the K chunks of the whole head dim
  const int nsl = WIDE ? (dn + D - 1) / D : 1;
  const int c1 = WIDE ? static_cast<int>(blockIdx.x % nsl) * D : 0;
  const int nkc = WIDE ? (dn + KC - 1) / KC : NKC;
  const int row0 = static_cast<int>(blockIdx.x / nsl) * QT + warp * kRPW;
  // rows of this warp that exist (warp-uniform): the loops below skip the
  // rest instead of computing masked rows
  const int nlive = max(0, min(kRPW, sq - row0));

  float* qs = smem + warp * warp_smem_floats<D>();
  float* ks = qs + kRPW * D;
  float* vs = ks + kTile * (KC + 1);
  const T* kb = k + bb * ksb + hh * ksh;
  const T* vb = v + bb * vsb + hh * vsh;

  // this warp's query rows, pre-scaled, into shared memory (WIDE: a chunk
  // at a time, in the tile loop)
  int qp[kRPW];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int row = row0 + r;
    const bool live = row < sq;
    qp[r] = live ? q_pos[static_cast<long long>(bb) * sq + row] : -1;
    if (WIDE) continue;
    const T* qr = q + bb * qsb + static_cast<long long>(row) * qss + hh * qsh;
    for (int e = lane; e < D; e += 32)
      qs[r * D + e] = live && e < dn ? to_f32(qr[e]) * scale : 0.f;
  }
  const int klen = kv_len == nullptr ? sk : min(kv_len[bb], sk);
  int need = 0;  // keys any row of this warp can see
#pragma unroll
  for (int r = 0; r < kRPW; ++r) need = max(need, min(qp[r], klen - 1) + 1);
  const int ntiles = (need + kTile - 1) / kTile;

  float m[kRPW], l[kRPW], acc[kRPW][DPL];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  __syncwarp();

  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * kTile;
    float s[kRPW];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) s[r] = 0.f;
#pragma unroll
    for (int kc = 0; kc < nkc; ++kc) {
      __syncwarp();  // the previous tile (or chunk) is no longer read
      if constexpr (NKC == 1) {
        stage_kv<T, D>(ks, vs, kb, vb, kss, vss, j0, sk, dn, vec);
      } else {
        stage_rows<T, KC>(ks, KC + 1, kb, kss, j0, sk, kc * KC, dn, vec);
        if (kc == 0) stage_rows<T, D>(vs, D, vb, vss, j0, sk, c1, dn, vec);
      }
      if constexpr (WIDE) {  // the chunk of this warp's query rows, pre-scaled
#pragma unroll
        for (int r = 0; r < kRPW; ++r) {
          const int row = row0 + r;
          const T* qr = q + bb * qsb + static_cast<long long>(row) * qss + hh * qsh;
          for (int e = lane; e < KC; e += 32) {
            const int col = kc * KC + e;
            qs[r * D + e] = row < sq && col < dn ? to_f32(qr[col]) * scale : 0.f;
          }
        }
      }
      __syncwarp();
      const int qc = WIDE ? 0 : kc * KC;  // the chunk's first column in qs
      for (int d = 0; d < KC; ++d) {
        const float kd = ks[lane * (KC + 1) + d];
#pragma unroll
        for (int r = 0; r < kRPW; ++r)
          if (r < nlive) s[r] = fmaf(qs[r * D + qc + d], kd, s[r]);
      }
    }
    const int j = j0 + lane;
    float p[kRPW];
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      if (r >= nlive) {
        p[r] = 0.f;
        continue;
      }
      const bool ok = j <= qp[r] && j < klen;
      const float sc = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      p[r] = ok ? __expf(sc - m_new) : 0.f;
      const float alpha = __expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
    }
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vv[c] = vs[jj * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        if (r >= nlive) continue;
        const float pj = __shfl_sync(0xffffffffu, p[r], jj);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

  const long long out_row = static_cast<long long>(h) * dn;
  T* ob = out + (static_cast<long long>(bb) * sq) * out_row + hh * dn + c1;
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int row = row0 + r;
    if (row >= sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (c1 + lane + 32 * c < dn)
        ob[row * out_row + lane + 32 * c] = from_f32<T>(acc[r][c] * inv);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename T, int D, bool WIDE = false>
cudaError_t launch_fma(const Args& a, const int* q_pos, const int* kv_len, void* out,
                       int vec, cudaStream_t stream) {
  constexpr int QT = kRPW * kFmaWarps;
  const size_t smem = sizeof(float) * kFmaWarps * warp_smem_floats<D>();
  auto kern = cached_fwd_kernel<T, D, WIDE>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  const int nsl = WIDE ? wide_slices(a.dn) : 1;  // output slices
  dim3 grid((a.sq + QT - 1) / QT * nsl, a.h, a.b);
  kern<<<grid, kFmaWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      q_pos, kv_len, static_cast<T*>(out), a.sq, a.sk, a.h, a.dn, a.qs[0], a.qs[1],
      a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2], a.scale, vec);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_tc(const Args& a, const int* q_pos, const int* kv_len, void* out,
                      cudaStream_t stream) {
  const size_t smem = qrow_smem_bytes<T, D, false>();
  auto kern = cached_tc_kernel<T, D>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, a.b);
  kern<<<grid, kTcThreads, smem, stream>>>(a, q_pos, kv_len, static_cast<T*>(out),
                                           rows_aligned(a));
  return cudaGetLastError();
}

// the number of key parts of the split route (the workspace's third dim)
int split_parts(int sk) { return sk > 0 ? (sk + kPartKeys - 1) / kPartKeys : 1; }

// vec: cp.async of whole rows (kv_rows16 and the head dim the width D)
template <typename T, int D>
cudaError_t launch_split(const Args& a, const int* q_pos, const int* kv_len, void* out,
                         float* ws, int vec, long long* ctas, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<T, D>();
  auto kern = cached_split_kernel<T, D>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return e;
  const int parts = split_parts(a.sk);
  const dim3 grid(parts, a.h, a.b);
  kern<<<grid, 32 * kSplitWarps, smem, stream>>>(a, q_pos, kv_len, ws, vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (ctas != nullptr) *ctas = static_cast<long long>(grid.x) * grid.y * grid.z;
  cached_merge_kernel<T><<<dim3(a.h, a.b), 128, 0, stream>>>(a, q_pos, kv_len, ws, parts,
                                                             static_cast<T*>(out));
  return cudaGetLastError();
}

// whether every K and V row is whole 16-byte pieces at 16-byte aligned
// addresses (bases and strides), the head dim a multiple of 16 bytes
template <typename T>
bool kv_rows16(const Args& a) {
  const long long per16 = 16 / sizeof(T);
  bool ok = aligned16(a.k) && aligned16(a.v) && a.dn % per16 == 0;
  for (int i = 0; i < 3; ++i) ok = ok && a.ks[i] % per16 == 0 && a.vs[i] % per16 == 0;
  return ok;
}

enum Route { kRouteFma = 0, kRouteTc = 1, kRouteSplit = 2 };

bool tc_width(int w) {
  switch (w) {
#define PTT_CASE(D) \
  case D: return true;
    PTT_TC_WIDTHS(PTT_CASE)
#undef PTT_CASE
  }
  return false;
}

// the one place K4's route is chosen: split keys up to kDecodeRows query
// rows at K1's widths, K1's tensor-core forward for 2-byte prefill at its
// tensor-core widths, the FMA kernel else (fp32, width 256 at sq > 8, and
// every head dim above 256)
Route route_of(int sq, int d, int dtype) {
  const int w = width_of(d);
  if (w == 0) return kRouteFma;
  if (sq <= kDecodeRows) return kRouteSplit;
  if (dtype != kFloat32 && tc_width(w)) return kRouteTc;
  return kRouteFma;
}

// floats of the split route's workspace: an (m, l, acc) record for each
// (slot, head, part, row)
long long split_ws_floats(int b, int sq, int sk, int h, int d) {
  return static_cast<long long>(b) * h * split_parts(sk) * sq * (d + 2);
}

template <typename T>
cudaError_t route(const Args& a, Route r, const int* q_pos, const int* kv_len, void* out,
                  float* ws, long long* ctas, cudaStream_t s) {
  const int w = width_of(a.dn);
  const int vec = kv_rows16<T>(a) ? 1 : 0;
  if (w == 0)  // above 256: the chunked FMA kernel
    return launch_fma<T, 256, true>(a, q_pos, kv_len, out, vec, s);
  if (r == kRouteSplit) {  // split keys at K1's widths
    switch (w) {
#define PTT_CASE(D) \
  case D: return launch_split<T, D>(a, q_pos, kv_len, out, ws, vec && a.dn == D, ctas, s);
      PTT_FLASH_WIDTHS(PTT_CASE)
#undef PTT_CASE
    }
    return cudaErrorInvalidValue;
  }
  if constexpr (sizeof(T) == 2) {
    if (r == kRouteTc) {
      switch (w) {
#define PTT_CASE(D) \
  case D: return launch_tc<T, D>(a, q_pos, kv_len, out, s);
        PTT_TC_WIDTHS(PTT_CASE)
#undef PTT_CASE
      }
    }
  }
  // the FMA kernel's widths: 32, 64, 96, 128 (fp32), 256
#define PTT_FMA(D) \
  if (a.dn <= D) return launch_fma<T, D>(a, q_pos, kv_len, out, vec, s);
  if constexpr (sizeof(T) == 4) {
    PTT_FMA(32)
    PTT_FMA(64)
    PTT_FMA(96)
    PTT_FMA(128)
  }
  PTT_FMA(256)
#undef PTT_FMA
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ptt

// K4's route for these shapes (0 FMA, 1 tensor cores, 2 split keys) and,
// on the split route, its key parts and workspace floats (0 otherwise): the
// wrapper sizes the workspace from this, so the part rule lives here only.
extern "C" int ptt_flash_attention_cached_plan(int b, int sq, int sk, int h, int d,
                                               int dtype, int* route, int* parts,
                                               long long* ws_floats) {
  using namespace ptt;
  if (d < 1 || (dtype != kFloat32 && dtype != kBFloat16 && dtype != kFloat16))
    return cudaErrorInvalidValue;
  const Route r = route_of(sq, d, dtype);
  *route = r;
  *parts = r == kRouteSplit ? split_parts(sk) : 0;
  *ws_floats = r == kRouteSplit ? split_ws_floats(b, sq, sk, h, d) : 0;
  return cudaSuccess;
}

// Strides (in elements): q, k and v each (batch, seq, head). ws: the split
// route's fp32 workspace of ws_floats floats (ptt_flash_attention_cached_plan
// gives the size; a smaller one is refused); ctas: if not null, set to the
// split kernel's grid size (0 on the other routes).
extern "C" int ptt_flash_attention_cached_fwd(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_len, void* out, void* ws, long long ws_floats, long long* ctas,
    int b, int sq, int sk, int h, int d,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, float scale,
    int dtype, void* stream) {
  using namespace ptt;
  if (ctas != nullptr) *ctas = 0;
  if (b == 0 || sq == 0 || h == 0) return cudaSuccess;
  if (d < 1) return cudaErrorInvalidValue;
  const Route r = route_of(sq, d, dtype);
  if (r == kRouteSplit &&
      (ws == nullptr || ws_floats < split_ws_floats(b, sq, sk, h, d)))
    return cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, 0, 0, 0};
  const Args a = make_args(q, k, v, nullptr, b, sq, sk, h, d, st, scale, 0, 0u, 0u,
                           65536u, 1.f);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kl = static_cast<const int*>(kv_len);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return route<float>(a, r, qp, kl, out, w, ctas, s);
    case kBFloat16: return route<__nv_bfloat16>(a, r, qp, kl, out, w, ctas, s);
    case kFloat16: return route<__half>(a, r, qp, kl, out, w, ctas, s);
  }
  return cudaErrorInvalidValue;
}
