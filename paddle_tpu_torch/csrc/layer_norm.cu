// LayerNorm over the last axis: forward (kernel K7 of the port) and backward
// (kernel K8).
//
// Replaces: paddle_tpu/ops/pallas/layer_norm.py::_fwd_kernel (K7) and
// ::_bwd_kernel (K8), the custom-vjp pair behind nn/functional/norm.py::
// layer_norm.
//
// Bound on the H100: bytes. K7 reads each row once and writes it once (2
// bytes an element in bf16; GPT-2 124M's train step, 24576 rows of 768:
// 75 MB, 0.0225 ms at 3.35 TB/s); K8 reads x and dy once and writes dx once
// (113 MB, 0.0338 ms). The work is 8 (K7) and ~20 (K8) flops an element,
// far below the ~295 flops a byte where the tensor cores would become the
// limit. At the serving shapes (8 to 1024 rows of 768) a call moves 12 KB to
// 3 MB, so at decode it is bound by the launch itself.
//
// Design (row kernels, widths up to 8 16-byte vectors a lane for K7 and 6
// for K8: 2048 / 1536 bf16 or fp16 columns, 1024 / 768 fp32): one warp a
// row. Each lane holds its columns of the row as 16-byte vectors (8 bf16 or
// fp16, 4 fp32) in registers, so the row is read from device memory once,
// and the mean and the centred variance are warp-shuffle sums: no barrier
// in the row loop. CTAs of 8 warps are persistent (as many as fit on the
// card, grid-striding over rows), stage gamma and beta once in shared
// memory in fp32, in the order the lanes read them (no bank conflicts), and
// request the next row's vectors before the current row's reductions, so a
// row's worth of loads stays in flight per warp. Widths that are not a
// multiple of the vector, or rows that are not 16-byte aligned (a view at
// an odd offset), take the same kernels with one element an access.
//
// K8 recomputes the row statistics (two-pass mean and variance, as the
// forward), dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
// with dxhat = dy * gamma, and each lane keeps fp32 partial sums of dy * xhat
// and dy for its own columns across all the rows its warp visits. After the
// row loop the CTA's warps add their partials in warp order in shared
// memory and the CTA writes one row of a (2, parts, features) workspace;
// a second launch sums the parts per column, 32 columns and 32 groups of
// parts a CTA, in a fixed order, and casts to gamma's dtype. No float
// atomics: dgamma and dbeta are the same bits from launch to launch (the
// parts are fixed by the card's SM count and the kernel's occupancy), where
// the TPU kernel accumulates them in one revisited output block across its
// sequential grid.
//
// General kernels (wider rows, any width: GPT-3 175B's 12288): one CTA of
// 256 threads a row (grid-striding), looping over the row in chunks — mean,
// then the centred variance, then the output — re-reading the row from
// L1/L2 (the loops over a thread's accesses unrolled by 4, so that its
// loads are in flight together), with block reductions. Up to 16384
// columns they stage gamma and beta in shared memory in fp32, and K8's CTA
// sums its dgamma/dbeta partials there too (each thread owns its columns)
// before writing them to its workspace rows, which the same second launch
// sums; wider rows read gamma in place and sum in the workspace rows.
//
// Statistics are fp32 and two-pass as JAX's `_stats`; the output is in x's
// dtype; gamma and beta may be fp32 while x is bf16 (read through w_dtype);
// dgamma and dbeta are fp32 sums cast to gamma's dtype.
#include <cstdint>
#include <initializer_list>
#include <map>
#include <mutex>
#include <utility>

#include "common.cuh"

namespace ptt {
namespace {

constexpr int kWarps = 8;                 // rows a row-kernel CTA holds at once
constexpr int kRowThreads = kWarps * 32;
constexpr int kGeneralThreads = 256;
constexpr int kFwdMaxAccesses = 8;        // accesses a lane holds of one row
constexpr int kBwdMaxAccesses = 6;
constexpr int kGeneralBwdCtasPerSm = 2;   // bounds the general K8's workspace
// widths up to which the general kernels stage their fp32 columns in shared
// memory (K7: gamma, beta; K8: gamma, dgamma and dbeta partials: 192 KB)
constexpr int kGeneralSmemColumns = 16384;
constexpr int kMaxDynamicSmem = 3 * kGeneralSmemColumns * 4;

// kernel kinds (ptt_layer_norm_plan reports them)
enum Kind : int { kRowsVector = 0, kRowsScalar = 1, kGeneralVector = 2,
                  kGeneralScalar = 3 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// gamma / beta element i as fp32, by its dtype code
__device__ __forceinline__ float load_w(const void* p, long long i, int code) {
  switch (code) {
    case kBFloat16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case kFloat16: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

// 16-bit element <-> fp32 by bits (bf16 widens by a shift)
template <typename T> struct Bits;
template <> struct Bits<__nv_bfloat16> {
  static __device__ __forceinline__ float to(unsigned b) { return __uint_as_float(b << 16); }
  static __device__ __forceinline__ unsigned from(float f) {
    return __bfloat16_as_ushort(__float2bfloat16(f));
  }
};
template <> struct Bits<__half> {
  static __device__ __forceinline__ float to(unsigned b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }
  static __device__ __forceinline__ unsigned from(float f) {
    return __half_as_ushort(__float2half(f));
  }
};

// One access of a lane: a 16-byte vector (V) or one element.
template <typename T, bool V> struct Io {
  static constexpr int E = 16 / sizeof(T);
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[E]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (E == 4) {
        f[k] = __uint_as_float(w[k]);
      } else {
        f[2 * k] = Bits<T>::to(w[k] & 0xffffu);
        f[2 * k + 1] = Bits<T>::to(w[k] >> 16);
      }
    }
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[E]) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (E == 4) {
        w[k] = __float_as_uint(f[k]);
      } else {
        w[k] = Bits<T>::from(f[2 * k]) | (Bits<T>::from(f[2 * k + 1]) << 16);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <typename T> struct Io<T, false> {
  static constexpr int E = 1;
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) {
    f[0] = to_f32(r);
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) {
    *p = from_f32<T>(f[0]);
  }
};

// Shared-memory slot of column c in the lanes' read order: access a = c / E
// (lane a % 32, register a / 32), element c % E; a warp reading one element
// of one access touches 32 consecutive slots.
template <int E>
__device__ __forceinline__ int slot(int c) {
  const int a = c / E, e = c - a * E;
  return ((a >> 5) * E + e) * 32 + (a & 31);
}

// the lane's accesses of row r (nothing past the last row)
template <typename IO, int NV, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ x, long long r,
                                         long long rows, int features,
                                         int n_acc, int lane,
                                         typename IO::Raw (&out)[NV]) {
  if (r >= rows) return;
  const T* xr = x + r * features;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int a = i * 32 + lane;
    if (a < n_acc) out[i] = IO::load(xr + a * IO::E);
  }
}

// ---- K7, row kernel: one warp a row ----------------------------------------
template <typename T, int NV, bool V>
__global__ void __launch_bounds__(kRowThreads)
ln_fwd_rows(const T* __restrict__ x, const void* __restrict__ gamma,
            const void* __restrict__ beta, int w_dtype, T* __restrict__ y,
            long long rows, int features, float eps) {
  using IO = Io<T, V>;
  constexpr int E = IO::E;
  extern __shared__ __align__(16) float smem[];
  float2* gb = reinterpret_cast<float2*>(smem);  // (gamma, beta) by slot
  const int lane = threadIdx.x & 31;
  const int n_acc = features / E;
  const float inv_n = 1.f / static_cast<float>(features);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  typename IO::Raw cur[NV], nxt[NV];
  // the first row is requested before gamma and beta are staged
  load_row<IO, NV>(x, r, rows, features, n_acc, lane, cur);
  for (int c = threadIdx.x; c < features; c += blockDim.x)
    gb[slot<E>(c)] = make_float2(load_w(gamma, c, w_dtype),
                                 load_w(beta, c, w_dtype));
  __syncthreads();
  for (; r < rows; r += stride) {
    load_row<IO, NV>(x, r + stride, rows, features, n_acc, lane, nxt);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < n_acc) {
        float f[E];
        IO::unpack(cur[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) sum += f[e];
      }
    }
    const float mean = warp_sum(sum) * inv_n;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < n_acc) {
        float f[E];
        IO::unpack(cur[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = f[e] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_n + eps);
    T* yr = y + r * features;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int a = i * 32 + lane;
      if (a < n_acc) {
        float f[E];
        IO::unpack(cur[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float2 w = gb[(i * E + e) * 32 + lane];
          f[e] = (f[e] - mean) * rstd * w.x + w.y;
        }
        IO::store(yr + a * E, f);
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

// ---- K8, row kernel: one warp a row, dgamma/dbeta partials in registers ----
template <typename T, int NV, bool V>
__global__ void __launch_bounds__(kRowThreads)
ln_bwd_rows(const T* __restrict__ x, const void* __restrict__ gamma,
            int w_dtype, const T* __restrict__ dy, T* __restrict__ dx,
            float* __restrict__ part, int parts, long long rows, int features,
            float eps) {
  using IO = Io<T, V>;
  constexpr int E = IO::E;
  constexpr int S = NV * 32 * E;  // slots
  extern __shared__ __align__(16) float smem[];
  float* sg = smem;        // gamma by slot
  float* cg = smem + S;    // the CTA's dgamma, then dbeta, partials by slot
  float* cb = cg + S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_acc = features / E;
  const float inv_n = 1.f / static_cast<float>(features);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  float ag[NV][E], ab[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) ag[i][e] = ab[i][e] = 0.f;
  typename IO::Raw cx[NV], cd[NV], nx[NV], nd[NV];
  // the first row is requested before gamma is staged
  load_row<IO, NV>(x, r, rows, features, n_acc, lane, cx);
  load_row<IO, NV>(dy, r, rows, features, n_acc, lane, cd);
  for (int c = threadIdx.x; c < features; c += blockDim.x)
    sg[slot<E>(c)] = load_w(gamma, c, w_dtype);
  __syncthreads();
  for (; r < rows; r += stride) {
    load_row<IO, NV>(x, r + stride, rows, features, n_acc, lane, nx);
    load_row<IO, NV>(dy, r + stride, rows, features, n_acc, lane, nd);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < n_acc) {
        float f[E];
        IO::unpack(cx[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) sum += f[e];
      }
    }
    const float mean = warp_sum(sum) * inv_n;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < n_acc) {
        float f[E];
        IO::unpack(cx[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = f[e] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_n + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < n_acc) {
        float f[E], d[E];
        IO::unpack(cx[i], f);
        IO::unpack(cd[i], d);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float dxh = d[e] * sg[(i * E + e) * 32 + lane];
          s1 += dxh;
          s2 += dxh * ((f[e] - mean) * rstd);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean_dxh = s1 * inv_n, mean_dxh_xh = s2 * inv_n;
    T* dxr = dx + r * features;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int a = i * 32 + lane;
      if (a < n_acc) {
        float f[E], d[E];
        IO::unpack(cx[i], f);
        IO::unpack(cd[i], d);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = (f[e] - mean) * rstd;
          const float g = sg[(i * E + e) * 32 + lane];
          f[e] = rstd * (d[e] * g - mean_dxh - xh * mean_dxh_xh);
          ag[i][e] += d[e] * xh;
          ab[i][e] += d[e];
        }
        IO::store(dxr + a * E, f);
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      cx[i] = nx[i];
      cd[i] = nd[i];
    }
  }
  // the CTA's partials: warps add theirs in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int s = (i * E + e) * 32 + lane;
          cg[s] = (w == 0 ? 0.f : cg[s]) + ag[i][e];
          cb[s] = (w == 0 ? 0.f : cb[s]) + ab[i][e];
        }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < features; c += blockDim.x) {
    const int s = slot<E>(c);
    part[static_cast<long long>(blockIdx.x) * features + c] = cg[s];
    part[(static_cast<long long>(parts) + blockIdx.x) * features + c] = cb[s];
  }
}

// ---- general kernels: one CTA a row, any width -----------------------------

// Sums of (a, b) over the CTA; every thread gets them. `red` holds two
// floats a warp plus the broadcast pair.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  constexpr int kW = kGeneralThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    red[warp] = a;
    red[kW + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float ta = lane < kW ? red[lane] : 0.f;
    float tb = lane < kW ? red[kW + lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ta += __shfl_xor_sync(0xffffffffu, ta, o);
      tb += __shfl_xor_sync(0xffffffffu, tb, o);
    }
    if (lane == 0) {
      red[2 * kW] = ta;
      red[2 * kW + 1] = tb;
    }
  }
  __syncthreads();
  const float2 out = make_float2(red[2 * kW], red[2 * kW + 1]);
  __syncthreads();  // `red` is reused by the next reduction
  return out;
}

// E consecutive floats at p, as float4s where E allows (p 16-byte aligned)
template <int E>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = p[e];
  }
}

template <int E>
__device__ __forceinline__ void st_f32(float* p, const float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = v[e];
  }
}

// gamma (or beta) of columns c0 .. c0 + E - 1: from the fp32 copy staged in
// shared memory, or (none staged) read in place by its dtype code
template <int E>
__device__ __forceinline__ void w_of(const float* staged, const void* w,
                                     int c0, int code, float (&v)[E]) {
  if (staged != nullptr) {
    ld_f32<E>(staged + c0, v);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = load_w(w, c0 + e, code);
  }
}

// bytes of dynamic shared memory this launch was given
__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned n;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}

// The general kernels stage gamma and beta (K8: gamma and its dgamma and
// dbeta partials) in shared memory in fp32 when the launch gives them room
// (widths up to kGeneralSmemColumns); K7 gets none on as few rows as CTAs,
// where nothing would be reused.
template <typename T, bool V>
__global__ void __launch_bounds__(kGeneralThreads)
ln_fwd_general(const T* __restrict__ x, const void* __restrict__ gamma,
               const void* __restrict__ beta, int w_dtype, T* __restrict__ y,
               long long rows, int features, float eps) {
  using IO = Io<T, V>;
  constexpr int E = IO::E;
  __shared__ float red[2 * (kGeneralThreads / 32) + 2];
  extern __shared__ __align__(16) float smem[];
  const int n_acc = features / E;
  const float inv_n = 1.f / static_cast<float>(features);
  const bool staged = dynamic_smem_bytes() > 0;
  if (staged) {
    for (int c = threadIdx.x; c < features; c += kGeneralThreads) {
      smem[c] = load_w(gamma, c, w_dtype);
      smem[features + c] = load_w(beta, c, w_dtype);
    }
    __syncthreads();
  }
  const float* sg = staged ? smem : nullptr;
  const float* sb = staged ? smem + features : nullptr;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * features;
    T* yr = y + r * features;
    float sum = 0.f;
#pragma unroll 4
    for (int a = threadIdx.x; a < n_acc; a += kGeneralThreads) {
      float f[E];
      IO::unpack(IO::load(xr + a * E), f);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += f[e];
    }
    const float mean = block_sum2(sum, 0.f, red).x * inv_n;
    float sq = 0.f;
#pragma unroll 4
    for (int a = threadIdx.x; a < n_acc; a += kGeneralThreads) {
      float f[E];
      IO::unpack(IO::load(xr + a * E), f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = f[e] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(block_sum2(sq, 0.f, red).x * inv_n + eps);
#pragma unroll 4
    for (int a = threadIdx.x; a < n_acc; a += kGeneralThreads) {
      float f[E], g[E], b[E];
      IO::unpack(IO::load(xr + a * E), f);
      w_of<E>(sg, gamma, a * E, w_dtype, g);
      w_of<E>(sb, beta, a * E, w_dtype, b);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = (f[e] - mean) * rstd * g[e] + b[e];
      IO::store(yr + a * E, f);
    }
  }
}

template <typename T, bool V>
__global__ void __launch_bounds__(kGeneralThreads)
ln_bwd_general(const T* __restrict__ x, const void* __restrict__ gamma,
               int w_dtype, const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ part, int parts, long long rows,
               int features, float eps) {
  using IO = Io<T, V>;
  constexpr int E = IO::E;
  __shared__ float red[2 * (kGeneralThreads / 32) + 2];
  extern __shared__ __align__(16) float smem[];
  const int n_acc = features / E;
  const float inv_n = 1.f / static_cast<float>(features);
  // this CTA's workspace rows, and where it sums its partials: in shared
  // memory where staged, else in the workspace rows themselves. Each thread
  // owns the columns of its accesses, so no barrier guards the partials.
  float* const out_g = part + static_cast<long long>(blockIdx.x) * features;
  float* const out_b =
      part + (static_cast<long long>(parts) + blockIdx.x) * features;
  const bool staged = dynamic_smem_bytes() > 0;
  float* pg = staged ? smem + features : out_g;
  float* pb = staged ? smem + 2 * features : out_b;
  if (staged)
    for (int c = threadIdx.x; c < features; c += kGeneralThreads)
      smem[c] = load_w(gamma, c, w_dtype);
  const float* sg = staged ? smem : nullptr;
  for (int a = threadIdx.x; a < n_acc; a += kGeneralThreads) {
    float z[E];
#pragma unroll
    for (int e = 0; e < E; ++e) z[e] = 0.f;
    st_f32<E>(pg + a * E, z);
    st_f32<E>(pb + a * E, z);
  }
  __syncthreads();  // gamma staged
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * features;
    const T* dyr = dy + r * features;
    T* dxr = dx + r * features;
    float sum = 0.f;
#pragma unroll 4
    for (int a = threadIdx.x; a < n_acc; a += kGeneralThreads) {
      float f[E];
      IO::unpack(IO::load(xr + a * E), f);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += f[e];
    }
    const float mean = block_sum2(sum, 0.f, red).x * inv_n;
    float sq = 0.f;
#pragma unroll 4
    for (int a = threadIdx.x; a < n_acc; a += kGeneralThreads) {
      float f[E];
      IO::unpack(IO::load(xr + a * E), f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = f[e] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(block_sum2(sq, 0.f, red).x * inv_n + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int a = threadIdx.x; a < n_acc; a += kGeneralThreads) {
      float f[E], d[E], g[E];
      IO::unpack(IO::load(xr + a * E), f);
      IO::unpack(IO::load(dyr + a * E), d);
      w_of<E>(sg, gamma, a * E, w_dtype, g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float dxh = d[e] * g[e];
        s1 += dxh;
        s2 += dxh * ((f[e] - mean) * rstd);
      }
    }
    const float2 s = block_sum2(s1, s2, red);
    const float mean_dxh = s.x * inv_n, mean_dxh_xh = s.y * inv_n;
#pragma unroll 4
    for (int a = threadIdx.x; a < n_acc; a += kGeneralThreads) {
      float f[E], d[E], g[E], ag[E], ab[E];
      IO::unpack(IO::load(xr + a * E), f);
      IO::unpack(IO::load(dyr + a * E), d);
      w_of<E>(sg, gamma, a * E, w_dtype, g);
      // the access's partials are all read before any is written: pg and
      // pb share one buffer, so a write would order the reads after it
      ld_f32<E>(pg + a * E, ag);
      ld_f32<E>(pb + a * E, ab);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (f[e] - mean) * rstd;
        f[e] = rstd * (d[e] * g[e] - mean_dxh - xh * mean_dxh_xh);
        ag[e] += d[e] * xh;
        ab[e] += d[e];
      }
      IO::store(dxr + a * E, f);
      st_f32<E>(pg + a * E, ag);
      st_f32<E>(pb + a * E, ab);
    }
  }
  if (staged) {
    for (int a = threadIdx.x; a < n_acc; a += kGeneralThreads) {
      float v[E];
      ld_f32<E>(pg + a * E, v);
      st_f32<E>(out_g + a * E, v);
      ld_f32<E>(pb + a * E, v);
      st_f32<E>(out_b + a * E, v);
    }
  }
}

// dgamma[c] = sum over parts of the partials, cast to W. A CTA takes 32
// columns; its 32 warps each sum every 32nd part (in part order), then
// warp 0 adds the 32 sums in warp order: a fixed order.
template <typename W>
__global__ void __launch_bounds__(1024)
ln_bwd_reduce(const float* __restrict__ part, int parts, int features,
              W* __restrict__ dgamma, W* __restrict__ dbeta) {
  __shared__ float red[2][32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float sg = 0.f, sb = 0.f;
  if (c < features) {
    for (int p = ty; p < parts; p += 32) {
      sg += part[static_cast<long long>(p) * features + c];
      sb += part[(static_cast<long long>(parts) + p) * features + c];
    }
  }
  red[0][ty][tx] = sg;
  red[1][ty][tx] = sb;
  __syncthreads();
  if (ty == 0 && c < features) {
    float g = 0.f, b = 0.f;
    for (int k = 0; k < 32; ++k) {
      g += red[0][k][tx];
      b += red[1][k][tx];
    }
    dgamma[c] = from_f32<W>(g);
    dbeta[c] = from_f32<W>(b);
  }
}

// ---- plans ------------------------------------------------------------------

struct Plan {
  int kind = kGeneralScalar;
  int accesses = 0;   // accesses a lane holds (row kernels)
  int ctas = 0;       // grid; K8's parts
  int threads = kGeneralThreads;
  size_t smem = 0;    // dynamic shared memory
  const void* fn = nullptr;
};

template <typename T, int NV, bool V>
const void* fwd_rows_fn() { return reinterpret_cast<const void*>(&ln_fwd_rows<T, NV, V>); }
template <typename T, int NV, bool V>
const void* bwd_rows_fn() { return reinterpret_cast<const void*>(&ln_bwd_rows<T, NV, V>); }

// the row kernel for `nv` accesses a lane (one of 1, 2, 3, 4, 6, 8)
template <typename T, bool BWD, bool V>
const void* rows_fn(int nv) {
  switch (nv) {
    case 1: return BWD ? bwd_rows_fn<T, 1, V>() : fwd_rows_fn<T, 1, V>();
    case 2: return BWD ? bwd_rows_fn<T, 2, V>() : fwd_rows_fn<T, 2, V>();
    case 3: return BWD ? bwd_rows_fn<T, 3, V>() : fwd_rows_fn<T, 3, V>();
    case 4: return BWD ? bwd_rows_fn<T, 4, V>() : fwd_rows_fn<T, 4, V>();
    case 6: return BWD ? bwd_rows_fn<T, 6, V>() : fwd_rows_fn<T, 6, V>();
    case 8:
      if constexpr (!BWD) return fwd_rows_fn<T, 8, V>();
      return nullptr;
  }
  return nullptr;
}

int accesses_for(int need, int max_nv) {
  for (int nv : {1, 2, 3, 4, 6, 8})
    if (nv >= need && nv <= max_nv) return nv;
  return 0;
}

// CTAs of `fn` that fit on one SM with `smem` bytes of dynamic shared
// memory (cached: it depends only on these and the card). The first call
// for a kernel also lets it take up to kMaxDynamicSmem.
int ctas_per_sm(const void* fn, int threads, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, size_t>, int> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(fn, smem);
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kMaxDynamicSmem);
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, smem) !=
      cudaSuccess)
    n = 0;
  n = n < 1 ? 1 : n;
  cache.emplace(key, n);
  return n;
}

// streaming multiprocessors of the current device (cached)
int sm_count() {
  constexpr int kMaxDevices = 64;
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (cache[dev] == 0) {
    int n = 1;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n;
  }
  return cache[dev];
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
Plan plan_for(bool bwd, bool aligned, long long rows, int features) {
  constexpr int kVec = 16 / sizeof(T);
  Plan p;
  const bool vec = aligned && features % kVec == 0;
  const int per = vec ? kVec : 1;
  const int need = (features / per + 31) / 32;
  p.accesses = accesses_for(need, bwd ? kBwdMaxAccesses : kFwdMaxAccesses);
  const int sms = sm_count();
  // K7 on a few rows (decode: 8) spreads each row over a CTA of its own
  // SM rather than taking one warp of one SM
  if (!bwd && rows <= sms) p.accesses = 0;
  if (p.accesses > 0) {
    p.kind = vec ? kRowsVector : kRowsScalar;
    p.threads = kRowThreads;
    p.fn = bwd ? (vec ? rows_fn<T, true, true>(p.accesses)
                      : rows_fn<T, true, false>(p.accesses))
               : (vec ? rows_fn<T, false, true>(p.accesses)
                      : rows_fn<T, false, false>(p.accesses));
    p.smem = static_cast<size_t>(p.accesses) * 32 * per * (bwd ? 12 : 8);
    const long long groups = (rows + kWarps - 1) / kWarps;
    const long long most = static_cast<long long>(sms) *
                           ctas_per_sm(p.fn, p.threads, p.smem);
    p.ctas = static_cast<int>(groups < most ? groups : most);
  } else {
    p.kind = vec ? kGeneralVector : kGeneralScalar;
    if (bwd)
      p.fn = vec ? reinterpret_cast<const void*>(&ln_bwd_general<T, true>)
                 : reinterpret_cast<const void*>(&ln_bwd_general<T, false>);
    else
      p.fn = vec ? reinterpret_cast<const void*>(&ln_fwd_general<T, true>)
                 : reinterpret_cast<const void*>(&ln_fwd_general<T, false>);
    // staged columns (ln_fwd_general): none for K7 on as few rows as SMs
    if (features <= kGeneralSmemColumns && (bwd || rows > sms))
      p.smem = static_cast<size_t>(features) * (bwd ? 3 : 2) * sizeof(float);
    int per_sm = ctas_per_sm(p.fn, p.threads, p.smem);
    if (bwd && per_sm > kGeneralBwdCtasPerSm) per_sm = kGeneralBwdCtasPerSm;
    const long long most = static_cast<long long>(sms) * per_sm;
    p.ctas = static_cast<int>(rows < most ? rows : most);
  }
  return p;
}

Plan plan_of(int x_dtype, bool bwd, bool aligned, long long rows,
             int features) {
  switch (x_dtype) {
    case kBFloat16: return plan_for<__nv_bfloat16>(bwd, aligned, rows, features);
    case kFloat16: return plan_for<__half>(bwd, aligned, rows, features);
    default: return plan_for<float>(bwd, aligned, rows, features);
  }
}

bool valid_dtype(int code) { return code == kFloat32 || code == kBFloat16 || code == kFloat16; }

template <typename W>
cudaError_t launch_reduce(const float* part, int parts, int features,
                          void* dgamma, void* dbeta, cudaStream_t s) {
  ln_bwd_reduce<W><<<(features + 31) / 32, 1024, 0, s>>>(
      part, parts, features, static_cast<W*>(dgamma), static_cast<W*>(dbeta));
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptt

// plan[0]: kernel kind (0 row kernel on 16-byte vectors, 1 row kernel on
// single elements, 2 general kernel on vectors, 3 general on elements);
// plan[1]: accesses a lane holds (row kernels; 0 for general); plan[2]: the
// CTAs launched, which for K8 (bwd = 1) are the workspace's parts.
// out is y (K7) or dx (K8); dy is null for K7.
extern "C" int ptt_layer_norm_plan(const void* x, const void* out,
                                   const void* dy, int rows, int features,
                                   int x_dtype, int bwd, int* plan) {
  using namespace ptt;
  if (features <= 0 || rows < 0 || !valid_dtype(x_dtype))
    return cudaErrorInvalidValue;
  const bool aligned = aligned16(x) && aligned16(out) && (!bwd || aligned16(dy));
  const Plan p = plan_of(x_dtype, bwd != 0, aligned, rows, features);
  plan[0] = p.kind;
  plan[1] = p.accesses;
  plan[2] = p.ctas;
  return cudaSuccess;
}

extern "C" int ptt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, int rows,
                                  int features, float eps, int x_dtype,
                                  int w_dtype, void* stream) {
  using namespace ptt;
  if (features <= 0 || rows < 0 || !valid_dtype(x_dtype) || !valid_dtype(w_dtype))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const Plan p = plan_of(x_dtype, false, aligned16(x) && aligned16(y), rows,
                         features);
  long long rows_ll = rows;
  void* args[] = {(void*)&x, (void*)&gamma, (void*)&beta, &w_dtype, &y,
                  &rows_ll, &features, &eps};
  cudaError_t e = cudaLaunchKernel(p.fn, dim3(p.ctas), dim3(p.threads), args,
                                   p.smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// part: fp32 workspace of 2 * parts * features (dgamma, then dbeta
// partials), parts from ptt_layer_norm_plan (any parts >= 1 gives the same
// sums up to their order).
extern "C" int ptt_layer_norm_bwd(const void* x, const void* gamma,
                                  const void* dy, void* dx, void* dgamma,
                                  void* dbeta, void* part, int parts, int rows,
                                  int features, float eps, int x_dtype,
                                  int w_dtype, void* stream) {
  using namespace ptt;
  if (features <= 0 || rows < 0 || !valid_dtype(x_dtype) || !valid_dtype(w_dtype) ||
      (rows > 0 && parts < 1) || parts < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pw = static_cast<float*>(part);
  if (rows == 0) {
    parts = 0;  // no rows: dgamma and dbeta are 0
  } else {
    const Plan p = plan_of(x_dtype, true,
                           aligned16(x) && aligned16(dx) && aligned16(dy),
                           rows, features);
    long long rows_ll = rows;
    void* args[] = {(void*)&x, (void*)&gamma, &w_dtype, (void*)&dy, &dx,
                    &pw, &parts, &rows_ll, &features, &eps};
    cudaError_t e = cudaLaunchKernel(p.fn, dim3(parts), dim3(p.threads), args,
                                     p.smem, s);
    if (e != cudaSuccess) return e;
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  switch (w_dtype) {
    case kBFloat16: return launch_reduce<__nv_bfloat16>(pw, parts, features, dgamma, dbeta, s);
    case kFloat16: return launch_reduce<__half>(pw, parts, features, dgamma, dbeta, s);
    default: return launch_reduce<float>(pw, parts, features, dgamma, dbeta, s);
  }
}
