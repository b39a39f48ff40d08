// LayerNorm over the last axis: forward (kernel K7 of the port) and backward
// (kernel K8).
//
// Replaces: paddle_tpu/ops/pallas/layer_norm.py::_fwd_kernel (K7) and
// ::_bwd_kernel (K8), the custom-vjp pair behind nn/functional/norm.py::
// layer_norm.
//
// Bound on the H100: bytes. Each row is read once and written once (2 bytes
// an element in bf16) and the work per byte is a handful of flops, far below
// the ~295 flops/byte where the tensor cores would become the limit. At the
// serving shapes (8 to 1024 rows of 768) the whole call is 12 KB to 3 MB, so
// at decode it is bound by the launch itself.
//
// Design: one CTA of 256 threads per row. Each thread holds its (at most
// kMaxPerThread) elements in registers, so the row is read from device memory
// exactly once; mean and the centred variance are two fp32 block reductions
// (warp shuffles, then one value per warp through shared memory). gamma and
// beta may be fp32 while x is bf16; the output is in x's dtype. Rows are not
// padded to a block multiple (the 256-row padding of the Pallas version is a
// TPU tiling artefact).
//
// K8 bound on the H100: bytes. x and dy are read once and dx written once
// (GPT-2 124M train step: 24576 rows of 768 in bf16, ~113 MB, ~0.034 ms at
// 3.35 TB/s); the work is ~20 flops an element.
//
// K8 design: a grid-stride loop of `parts` CTAs of 256 threads, one row at a
// time, each thread holding its columns of x, dy and gamma in registers. The
// row statistics are recomputed (two-pass mean and variance, as the
// forward), dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
// with dxhat = dy * gamma. Each thread keeps fp32 partial sums of dy * xhat
// and dy for its columns across the CTA's rows; the partials go to a
// (parts, features) workspace and a second small launch sums them per
// column in a fixed order and casts them to gamma's dtype. So dgamma and
// dbeta are deterministic, where the TPU kernel accumulates them in one
// revisited output block across its sequential grid.
#include "common.cuh"

namespace ptt {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 16;  // features <= 4096

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the CTA; every thread gets the result. `red` holds one float per
// warp plus the broadcast slot.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[kThreads / 32] = t;
  }
  __syncthreads();
  float out = red[kThreads / 32];
  __syncthreads();  // `red` is reused by the next reduction
  return out;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                      const W* __restrict__ beta, T* __restrict__ y,
                      int features, float eps) {
  __shared__ float red[kThreads / 32 + 1];
  const long long row = blockIdx.x;
  const T* xr = x + row * features;
  T* yr = y + row * features;
  float v[kMaxPerThread];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    v[i] = c < features ? to_f32(xr[c]) : 0.f;
    sum += v[i];
  }
  const float inv_n = 1.f / static_cast<float>(features);
  const float mean = block_sum(sum, red) * inv_n;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const float d = c < features ? v[i] - mean : 0.f;
    sq += d * d;
  }
  const float rstd = rsqrtf(block_sum(sq, red) * inv_n + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < features) {
      const float o = (v[i] - mean) * rstd * to_f32(gamma[c]) + to_f32(beta[c]);
      yr[c] = from_f32<T>(o);
    }
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* g, const void* b, void* y,
                   int rows, int features, float eps, cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  layer_norm_fwd_kernel<T, W><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(g),
      static_cast<const W*>(b), static_cast<T*>(y), features, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_w(const void* x, const void* g, const void* b, void* y,
                     int rows, int features, float eps, int w_dtype,
                     cudaStream_t stream) {
  switch (w_dtype) {
    case kFloat32: return launch<T, float>(x, g, b, y, rows, features, eps, stream);
    case kBFloat16: return launch<T, __nv_bfloat16>(x, g, b, y, rows, features, eps, stream);
    case kFloat16: return launch<T, __half>(x, g, b, y, rows, features, eps, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ dgamma_part,
                      float* __restrict__ dbeta_part, int rows, int features,
                      float eps) {
  __shared__ float red[kThreads / 32 + 1];
  float g[kMaxPerThread], dg[kMaxPerThread], dbs[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    g[i] = c < features ? to_f32(gamma[c]) : 0.f;
    dg[i] = dbs[i] = 0.f;
  }
  const float inv_n = 1.f / static_cast<float>(features);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * features;
    const T* dyr = dy + row * features;
    T* dxr = dx + row * features;
    float v[kMaxPerThread], d[kMaxPerThread];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      v[i] = c < features ? to_f32(xr[c]) : 0.f;
      d[i] = c < features ? to_f32(dyr[c]) : 0.f;
      sum += v[i];
    }
    const float mean = block_sum(sum, red) * inv_n;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const float xc = c < features ? v[i] - mean : 0.f;
      sq += xc * xc;
    }
    const float rstd = rsqrtf(block_sum(sq, red) * inv_n + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      v[i] = (v[i] - mean) * rstd;  // xhat (unused columns carry dy = 0)
      const float dxh = d[i] * g[i];
      s1 += dxh;
      s2 += dxh * v[i];
    }
    const float mean_dxh = block_sum(s1, red) * inv_n;
    const float mean_dxh_xh = block_sum(s2, red) * inv_n;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < features) {
        dxr[c] = from_f32<T>(rstd * (d[i] * g[i] - mean_dxh - v[i] * mean_dxh_xh));
        dg[i] += d[i] * v[i];
        dbs[i] += d[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < features) {
      dgamma_part[static_cast<long long>(blockIdx.x) * features + c] = dg[i];
      dbeta_part[static_cast<long long>(blockIdx.x) * features + c] = dbs[i];
    }
  }
}

// dgamma[c] = sum over parts of the partials, in part order; cast to W
template <typename W>
__global__ void layer_norm_bwd_reduce(const float* __restrict__ dgamma_part,
                                      const float* __restrict__ dbeta_part,
                                      int parts, int features,
                                      W* __restrict__ dgamma,
                                      W* __restrict__ dbeta) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= features) return;
  float sg = 0.f, sb = 0.f;
  for (int p = 0; p < parts; ++p) {
    sg += dgamma_part[static_cast<long long>(p) * features + c];
    sb += dbeta_part[static_cast<long long>(p) * features + c];
  }
  dgamma[c] = from_f32<W>(sg);
  dbeta[c] = from_f32<W>(sb);
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* g, const void* dy, void* dx,
                       void* dgamma, void* dbeta, float* part, int parts,
                       int rows, int features, float eps, cudaStream_t stream) {
  float* dbeta_part = part + static_cast<long long>(parts) * features;
  if (rows > 0 && parts > 0) {
    layer_norm_bwd_kernel<T, W><<<parts, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(g),
        static_cast<const T*>(dy), static_cast<T*>(dx), part, dbeta_part, rows,
        features, eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  } else {
    parts = 0;  // no rows: dgamma and dbeta are 0
  }
  layer_norm_bwd_reduce<W><<<(features + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(part, dbeta_part, parts, features,
                                       static_cast<W*>(dgamma),
                                       static_cast<W*>(dbeta));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_w(const void* x, const void* g, const void* dy, void* dx,
                         void* dgamma, void* dbeta, float* part, int parts,
                         int rows, int features, float eps, int w_dtype,
                         cudaStream_t s) {
  switch (w_dtype) {
    case kFloat32: return launch_bwd<T, float>(x, g, dy, dx, dgamma, dbeta, part, parts, rows, features, eps, s);
    case kBFloat16: return launch_bwd<T, __nv_bfloat16>(x, g, dy, dx, dgamma, dbeta, part, parts, rows, features, eps, s);
    case kFloat16: return launch_bwd<T, __half>(x, g, dy, dx, dgamma, dbeta, part, parts, rows, features, eps, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ptt

extern "C" int ptt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, int rows,
                                  int features, float eps, int x_dtype,
                                  int w_dtype, void* stream) {
  using namespace ptt;
  if (features <= 0 || features > kThreads * kMaxPerThread) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32: return launch_w<float>(x, gamma, beta, y, rows, features, eps, w_dtype, s);
    case kBFloat16: return launch_w<__nv_bfloat16>(x, gamma, beta, y, rows, features, eps, w_dtype, s);
    case kFloat16: return launch_w<__half>(x, gamma, beta, y, rows, features, eps, w_dtype, s);
  }
  return cudaErrorInvalidValue;
}

// part: fp32 workspace of 2 * parts * features (dgamma, then dbeta partials)
extern "C" int ptt_layer_norm_bwd(const void* x, const void* gamma,
                                  const void* dy, void* dx, void* dgamma,
                                  void* dbeta, void* part, int parts, int rows,
                                  int features, float eps, int x_dtype,
                                  int w_dtype, void* stream) {
  using namespace ptt;
  if (features <= 0 || features > kThreads * kMaxPerThread) return cudaErrorInvalidValue;
  float* pw = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32: return launch_bwd_w<float>(x, gamma, dy, dx, dgamma, dbeta, pw, parts, rows, features, eps, w_dtype, s);
    case kBFloat16: return launch_bwd_w<__nv_bfloat16>(x, gamma, dy, dx, dgamma, dbeta, pw, parts, rows, features, eps, w_dtype, s);
    case kFloat16: return launch_bwd_w<__half>(x, gamma, dy, dx, dgamma, dbeta, pw, parts, rows, features, eps, w_dtype, s);
  }
  return cudaErrorInvalidValue;
}
