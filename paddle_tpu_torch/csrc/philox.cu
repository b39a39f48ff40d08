// A test-only launch of the attention dropout generator (csrc/philox.cuh):
// writes the whole keep-mask of one attention call, so that the device
// Philox can be held bit for bit against its plain version
// (paddle_tpu_torch/ops/philox.py::keep_mask). No main path runs it; the
// flash kernels draw the same bits inside their tiles.
#include <cuda_runtime.h>

#include "philox.cuh"

namespace ptt {
namespace {

// one thread a (slice, row, 8-column group); mask is uint8 [b, h, sq, sk]
__global__ void keep_mask_kernel(uint8_t* __restrict__ mask, long long slices, int sq,
                                 int sk, Dropout dp) {
  const int groups = (sk + 7) / 8;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= slices * sq * groups) return;
  const int grp = static_cast<int>(i % groups);
  const int row = static_cast<int>((i / groups) % sq);
  const long long bh = i / (static_cast<long long>(groups) * sq);
  const uint32_t byte = keep_byte(dp, grp, row, static_cast<uint32_t>(bh));
  uint8_t* out = mask + (bh * sq + row) * sk + 8 * grp;
  for (int e = 0; e < 8 && 8 * grp + e < sk; ++e) out[e] = (byte >> e) & 1u;
}

}  // namespace
}  // namespace ptt

extern "C" int ptt_philox_keep_mask(void* mask, int b, int h, int sq, int sk,
                                    unsigned int k0, unsigned int k1, unsigned int thr,
                                    void* stream) {
  using namespace ptt;
  const long long n = static_cast<long long>(b) * h * sq * ((sk + 7) / 8);
  if (n == 0) return cudaSuccess;
  const Dropout dp{k0, k1, thr, 1.f};
  keep_mask_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(mask), static_cast<long long>(b) * h, sq, sk, dp);
  return cudaGetLastError();
}
