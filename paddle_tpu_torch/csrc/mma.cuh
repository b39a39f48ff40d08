// Tensor-core and asynchronous-copy primitives shared by the kernels that use
// them: flash cross-entropy K9-K11 (fused_ce.cu) and the bf16/fp16 flash
// attention kernels K1-K3 (flash_attention*.cu).
//  * copy_rows: rows of a row-major operand into shared memory with 16-byte
//    cp.async (or, for a view that is not 16-byte aligned, plain loads),
//    rows past the operand's end zero-filled;
//  * ldm_x4 / ldm_x4_trans: four 8 x 8 b16 matrices from shared memory into
//    mma fragments (ldmatrix), as stored or transposed;
//  * mma_bf16 / mma_f16: c (16 x 8 fp32) += a (16 x 16) . b (16 x 8)
//    (mma.sync m16n8k16, fp32 accumulate), and pack2 to build an A fragment
//    from fp32 values rounded to the operand type.
// Fragment layout of m16n8k16 (thread lane = 4 g + t): A regs a0 (row g,
// k 2t..2t+1), a1 (row g+8, k 2t), a2 (row g, k 2t+8), a3 (row g+8, k 2t+8);
// B regs b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g); C c0, c1 (row g, cols
// 2t, 2t+1), c2, c3 (row g+8). The C fragments of two neighbouring n8 tiles
// are therefore the A fragment of one k16 slice.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ptt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one 16-byte cp.async into shared memory; zero-filled when !fill (src must
// still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [row0, row0 + rows) of src (row stride src_stride elements,
// row_elems elements a row, row_elems * sizeof(T) a multiple of 16) into dst
// (row stride dst_stride); rows >= nrows are zero-filled. The CTA's
// `threads` threads take the rows' 16-byte pieces in order, neighbouring
// threads neighbouring pieces (so a row narrower than a warp leaves no lane
// idle): with cp.async when `async`, else (a source that is not 16-byte
// aligned, or rows of `cols` < row_elems elements whose other columns are
// zero-filled and not read) element by element with plain loads.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dst_stride, const T* src,
                                          long long src_stride, int row0, int rows,
                                          int nrows, int row_elems, int threads,
                                          bool async = true, int cols = 1 << 30) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const int pieces = row_elems / kPer;
  const int step_r = threads / pieces, step_c = threads % pieces;
  int r = threadIdx.x / pieces, c = threadIdx.x % pieces;
  while (r < rows) {
    const bool ok = row0 + r < nrows;
    const T* g = src + static_cast<long long>(ok ? row0 + r : 0) * src_stride + c * kPer;
    T* s = dst + r * dst_stride + c * kPer;
    if (async) {
      cp_async16(s, g, ok);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        s[e] = ok && c * kPer + e < cols ? g[e] : from_f32<T>(0.f);
    }
    r += step_r;
    c += step_c;
    if (c >= pieces) {
      c -= pieces;
      ++r;
    }
  }
}

__device__ __forceinline__ void ldm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// c (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c (16x8 fp32) += a (16x16 fp16, row) . b (16x8 fp16, col)
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_bf16 or mma_f16 by operand type
template <typename T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float* c, const uint32_t* a,
                                                        uint32_t b0, uint32_t b1) {
  mma_bf16(c, a, b0, b1);
}
template <>
__device__ __forceinline__ void mma16816<__half>(float* c, const uint32_t* a,
                                                 uint32_t b0, uint32_t b1) {
  mma_f16(c, a, b0, b1);
}

// two fp32 values rounded to the operand type, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace ptt
