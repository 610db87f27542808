// cp.async staging helpers on Hopper (sm_90a), shared by the tile engine
// (pairwise_tile.cuh) and the column walk (column_walk.cuh).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cp_async {

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (VEC) or 4 bytes from `src` into shared memory, zeros when !ok
template <bool VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool ok) {
  if constexpr (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte copies need every row of x and y on a 16-byte boundary
inline bool rows_aligned(const float* x, const float* y, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

}  // namespace cp_async
