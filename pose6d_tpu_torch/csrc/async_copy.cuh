// cp.async helpers: copies from device memory to shared memory that run
// while the block computes on a tile it already holds. A copy of `ok =
// false` writes zeros (source size 0); its source address must still be
// a valid one. Used by consistency_rank_major.cu,
// masked_consistency_sum.cu, masked_cdist.cu and both
// flash_cross_attention kernels.
#pragma once

#include <cuda_runtime.h>

namespace async_copy {

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes; both addresses 16-byte aligned. .cg: through L2 only.
__device__ __forceinline__ void copy16(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(smem)),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

// 16 bytes of shared memory from the first `bytes` (0 to 16) bytes at
// gmem, zeros after them; both addresses 16-byte aligned.
__device__ __forceinline__ void copy16n(void* smem, const void* gmem,
                                        int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// 8 bytes of shared memory from the first `bytes` (0 to 8) bytes at gmem,
// zeros after them; both addresses 8-byte aligned.
__device__ __forceinline__ void copy8n(void* smem, const void* gmem,
                                       int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   shared_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// 4 bytes; both addresses 4-byte aligned.
__device__ __forceinline__ void copy4(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_addr(smem)),
               "l"(gmem), "r"(ok ? 4 : 0)
               : "memory");
}

// Closes the group of copies issued since the last commit (possibly none).
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace async_copy
