// cp.async copies from global to shared memory (sm_80 and later), shared by
// edge_relax_superstep.cu and minplus.cu.  A copy is issued by one thread,
// lands in shared memory without passing through registers, and is waited
// for by groups: commit() closes the group of the copies this thread issued
// since the last commit, wait<N>() returns once at most N of its groups are
// still in flight.  A __syncthreads() after the wait makes every thread's
// copies visible to the block.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes, through L1
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 16 bytes, bypassing L1; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
