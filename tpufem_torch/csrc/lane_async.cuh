// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the kernels that stream their inputs through a ring of shared-memory
// stages (lane_pass_update.cu, lane_fused_elem.cu, lattice2d.cuh,
// lattice_matvec3d.cu).
//
// The lane kernels copy 16 bytes, global cache only (.cg: the data goes to
// shared memory, not to L1). The lattice kernels copy 4 bytes, because
// their rows are 4-byte aligned only; a copy below 16 bytes must take .ca
// (through L1, where the halos of neighbouring tiles meet), and a node
// outside the lattice is zero-filled (src-size 0 reads nothing). A thread
// commits the copies it issued as one group per stage and waits until at
// most N of its groups are pending; a __syncthreads() after the wait makes
// every thread's copies of that stage visible to the whole block.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 4 bytes from gmem to the shared-memory address s (of
// shared_address()), or four zero bytes (reading nothing) when !in
__device__ __forceinline__ void cp_async4_zfill(unsigned s, const void* gmem,
                                                bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 4 : 0)
               : "memory");
}

// the shared-memory address of p, for cp_async4_zfill (taken once, so
// that a copy loop adds byte offsets to it)
__device__ __forceinline__ unsigned shared_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
