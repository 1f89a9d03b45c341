// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the kernels that stream their inputs through a ring of shared-memory
// stages (lane_pass_update.cu, lane_fused_elem.cu).
//
// Every copy is 16 bytes, global cache only (.cg: the data goes to shared
// memory, not to L1). A thread commits the copies it issued as one group
// per stage and waits until at most N of its groups are pending; a
// __syncthreads() after the wait makes every thread's copies of that stage
// visible to the whole block.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
