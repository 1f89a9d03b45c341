// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the kernels that stream their inputs through a ring of shared-memory
// stages (lane_pass_update.cu, lane_fused_elem.cu, lattice2d.cuh,
// lattice_matvec3d.cu) or stage a bin's window and tables
// (lane_gather_cm.cu, lane_gather_weighted.cu).
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

#include "lane_common.cuh"

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

// one value of N = 4 or 8 bytes from gmem to smem (through L1): the
// windowed gathers copy each weight their thread will use, and no other
template <int N>
__device__ __forceinline__ void cp_async_ca(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(N)
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

// The windowed gathers' staging (lane_gather_cm.cu, lane_gather_weighted.cu):
// a block of nth threads (tid its thread) copies the LB lane columns from
// j0 of rows [row0, row0 + nrows) of each of the C channels of values
// (C, R, 128) to smem (C, wr, LB), 16 bytes a copy, thread tid taking chunk
// tid % (16-byte chunks a row) of every nth / (chunks a row)-th row
template <typename T, int LB>
__device__ __forceinline__ void stage_window(unsigned char* smem,
                                             const T* values, int C, int R,
                                             long long row0, int nrows,
                                             int wr, int j0, int tid,
                                             int nth) {
  constexpr int CPR = LB * (int)sizeof(T) / 16;
  for (int c = 0; c < C; ++c) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        values + ((long long)c * R + row0) * LANES + j0) + (tid % CPR) * 16;
    unsigned char* dst = smem + (size_t)c * wr * LB * sizeof(T)
                         + (tid % CPR) * 16;
    for (int r = tid / CPR; r < nrows; r += nth / CPR)
      cp_async16(dst + (size_t)r * LB * sizeof(T),
                 src + (size_t)r * LANES * sizeof(T));
  }
}

// ... and the LB lane columns from j0 of the rows rows0 .. rows0 + n - 1 of
// a (..., 128) index table to smem (n, LB)
template <typename I, int LB>
__device__ __forceinline__ void stage_index_rows(unsigned char* smem,
                                                 const I* idx,
                                                 long long rows0, int n,
                                                 int j0, int tid, int nth) {
  constexpr int IPR = LB * (int)sizeof(I) / 16;
  for (int q = tid; q < n * IPR; q += nth)
    cp_async16(smem + (size_t)(q / IPR) * LB * sizeof(I) + (q % IPR) * 16,
               reinterpret_cast<const unsigned char*>(
                   idx + (rows0 + q / IPR) * LANES + j0) + (q % IPR) * 16);
}
