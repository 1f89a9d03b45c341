// lane_scatter_cm -- cells-minor bin scatter (element vectors -> bin partials).
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_scatter_cm:
//   out[c, t, r, j] = sum over (v, k) with idx[t,v,k,j] == r of src[v*C+c, t, k, j]
// src (V*C, T, K, 128); idx (T, V, K, 128) in [-1, k_out) -- the SAME table
// the gather uses; out (C, T, k_out, 128).
//
// Bound on this card: bytes (src read once, index table read, out written
// once); the arithmetic is one add per source value.
//
// Design: the 128 lane columns never mix, so thread j owns column j of a
// (k_out, 128) accumulator in shared memory (address r*128 + j: bank
// j mod 32, conflict-free) and adds its (v, k) contributions serially in
// the fixed order v-outer, k-inner -- the order of the TPU kernel's
// unrolled loops -- so the sum is deterministic, needs no atomics and is
// bit-equal to the plain version. One block per (bin t, channel c) keeps
// that order while doubling (bs = 2) the blocks in flight; the index table
// is read once per channel. The loads of a few k ahead are independent of
// the running sum and are issued together (unroll) to hide their latency.
#include "lane_common.cuh"

template <typename T, typename I>
__global__ void lane_scatter_cm_kernel(
    const T* __restrict__ src, const I* __restrict__ idx,
    T* __restrict__ out, int C, int nT, int V, int K, int k_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // (k_out, LANES)
  const int j = threadIdx.x;
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  for (int r = 0; r < k_out; ++r) acc[r * LANES + j] = T(0);
  for (int v = 0; v < V; ++v) {
    const I* ip = idx + (((long long)t * V + v) * K) * LANES + j;
    const T* sp = src + ((((long long)(v * C + c)) * nT + t) * K) * LANES + j;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int i = (int)ip[(long long)k * LANES];
      const T val = sp[(long long)k * LANES];
      if (i >= 0 && i < k_out) acc[i * LANES + j] += val;
    }
  }
  T* op = out + (((long long)c * nT + t) * k_out) * LANES + j;
  for (int r = 0; r < k_out; ++r) op[(long long)r * LANES] = acc[r * LANES + j];
}

template <typename T, typename I>
static int launch_scatter(const void* src, const void* idx, void* out, int C,
                          int nT, int V, int K, int k_out,
                          cudaStream_t stream) {
  const size_t smem = (size_t)k_out * LANES * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lane_scatter_cm_kernel<T, I>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nT, C);
  lane_scatter_cm_kernel<T, I><<<grid, LANES, smem, stream>>>(
      (const T*)src, (const I*)idx, (T*)out, C, nT, V, K, k_out);
  return (int)cudaGetLastError();
}

extern "C" int lane_scatter_cm(
    int vt, int it, const void* src, const void* idx, void* out,
    int C, int nT, int V, int K, int k_out, void* stream) {
  if (nT <= 0 || C <= 0) return 0;
#define CALL(T, I)                                                     \
  return launch_scatter<T, I>(src, idx, out, C, nT, V, K, k_out,       \
                              (cudaStream_t)stream)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return (int)cudaErrorInvalidValue;
}
