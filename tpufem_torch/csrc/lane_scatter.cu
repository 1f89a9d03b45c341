// lane_scatter -- windowed per-lane scatter-add (the transpose of
// lane_gather without the v axis).
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_scatter:
//   out[t, c, kappa, j] = sum over r with dest_idx[t,r,j] == kappa of
//                         src[c, starts[t] + r, j],   r ascending
// src (C, S, 128); starts (T,) int32 source-window row starts; dest_idx
// (T, SK, 128) int8/int32 in [-1, k_out) (-1, anything outside, or a
// source row past S adds nothing); out (T, C, k_out, 128).
//
// Bound on this card: bytes (the source window and the index table read
// once, the output written once; one add per source value). The TPU
// version compares every source row against a k_out-row iota; here the
// 128 lane columns never mix, so thread j owns column j of a (k_out, 128)
// accumulator in shared memory (address kappa*128 + j: bank j mod 32,
// conflict-free) and adds its rows serially, r ascending -- the Pallas
// order -- so the sum is deterministic, needs no atomics and is bit-equal
// to the plain version. One block per (bin t, channel c); the index table
// is read once per channel.
#include "lane_common.cuh"

template <typename T, typename I>
__global__ void lane_scatter_kernel(
    const T* __restrict__ src, const int32_t* __restrict__ starts,
    const I* __restrict__ dest, T* __restrict__ out, int C, int S, int sk,
    int k_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // (k_out, LANES)
  const int j = threadIdx.x;
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  for (int q = 0; q < k_out; ++q) acc[q * LANES + j] = T(0);
  const long long start = starts[t];
  const I* dp = dest + (long long)t * sk * LANES + j;
  const T* sp = src + ((long long)c * S + start) * LANES + j;
  const long long left = (long long)S - start;  // rows of src from start on
  const int rows = left < 0 ? 0 : (left < sk ? (int)left : sk);
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const int q = (int)dp[(long long)r * LANES];
    const T val = sp[(long long)r * LANES];
    if (q >= 0 && q < k_out) acc[q * LANES + j] += val;
  }
  T* op = out + (((long long)t * gridDim.y + c) * k_out) * LANES + j;
  for (int q = 0; q < k_out; ++q) op[(long long)q * LANES] = acc[q * LANES + j];
}

template <typename T, typename I>
static int launch_scatter(const void* src, const void* starts,
                          const void* dest, void* out, int C, int S, int nT,
                          int sk, int k_out, cudaStream_t stream) {
  const size_t smem = (size_t)k_out * LANES * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lane_scatter_kernel<T, I>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nT, C);
  lane_scatter_kernel<T, I><<<grid, LANES, smem, stream>>>(
      (const T*)src, (const int32_t*)starts, (const I*)dest, (T*)out, C, S,
      sk, k_out);
  return (int)cudaGetLastError();
}

extern "C" int lane_scatter(
    int vt, int it, const void* src, const void* starts, const void* dest,
    void* out, int C, int S, int nT, int sk, int k_out, void* stream) {
  if (nT <= 0 || C <= 0 || k_out <= 0) return 0;
#define CALL(T, I)                                                       \
  return launch_scatter<T, I>(src, starts, dest, out, C, S, nT, sk, k_out, \
                              (cudaStream_t)stream)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return (int)cudaErrorInvalidValue;
}
