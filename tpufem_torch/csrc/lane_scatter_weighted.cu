// lane_scatter_weighted -- weighted multi-destination windowed scatter-add,
// the transpose of lane_gather_weighted (K5).
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_scatter_weighted:
//   out[t, c, kappa, j] += wts[t,d,r,j] * src[c, starts[t] + r, j]
//     for every (d, r) with dest_idx[t,d,r,j] == kappa,  r outer, d inner
// src (C, S, 128); starts (T,) int32 source-window row starts; dest_idx,
// wts (T, D, SK, 128): int8/int32 in [-1, k_out) (-1, anything outside, or
// a source row past S adds nothing) and the src's type; out
// (T, C, k_out, 128).
//
// Bound on this card: bytes (source window, index and weight tables read
// once, output written once; one multiply and one add per table entry).
// The TPU version compares every (d, r) against a k_out-row iota; here
// thread j owns column j of a (k_out, 128) accumulator in shared memory
// (conflict-free: bank j mod 32) and adds its products serially in the
// Pallas order, r outer and d inner, each product rounded before the add
// (the library is built with -fmad=false). So the sum is deterministic,
// needs no atomics and is bit-equal to the plain version. A -1 entry loads
// no weight. One block per (bin t, channel c); the tables are read once
// per channel.
#include "lane_common.cuh"

template <typename T, typename I>
__global__ void lane_scatter_weighted_kernel(
    const T* __restrict__ src, const int32_t* __restrict__ starts,
    const I* __restrict__ dest, const T* __restrict__ wts,
    T* __restrict__ out, int C, int S, int D, int sk, int k_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // (k_out, LANES)
  const int j = threadIdx.x;
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  for (int q = 0; q < k_out; ++q) acc[q * LANES + j] = T(0);
  const long long start = starts[t];
  const long long tab = (long long)t * D * sk * LANES + j;  // (t, 0, 0, j)
  const T* sp = src + ((long long)c * S + start) * LANES + j;
  const long long left = (long long)S - start;  // rows of src from start on
  const int rows = left < 0 ? 0 : (left < sk ? (int)left : sk);
  for (int r = 0; r < rows; ++r) {
    const T val = sp[(long long)r * LANES];
    for (int d = 0; d < D; ++d) {
      const long long e = tab + ((long long)d * sk + r) * LANES;
      const int q = (int)dest[e];
      if (q >= 0 && q < k_out) acc[q * LANES + j] += wts[e] * val;
    }
  }
  T* op = out + (((long long)t * gridDim.y + c) * k_out) * LANES + j;
  for (int q = 0; q < k_out; ++q) op[(long long)q * LANES] = acc[q * LANES + j];
}

template <typename T, typename I>
static int launch_scatter_weighted(const void* src, const void* starts,
                                   const void* dest, const void* wts,
                                   void* out, int C, int S, int nT, int D,
                                   int sk, int k_out, cudaStream_t stream) {
  const size_t smem = (size_t)k_out * LANES * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lane_scatter_weighted_kernel<T, I>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nT, C);
  lane_scatter_weighted_kernel<T, I><<<grid, LANES, smem, stream>>>(
      (const T*)src, (const int32_t*)starts, (const I*)dest, (const T*)wts,
      (T*)out, C, S, D, sk, k_out);
  return (int)cudaGetLastError();
}

extern "C" int lane_scatter_weighted(
    int vt, int it, const void* src, const void* starts, const void* dest,
    const void* wts, void* out, int C, int S, int nT, int D, int sk,
    int k_out, void* stream) {
  if (nT <= 0 || C <= 0 || k_out <= 0) return 0;
#define CALL(T, I)                                                        \
  return launch_scatter_weighted<T, I>(src, starts, dest, wts, out, C, S,  \
                                       nT, D, sk, k_out,                   \
                                       (cudaStream_t)stream)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return (int)cudaErrorInvalidValue;
}
