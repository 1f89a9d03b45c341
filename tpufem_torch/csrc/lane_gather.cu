// lane_gather -- windowed per-lane gather, channel-major output.
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_gather:
//   out[t, c, v, k, j] = values[c, starts[t] + idx[t,v,k,j], j]
// or, with sum_v, out[t, c, k, j] = sum over v of the same; idx = -1 (or
// anything outside [0, wr), or a row past the end of values) gives 0.
// values (C, R, 128); starts (T,) int32; idx (T, V, K, 128) int8/int32.
//
// Bound on this card: bytes (the index table read once, the output written
// once; the value windows are small and re-read from L1/L2). The TPU
// version loops a compare-select over every window row because that
// machine cannot index memory per lane; here thread x = lane column j reads
// its index (coalesced) and loads the window value directly. One thread
// owns each output, so there are no atomics. With sum_v the sum runs over
// v ascending, the plain version's order, so kernel and plain version are
// bit-equal; the Pallas body sums window rows ascending with a count per
// row, which agrees to rounding.
#include "lane_common.cuh"

#define G9_KY 4

template <typename T, typename I>
__global__ void lane_gather_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ starts,
    const I* __restrict__ idx, T* __restrict__ out,
    int C, int R, int nT, int V, int K, int wr, int sum_v) {
  const int j = threadIdx.x;
  const int t = blockIdx.x;
  const int k = blockIdx.y * G9_KY + threadIdx.y;
  if (k >= K) return;
  const long long start = starts[t];
  for (int c = 0; c < C; ++c) {
    const T* vc = values + (long long)c * R * LANES + j;
    T acc = T(0);
    for (int v = 0; v < V; ++v) {
      const int i = (int)idx[(((long long)t * V + v) * K + k) * LANES + j];
      const bool ok = i >= 0 && i < wr && start + i < R;
      if (sum_v) {
        if (ok) acc = acc + vc[(start + i) * LANES];
      } else {
        out[((((long long)t * C + c) * V + v) * K + k) * LANES + j] =
            ok ? vc[(start + i) * LANES] : T(0);
      }
    }
    if (sum_v) out[(((long long)t * C + c) * K + k) * LANES + j] = acc;
  }
}

extern "C" int lane_gather(
    int vt, int it, const void* values, const void* starts, const void* idx,
    void* out, int C, int R, int nT, int V, int K, int wr, int sum_v,
    void* stream) {
  if (nT <= 0 || K <= 0 || C <= 0) return 0;
  dim3 block(LANES, G9_KY);
  dim3 grid(nT, (K + G9_KY - 1) / G9_KY);
#define CALL(T, I)                                                       \
  lane_gather_kernel<T, I><<<grid, block, 0, (cudaStream_t)stream>>>(    \
      (const T*)values, (const int32_t*)starts, (const I*)idx, (T*)out,  \
      C, R, nT, V, K, wr, sum_v)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
