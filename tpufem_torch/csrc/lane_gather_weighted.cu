// lane_gather_weighted -- weighted windowed gather-sum (bilinear
// interpolation between the lane layout and the two-level coarse lattice).
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_gather_weighted:
//   out[t, c, k, j] = sum_v wts[t,v,k,j] * values[c, starts[t] + idx[t,v,k,j], j]
// with idx = -1 (or anything outside [0, wr)) adding nothing. values
// (C, R, 128); starts (T,) int32; idx (T, V, K, 128) int8/int32; wts
// (T, V, K, 128) of the values' type. out is stored channel-leading,
// (C, T, K, 128): both callers (two-level restrict and prolong) want the
// channel first, and the wrapper hands back the (T, C, K, 128) view.
//
// Bound on this card: bytes (index and weight tables read once, the output
// written once; about two operations per table entry). The TPU version
// loops a compare-select over every window row because that machine cannot
// gather per lane; here thread x = lane column j reads its index
// (coalesced), skips the entry when it is -1 (most of the restriction
// table is padding: the weight is then not loaded either), and loads the
// window value directly. One thread owns each output, so there are no
// atomics; the sum runs over v ascending, as in the plain version, which
// makes the result bit-equal to it (the library is built with -fmad=false).
#include "lane_common.cuh"

#define GW_KY 4
#define GW_MAXC 4

template <typename T, typename I>
__global__ void lane_gather_weighted_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ starts,
    const I* __restrict__ idx, const T* __restrict__ wts, T* __restrict__ out,
    int C, int R, int nT, int V, int K, int wr) {
  const int j = threadIdx.x;
  const int t = blockIdx.x;
  const int k = blockIdx.y * GW_KY + threadIdx.y;
  if (k >= K) return;
  const long long start = starts[t];
  T acc[GW_MAXC];
#pragma unroll
  for (int c = 0; c < GW_MAXC; ++c) acc[c] = T(0);
  for (int v = 0; v < V; ++v) {
    const long long e = (((long long)t * V + v) * K + k) * LANES + j;
    const int i = (int)idx[e];
    if (i < 0 || i >= wr || start + i >= R) continue;
    const T w = wts[e];
#pragma unroll
    for (int c = 0; c < GW_MAXC; ++c) {
      if (c < C) acc[c] = acc[c] + w * values[((long long)c * R + start + i) * LANES + j];
    }
  }
#pragma unroll
  for (int c = 0; c < GW_MAXC; ++c) {
    if (c < C) out[(((long long)c * nT + t) * K + k) * LANES + j] = acc[c];
  }
}

extern "C" int lane_gather_weighted(
    int vt, int it, const void* values, const void* starts, const void* idx,
    const void* wts, void* out, int C, int R, int nT, int V, int K, int wr,
    void* stream) {
  if (C < 1 || C > GW_MAXC) return (int)cudaErrorInvalidValue;
  if (nT <= 0 || K <= 0) return 0;
  dim3 block(LANES, GW_KY);
  dim3 grid(nT, (K + GW_KY - 1) / GW_KY);
#define CALL(T, I)                                                          \
  lane_gather_weighted_kernel<T, I><<<grid, block, 0, (cudaStream_t)stream>>>( \
      (const T*)values, (const int32_t*)starts, (const I*)idx,              \
      (const T*)wts, (T*)out, C, R, nT, V, K, wr)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
