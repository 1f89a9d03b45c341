// lane_gather_cm -- cells-minor windowed gather.
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_gather_cm:
//   out[v*C+c, t, k, j] = values[c, starts[t] + idx[t,v,k,j], j]   (0 for idx = -1)
// values (C, R, 128); starts (T,) int32; idx (T, V, K, 128) in [-1, wr);
// out (V*C, T, K, 128).
//
// Bound on this card: bytes. The function must write V*C*T*K*128 values
// and read the index table once; the value windows (C*wr rows per bin)
// are small and re-read from L1/L2. The TPU version loops over the wr
// window rows with a compare-select because that machine cannot index
// memory per lane; here every thread loads its row directly.
//
// Design: thread x = lane column j (coalesced index reads, coalesced
// output writes, and the gathered reads of one warp fall into a few rows
// of one wr-row window); thread y = a cell row k of the bin; one block
// per (bin t, slice of k). Each index is read once and reused for the C
// channels.
#include "lane_common.cuh"

#define GATHER_KY 4

template <typename T, typename I>
__global__ void lane_gather_cm_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ starts,
    const I* __restrict__ idx, T* __restrict__ out,
    int C, int R, int nT, int V, int K, int wr) {
  const int j = threadIdx.x;
  const int t = blockIdx.x;
  const int k = blockIdx.y * GATHER_KY + threadIdx.y;
  if (k >= K) return;
  const long long start = starts[t];
  for (int v = 0; v < V; ++v) {
    const int i = (int)idx[(((long long)t * V + v) * K + k) * LANES + j];
    const bool ok = (i >= 0) && (i < wr);
    for (int c = 0; c < C; ++c) {
      T val = T(0);
      if (ok) val = values[((long long)c * R + start + i) * LANES + j];
      out[((((long long)(v * C + c)) * nT + t) * K + k) * LANES + j] = val;
    }
  }
}

extern "C" int lane_gather_cm(
    int vt, int it, const void* values, const void* starts, const void* idx,
    void* out, int C, int R, int nT, int V, int K, int wr, void* stream) {
  if (nT <= 0 || K <= 0) return 0;
  dim3 block(LANES, GATHER_KY);
  dim3 grid(nT, (K + GATHER_KY - 1) / GATHER_KY);
#define CALL(T, I)                                                        \
  lane_gather_cm_kernel<T, I><<<grid, block, 0, (cudaStream_t)stream>>>(  \
      (const T*)values, (const int32_t*)starts, (const I*)idx, (T*)out,   \
      C, R, nT, V, K, wr)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
