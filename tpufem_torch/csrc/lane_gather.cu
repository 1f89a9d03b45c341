// lane_gather -- windowed per-lane gather, channel-major output.
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_gather:
//   out[t, c, v, k, j] = values[c, starts[t] + idx[t,v,k,j], j]
// or, with sum_v, out[t, c, k, j] = sum over v of the same; idx = -1 (or
// anything outside [0, wr), or a row at or past the end of values) gives
// 0. values (C, R, 128) and idx 16-byte aligned; starts (T,) int32 (>= 0);
// idx (T, V, K, 128) int8/int32.
//
// Bound on this card: bytes (the values' windows and the index table read
// once, the output written once). The TPU version loops a compare-select
// over every window row because that machine cannot index memory per lane.
// The first design gave each lane column a thread that loaded its index
// and then the window value straight from global memory, re-reading the
// index for every channel: chains of dependent loads with few bytes in
// flight, at 2.2-3.4x the bound.
//
// Design: that of lane_gather_cm.cu (K1), with K9's output layouts and edge
// rule. One block per (bin t, slab of G9_LB = 32 lane columns), the slabs of
// a bin neighbouring blocks; threads 32 lanes x ky rows. The block copies
// into shared memory, by 16-byte cp.async, the window rows that exist,
// [starts[t], min(starts[t] + wr, R)) (none for a window that starts at or
// past R: a row past the end gives 0, where K1 clamps it to the last row),
// of its 32 columns for all C channels, and the index rows (v, k) of its
// slab: every load of the block is in flight at once. One wait, one
// barrier; then thread (x, y) writes rows y, y + ky, ... of column x from
// shared memory (window element (c, i, x) at (c * wr + i) * 32 + x, bank x
// whatever the row), each warp store one 128-byte row of the output: per v
// every (c, v), or with sum_v every c, summed over v ascending from zero, as
// the plain version sums (the Pallas body sums window rows ascending with a
// count per row, which agrees to rounding). Values are moved or added in
// the plain version's order: the result is bit-equal to it. Where the
// window and the index rows do not fit a block's shared memory (STAGED
// false), the block reads both straight from global memory instead. ky,
// the path and the shared-memory size come from the wrapper
// (tpufem_torch/lane/kernels.py:gather_geometry); this file checks the
// size against its own layout.
#include "lane_async.cuh"

#define G9_LB 32  // lane columns of a block
#define G9_MAX_THREADS 512

// shared memory: the window (C, wr, 32) and the index tile (V, K, 32), or
// nothing where the block reads global memory
static size_t g9_smem_bytes(int C, int V, int wr, int K, bool staged,
                            size_t vbytes, size_t ibytes) {
  return staged ? (size_t)C * wr * G9_LB * vbytes
                      + (size_t)V * K * G9_LB * ibytes
                : 0;
}

template <typename T, typename I, bool STAGED>
__global__ void __launch_bounds__(G9_MAX_THREADS) lane_gather_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ starts,
    const I* __restrict__ idx, T* __restrict__ out,
    int C, int R, int V, int K, int wr, int sum_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* win = reinterpret_cast<const T*>(smem_raw);
  unsigned char* sidx_raw = smem_raw + (size_t)C * wr * G9_LB * sizeof(T);
  const I* sidx = reinterpret_cast<const I*>(sidx_raw);
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int ky = blockDim.y;
  const int t = blockIdx.x / (LANES / G9_LB);
  const int j0 = blockIdx.x % (LANES / G9_LB) * G9_LB;
  const long long start = starts[t];
  // the window rows that exist: [start, start + nrows), nrows <= wr
  const int nrows = (int)max(0LL, min((long long)wr, (long long)R - start));
  const long long tab = (long long)t * V * K;  // table row (t, 0, 0)

  if constexpr (STAGED) {
    const int tid = y * G9_LB + x;
    const int nth = G9_LB * ky;
    stage_window<T, G9_LB>(smem_raw, values, C, R, start, nrows, wr, j0, tid,
                           nth);
    // the index rows (v, k) of the bin's slab, at tile row v * K + k
    stage_index_rows<I, G9_LB>(sidx_raw, idx, tab, V * K, j0, tid, nth);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // window row of entry (v, k) of column x (-1: it gives 0), and the value
  // of row i of channel c
  auto row = [&](int v, int k) {
    int i;
    if constexpr (STAGED) i = (int)sidx[(v * K + k) * G9_LB + x];
    else i = (int)idx[(tab + (long long)v * K + k) * LANES + j0 + x];
    return i >= 0 && i < nrows ? i : -1;
  };
  auto value = [&](int c, int i) -> T {
    if constexpr (STAGED) return win[((size_t)c * wr + i) * G9_LB + x];
    else return values[((long long)c * R + start + i) * LANES + j0 + x];
  };

  for (int k = y; k < K; k += ky) {
    if (sum_v) {  // out (T, C, K, 128)
      T* o = out + ((long long)t * C * K + k) * LANES + j0 + x;
      for (int c = 0; c < C; ++c) {
        T acc = T(0);
        for (int v = 0; v < V; ++v) {
          const int i = row(v, k);
          if (i >= 0) acc = acc + value(c, i);
        }
        o[(long long)c * K * LANES] = acc;
      }
    } else {  // out (T, C, V, K, 128)
      T* o = out + ((long long)t * C * V * K + k) * LANES + j0 + x;
      for (int v = 0; v < V; ++v) {
        const int i = row(v, k);
        for (int c = 0; c < C; ++c)
          o[((long long)c * V + v) * K * LANES] = i >= 0 ? value(c, i) : T(0);
      }
    }
  }
}

template <typename T, typename I, bool STAGED>
static int launch_g9(const void* values, const void* starts, const void* idx,
                     void* out, int C, int R, int nT, int V, int K, int wr,
                     int sum_v, int ky, size_t smem, cudaStream_t stream) {
  auto kern = lane_gather_kernel<T, I, STAGED>;
  static size_t opted_in = 48 * 1024;  // per instance: no call per launch
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 block(G9_LB, ky);
  dim3 grid(nT * (LANES / G9_LB));
  kern<<<grid, block, smem, stream>>>(
      (const T*)values, (const int32_t*)starts, (const I*)idx, (T*)out, C, R,
      V, K, wr, sum_v);
  return (int)cudaGetLastError();
}

extern "C" int lane_gather(
    int vt, int it, const void* values, const void* starts, const void* idx,
    void* out, int C, int R, int nT, int V, int K, int wr, int sum_v, int ky,
    int staged, long long smem, void* stream) {
  const size_t vbytes = vt == 1 ? 8 : 4;
  if (C < 1 || R < 0 || V < 0 || wr < 0 || ky < 1
      || G9_LB * ky > G9_MAX_THREADS
      || (size_t)smem != g9_smem_bytes(C, V, wr, K, staged != 0, vbytes,
                                       it == 1 ? 4 : 1))
    return (int)cudaErrorInvalidValue;
  if (nT <= 0 || K <= 0) return 0;
#define CALL(T, I)                                                          \
  return staged ? launch_g9<T, I, true>(values, starts, idx, out, C, R, nT, \
                                        V, K, wr, sum_v, ky, (size_t)smem,  \
                                        (cudaStream_t)stream)               \
                : launch_g9<T, I, false>(values, starts, idx, out, C, R,    \
                                         nT, V, K, wr, sum_v, ky,           \
                                         (size_t)smem, (cudaStream_t)stream)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return 0;
}
