// lane_gather_weighted -- weighted windowed gather-sum (bilinear
// interpolation between the lane layout and the two-level coarse lattice).
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_gather_weighted:
//   out[t, c, k, j] = sum_v wts[t,v,k,j] * values[c, starts[t] + idx[t,v,k,j], j]
// with idx = -1 (or anything outside [0, wr), or a row at or past R)
// adding nothing. values (C, R, 128) and idx 16-byte aligned; starts (T,)
// int32 (>= 0); idx (T, V, K, 128) int8/int32; wts (T, V, K, 128) of the
// values' type. out is stored channel-leading, (C, T, K, 128): both
// callers (two-level restrict and prolong) want the channel first, and the
// wrapper hands back the (T, C, K, 128) view.
//
// Bound on this card: bytes (index and weight tables read once, the output
// written once; about two operations per table entry). The first design
// gave each lane column a thread that walked v: an index load, then (for a
// valid entry) the weight and the window values, straight from global
// memory -- a chain of dependent loads with few bytes in flight, at 2-3x
// the bound. The gathers' scattered lines were not what held it: the mean
// warp load touches 9-15 lines, which at one line a cycle per SM would
// take 0.022 ms of its 0.074-0.081 (tpufem_torch/perf/lane_gather_bench.py).
//
// Design: one block per (bin t, slab of GW_LB = 32 lane columns), the
// slabs of a bin neighbouring blocks; threads 32 lanes x ky rows, thread
// (x, y) owning rows y, y + ky, ... of column x: one thread for each
// output, no atomics. The block copies the window rows [starts[t],
// starts[t] + wr) below R of its 32 columns, all C channels, into shared
// memory by 16-byte cp.async (rows past R are neither copied nor read);
// window element (c, i, x) lies at (c * wr + i) * 32 + x, in bank x
// whatever the row, so a warp's gather costs one wavefront. The tables
// take one of two paths, as the wrapper decides
// (tpufem_torch/lane/kernels.py:gather_weighted_geometry; this file checks
// the shared-memory size against its own layout):
// - TILES (the prolongation): the index rows of the block's slab are
//   staged beside the window in the same copies; after one wait and one
//   barrier each thread copies the weights of its own entries that add
//   (none for a skipped entry) by 4- or 8-byte cp.async, waits for its own
//   copies (no barrier: it alone reads them) and sums from shared memory.
//   A block then has all its loads in flight in two round trips.
// - registers (the restriction, whose 288-row window and 24 x 16 rows of
//   int32 indices and weights would hold an SM alone): the window alone is
//   staged, three blocks share an SM, and each thread loads GW_VB entries
//   at a time (the index and, where the entry adds, the weight) into
//   registers, the first batch while the window's copies fly.
// The sum runs over v ascending from zero, as in the plain version, and
// the library is built with -fmad=false: the result is bit-equal to the
// plain version.
#include "lane_async.cuh"

#define GW_LB 32    // lane columns of a block
#define GW_MAXC 4   // channels
#define GW_VB 4     // entries in registers at a time (tables not staged)
#define GW_MAX_THREADS 512

static __host__ __device__ inline size_t gw_pad16(size_t n) {
  return (n + 15) / 16 * 16;
}

// shared memory: the window (C, wr, 32) and, where the tables are staged,
// the index tile (V, K, 32) and the weight tile (V, K, 32)
static size_t gw_smem_bytes(int C, int V, int wr, int K, bool tiles,
                            size_t vbytes, size_t ibytes) {
  return (size_t)C * wr * GW_LB * vbytes
         + (tiles ? gw_pad16((size_t)V * K * GW_LB * ibytes)
                        + (size_t)V * K * GW_LB * vbytes
                  : 0);
}

// entries v0 .. v0 + GW_VB - 1 of the output row whose entry v = 0 is at
// e0: the window row (-1 where the entry adds nothing) and, where it adds,
// the weight
template <typename T, typename I>
__device__ __forceinline__ void gw_load(const I* __restrict__ idx,
                                        const T* __restrict__ wts,
                                        long long e0, long long vstride,
                                        int V, int v0, int nrows,
                                        int (&ii)[GW_VB], T (&ww)[GW_VB]) {
#pragma unroll
  for (int u = 0; u < GW_VB; ++u) {
    ii[u] = -1;
    ww[u] = T(0);
    if (v0 + u < V) {
      const long long e = e0 + (v0 + u) * vstride;
      const int i = (int)idx[e];
      if (i >= 0 && i < nrows) {  // i < wr and starts[t] + i < R
        ii[u] = i;
        ww[u] = wts[e];
      }
    }
  }
}

template <typename T, typename I, bool TILES>
__global__ void __launch_bounds__(GW_MAX_THREADS) lane_gather_weighted_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ starts,
    const I* __restrict__ idx, const T* __restrict__ wts, T* __restrict__ out,
    int C, int R, int nT, int V, int K, int wr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* win = reinterpret_cast<const T*>(smem_raw);
  unsigned char* sidx_raw = smem_raw + (size_t)C * wr * GW_LB * sizeof(T);
  const I* sidx = reinterpret_cast<const I*>(sidx_raw);
  T* sw = reinterpret_cast<T*>(
      sidx_raw + gw_pad16((size_t)V * K * GW_LB * sizeof(I)));
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int ky = blockDim.y;
  const int tid = y * GW_LB + x;
  const int nth = GW_LB * ky;
  const int t = blockIdx.x / (LANES / GW_LB);
  const int j0 = blockIdx.x % (LANES / GW_LB) * GW_LB;
  const long long start = starts[t];
  const int nrows = (int)max(0LL, min((long long)wr, (long long)R - start));
  const long long tab = (long long)t * V * K;  // table row (t, 0, 0)
  const long long vstride = (long long)K * LANES;

  stage_window<T, GW_LB>(smem_raw, values, C, R, start, nrows, wr, j0, tid,
                         nth);

  auto store = [&](int k, const T (&acc)[GW_MAXC]) {
    const long long o = ((long long)t * K + k) * LANES + j0 + x;
#pragma unroll
    for (int c = 0; c < GW_MAXC; ++c)
      if (c < C) out[(long long)c * nT * K * LANES + o] = acc[c];
  };

  if constexpr (TILES) {
    // the index rows (v, k) of the bin's slab, at tile row v * K + k
    stage_index_rows<I, GW_LB>(sidx_raw, idx, tab, V * K, j0, tid, nth);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // the weights of this thread's entries that add
    for (int k = y; k < K; k += ky) {
      for (int v = 0; v < V; ++v) {
        const int q = (v * K + k) * GW_LB + x;
        const int i = (int)sidx[q];
        if (i >= 0 && i < nrows)  // i < wr and starts[t] + i < R
          cp_async_ca<sizeof(T)>(sw + q,
                                 wts + (tab + q / GW_LB) * LANES + j0 + x);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    for (int k = y; k < K; k += ky) {
      T acc[GW_MAXC];
#pragma unroll
      for (int c = 0; c < GW_MAXC; ++c) acc[c] = T(0);
      for (int v = 0; v < V; ++v) {
        const int q = (v * K + k) * GW_LB + x;
        const int i = (int)sidx[q];
        if (i >= 0 && i < nrows) {
          const T w = sw[q];
          const T* p = win + i * GW_LB + x;
#pragma unroll
          for (int c = 0; c < GW_MAXC; ++c)
            if (c < C) acc[c] = acc[c] + w * p[(size_t)c * wr * GW_LB];
        }
      }
      store(k, acc);
    }
  } else {
    cp_async_commit();
    // the first entries of the first row while the window's copies fly
    int ii[GW_VB];
    T ww[GW_VB];
    if (y < K)
      gw_load<T, I>(idx, wts, (tab + y) * LANES + j0 + x, vstride, V, 0,
                    nrows, ii, ww);
    cp_async_wait<0>();
    __syncthreads();
    for (int k = y; k < K; k += ky) {
      T acc[GW_MAXC];
#pragma unroll
      for (int c = 0; c < GW_MAXC; ++c) acc[c] = T(0);
      for (int v0 = 0; v0 < V; v0 += GW_VB) {
        if (k != y || v0 != 0)
          gw_load<T, I>(idx, wts, (tab + k) * LANES + j0 + x, vstride, V, v0,
                        nrows, ii, ww);
#pragma unroll
        for (int u = 0; u < GW_VB; ++u) {
          if (ii[u] >= 0) {
            const T* p = win + ii[u] * GW_LB + x;
#pragma unroll
            for (int c = 0; c < GW_MAXC; ++c)
              if (c < C) acc[c] = acc[c] + ww[u] * p[(size_t)c * wr * GW_LB];
          }
        }
      }
      store(k, acc);
    }
  }
}

template <typename T, typename I, bool TILES>
static int launch_gw(const void* values, const void* starts, const void* idx,
                     const void* wts, void* out, int C, int R, int nT, int V,
                     int K, int wr, int ky, size_t smem, cudaStream_t stream) {
  auto kern = lane_gather_weighted_kernel<T, I, TILES>;
  static size_t opted_in = 48 * 1024;  // per instance: no call per launch
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 block(GW_LB, ky);
  dim3 grid(nT * (LANES / GW_LB));
  kern<<<grid, block, smem, stream>>>(
      (const T*)values, (const int32_t*)starts, (const I*)idx, (const T*)wts,
      (T*)out, C, R, nT, V, K, wr);
  return (int)cudaGetLastError();
}

extern "C" int lane_gather_weighted(
    int vt, int it, const void* values, const void* starts, const void* idx,
    const void* wts, void* out, int C, int R, int nT, int V, int K, int wr,
    int ky, int tiles, long long smem, void* stream) {
  const size_t vbytes = vt == 1 ? 8 : 4;
  if (C < 1 || C > GW_MAXC || V < 0 || wr < 0 || ky < 1
      || GW_LB * ky > GW_MAX_THREADS
      || (size_t)smem != gw_smem_bytes(C, V, wr, K, tiles != 0, vbytes,
                                       it == 1 ? 4 : 1))
    return (int)cudaErrorInvalidValue;
  if (nT <= 0 || K <= 0) return 0;
  if (V == 0)  // an empty sum
    return (int)cudaMemsetAsync(out, 0, (size_t)C * nT * K * LANES * vbytes,
                                (cudaStream_t)stream);
#define CALL(T, I)                                                          \
  return tiles ? launch_gw<T, I, true>(values, starts, idx, wts, out, C, R, \
                                       nT, V, K, wr, ky, (size_t)smem,      \
                                       (cudaStream_t)stream)                \
               : launch_gw<T, I, false>(values, starts, idx, wts, out, C,   \
                                        R, nT, V, K, wr, ky, (size_t)smem,  \
                                        (cudaStream_t)stream)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return 0;
}
