// lane_gather_cm -- cells-minor windowed gather.
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_gather_cm:
//   out[v*C+c, t, k, j] = values[c, min(starts[t] + idx[t,v,k,j], R-1), j]
//                         (0 for idx = -1 or idx >= wr)
// values (C, R, 128) and idx 16-byte aligned; starts (T,) int32 (>= 0); idx
// (T, V, K, 128) int8/int32; out (V*C, T, K, 128). A window row past the
// last row reads the last row, as the plain version clamps it.
//
// Bound on this card: bytes. The function must write V*C*T*K*128 values
// (65 % of its bytes at the n = 1024 plan) and read the index table and
// the values once (the bins' windows do not overlap there). The first
// design gave each lane column a thread that loaded its index and then
// its value straight from global memory: two dependent loads with few
// bytes in flight, at 2.2x the bound. (The gathers' scattered lines were
// not what held it: its mean warp load touches 19 lines, which at one line
// a cycle per SM would take 0.028 ms of its 0.051;
// tpufem_torch/perf/lane_gather_bench.py.)
//
// Design: one block per (bin t, slab of GC_LB = 32 lane columns), the
// slabs of a bin neighbouring blocks; threads 32 lanes x ky rows. The
// block copies into shared memory, by 16-byte cp.async, the window rows
// that exist, [min(starts[t], R-1), min(starts[t] + wr, R)), of its 32
// columns for all C channels and the index rows (v, k) of its slab: every
// load of the block is in flight at once. One wait, one barrier; then
// thread (x, y) writes rows y, y + ky, ... of column x for every (v, c)
// from shared memory (window element (c, i, x) at (c * wr + i) * 32 + x,
// bank x whatever the row: a warp's gather costs one wavefront), each warp
// store one 128-byte row of the output. Values are moved, not computed:
// the result is bit-equal to the plain version. Where the window and the
// index rows do not fit a block's shared memory (STAGED false: a 3D plan's
// tall window in float64, e.g. P1 tetrahedra at box(48), 3 channels x 272
// rows and 4 x 184 index rows), the block reads both straight from global
// memory instead, as lane_gather.cu (K9) does; the values moved are the
// same, so that route is bit-equal to the plain version too. ky, the route
// and the shared-memory size come from the wrapper (tpufem_torch/lane/
// kernels.py:gather_cm_geometry); this file checks the size against its
// own layout.
#include "lane_async.cuh"

#define GC_LB 32   // lane columns of a block
#define GC_MAX_THREADS 512

// shared memory: the window (C, wr, 32), the index tile (V, K, 32), or
// nothing where the block reads global memory
static size_t gc_smem_bytes(int C, int V, int wr, int K, bool staged,
                            size_t vbytes, size_t ibytes) {
  return staged ? (size_t)C * wr * GC_LB * vbytes
                      + (size_t)V * K * GC_LB * ibytes
                : 0;
}

template <typename T, typename I, bool STAGED>
__global__ void __launch_bounds__(GC_MAX_THREADS) lane_gather_cm_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ starts,
    const I* __restrict__ idx, T* __restrict__ out,
    int C, int R, int nT, int V, int K, int wr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* win = reinterpret_cast<const T*>(smem_raw);
  unsigned char* sidx_raw = smem_raw + (size_t)C * wr * GC_LB * sizeof(T);
  const I* sidx = reinterpret_cast<const I*>(sidx_raw);
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int ky = blockDim.y;
  const int tid = y * GC_LB + x;
  const int nth = GC_LB * ky;
  const int t = blockIdx.x / (LANES / GC_LB);
  const int j0 = blockIdx.x % (LANES / GC_LB) * GC_LB;
  // staged rows [base, base + nrows): the window's rows below R, or the
  // last row alone for a window that starts at or past it
  const long long start = starts[t];
  const long long base = min(start, (long long)R - 1);
  const int nrows = wr > 0 ? (int)(min(start + wr, (long long)R) - base) : 0;
  const int off = (int)min(start - base, (long long)wr);  // 0 unless start >= R
  const long long tab = (long long)t * V * K;  // table row (t, 0, 0)

  if constexpr (STAGED) {
    stage_window<T, GC_LB>(smem_raw, values, C, R, base, nrows, wr, j0, tid,
                           nth);
    // the index rows (v, k) of the bin's slab, at tile row v * K + k
    stage_index_rows<I, GC_LB>(sidx_raw, idx, tab, V * K, j0, tid, nth);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // dof row v*C+c of output row k: one 128-byte row of a warp
  const long long dstride = (long long)nT * K * LANES;
  for (int k = y; k < K; k += ky) {
    T* o = out + ((long long)t * K + k) * LANES + j0 + x;
    for (int v = 0; v < V; ++v) {
      int i;
      if constexpr (STAGED) i = (int)sidx[(v * K + k) * GC_LB + x];
      else i = (int)idx[(tab + (long long)v * K + k) * LANES + j0 + x];
      const bool ok = i >= 0 && i < wr;
      // staged row min(i + off, nrows - 1), i.e. state row
      // min(start + i, R - 1)
      const int row = ok ? min(i + off, nrows - 1) : 0;
      for (int c = 0; c < C; ++c) {
        T val = T(0);
        if (ok) {
          if constexpr (STAGED) val = win[((size_t)c * wr + row) * GC_LB + x];
          else val = values[((long long)c * R + base + row) * LANES + j0 + x];
        }
        o[((long long)v * C + c) * dstride] = val;
      }
    }
  }
}

template <typename T, typename I, bool STAGED>
static int launch_gc(const void* values, const void* starts, const void* idx,
                     void* out, int C, int R, int nT, int V, int K, int wr,
                     int ky, size_t smem, cudaStream_t stream) {
  auto kern = lane_gather_cm_kernel<T, I, STAGED>;
  static size_t opted_in = 48 * 1024;  // per instance: no call per launch
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 block(GC_LB, ky);
  dim3 grid(nT * (LANES / GC_LB));
  kern<<<grid, block, smem, stream>>>(
      (const T*)values, (const int32_t*)starts, (const I*)idx, (T*)out, C, R,
      nT, V, K, wr);
  return (int)cudaGetLastError();
}

extern "C" int lane_gather_cm(
    int vt, int it, const void* values, const void* starts, const void* idx,
    void* out, int C, int R, int nT, int V, int K, int wr, int ky, int staged,
    long long smem, void* stream) {
  const size_t vbytes = vt == 1 ? 8 : 4;
  if (C < 1 || R < 1 || V < 0 || wr < 0 || ky < 1
      || GC_LB * ky > GC_MAX_THREADS
      || (size_t)smem != gc_smem_bytes(C, V, wr, K, staged != 0, vbytes,
                                       it == 1 ? 4 : 1))
    return (int)cudaErrorInvalidValue;
  if (nT <= 0 || K <= 0 || V == 0) return 0;
#define CALL(T, I)                                                          \
  return staged ? launch_gc<T, I, true>(values, starts, idx, out, C, R, nT, \
                                        V, K, wr, ky, (size_t)smem,         \
                                        (cudaStream_t)stream)               \
                : launch_gc<T, I, false>(values, starts, idx, out, C, R,    \
                                         nT, V, K, wr, ky, (size_t)smem,    \
                                         (cudaStream_t)stream)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return 0;
}
