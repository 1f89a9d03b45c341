// lane_scatter_weighted -- weighted multi-destination windowed scatter-add,
// the transpose of lane_gather_weighted (K5).
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_scatter_weighted:
//   out[t, c, kappa, j] += wts[t,d,r,j] * src[c, starts[t] + r, j]
//     for every (d, r) with dest_idx[t,d,r,j] == kappa,  r outer, d inner
// src (C, S, 128) and dest_idx 16-byte aligned; starts (T,) int32 (>= 0)
// source-window row starts; dest_idx, wts (T, D, SK, 128): int8/int32 in
// [-1, k_out) (-1, anything outside, or a source row past S adds nothing)
// and the src's type; out (T, C, k_out, 128).
//
// Bound on this card: bytes (source window, index and weight tables read
// once, output written once; one multiply and one add per table entry).
// The TPU version compares every (d, r) against a k_out-row iota. The first
// design gave a block one (bin, channel) and each lane column a thread that
// walked its entries: an index load, then the weight, then a read-modify-
// write of a (k_out, 128) accumulator in shared memory -- two dependent
// global round trips an entry, and the tables read once per channel. It
// ran at 3.9x the bound.
//
// Design: one block per (bin t, slab of GS_LB = 32 lane columns, channel
// group), the slabs of a bin neighbouring blocks; a channel group is every
// channel unless the accumulator leaves no room (so the tables are read
// once). Threads 32 lanes x ky rows, ky >= 4 for the copies. The block
// walks the window in chunks of rc rows: it copies the chunk's source rows
// that exist, [start + r0, min(start + r0 + rc, S)), of its 32 columns for
// every channel of its group and, where the tables are staged (TILES), the
// index and weight rows (d, r0 .. r0 + rc) of its slab into shared memory
// by 16-byte cp.async, all in flight at once, and zeroes its accumulator
// (cb, k_out, 32) meanwhile; one wait, one barrier. Then the ordered
// scatter: thread row y adds channel y (y + ky, ... where cb > ky; rows
// past cb only copy), and lane x walks every (r, d) entry of its column, r
// outer and d inner, from shared memory (bank x), each product rounded
// before its add (the library is built with -fmad=false). The walk is
// software-pipelined: while entry f is added, entry f + 1's weight, window
// value and accumulator row and entry f + 2's index are read, before entry
// f's sum is stored; where entry f + 1 adds to the row entry f stores, it
// takes that sum instead of the value it read. So an entry waits on one
// shared-memory read issued an entry earlier, not on a chain of them.
// Every output element sees its adds in the plain version's order and
// belongs to one thread: no atomics, and the result is bit-equal to the
// plain version. The lanes of a warp all walk the same entries of their
// own columns, so no lane waits on another's branch. After a last barrier
// every thread writes 128-byte rows of the block's slab.
//
// Each (column, channel) walk is serial, so the blocks an SM holds set the
// pace: the chunk is as tall as keeps the most blocks on an SM (8 blocks
// of 10-row chunks, 27 KB, at the n = 1024 tables in float32; 4 in
// float64). Where a chunk of 8 rows with its tables leaves no room for
// two blocks an SM, the tables are not staged (registers): the window
// chunks alone are, and the walk reads the indices and weights from
// global memory. ky, the group, the chunk and the shared-memory size come
// from the wrapper (tpufem_torch/lane/kernels.py:scatter_weighted_geometry);
// this file checks the size against its own layout. Variants measured on
// the card and dropped (PERF.md): rows q split over thread rows (q = y mod
// ky: nearly every entry ran in every warp); batches of 8 entries
// forwarding between all of them (49 instructions an entry); the weights
// of the entries that add copied in a second round trip; one chunk of 40
// rows (4 blocks an SM); chunks double-buffered.
#include "lane_async.cuh"

#define GS_LB 32  // lane columns of a block
#define GS_MAX_THREADS 512

// shared memory: the accumulator (cb, k_out, 32), the window chunk
// (cb, rc, 32) and, where the tables are staged, the index tile (D, rc, 32)
// and the weight tile (D, rc, 32); each a multiple of 32 bytes, so every
// part starts 16-byte aligned
static size_t gs_smem_bytes(int cb, int k_out, int rc, int D, bool tiles,
                            size_t vbytes, size_t ibytes) {
  return (size_t)cb * (k_out + rc) * GS_LB * vbytes
         + (tiles ? (size_t)D * rc * GS_LB * (ibytes + vbytes) : 0);
}

template <typename T, typename I, bool TILES>
__global__ void __launch_bounds__(GS_MAX_THREADS) lane_scatter_weighted_kernel(
    const T* __restrict__ src, const int32_t* __restrict__ starts,
    const I* __restrict__ dest, const T* __restrict__ wts,
    T* __restrict__ out, int C, int S, int D, int sk, int k_out, int cbmax,
    int rc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  unsigned char* win_raw =
      smem_raw + (size_t)cbmax * k_out * GS_LB * sizeof(T);
  const T* win = reinterpret_cast<const T*>(win_raw);
  unsigned char* sidx_raw = win_raw + (size_t)cbmax * rc * GS_LB * sizeof(T);
  const I* sidx = reinterpret_cast<const I*>(sidx_raw);
  unsigned char* sw_raw = sidx_raw + (size_t)D * rc * GS_LB * sizeof(I);
  const T* sw = reinterpret_cast<const T*>(sw_raw);
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int ky = blockDim.y;
  const int tid = y * GS_LB + x;
  const int nth = GS_LB * ky;
  const int t = blockIdx.x / (LANES / GS_LB);
  const int j0 = blockIdx.x % (LANES / GS_LB) * GS_LB;
  const int c0 = blockIdx.y * cbmax;
  const int cb = min(cbmax, C - c0);
  const long long start = starts[t];
  const long long tab = (long long)t * D * sk;  // table row (t, 0, 0)
  const T* srcg = src + (long long)c0 * S * LANES;
  // accumulator element (c, q) of column x, and window element (c, r)
  auto acc_at = [&](int c, int q) -> T& {
    return acc[((size_t)c * k_out + q) * GS_LB + x];
  };
  auto win_at = [&](int c, int r) -> T {
    return win[((size_t)c * rc + r) * GS_LB + x];
  };

  // chunk 0 runs also where sk = 0: it zeroes the accumulator
  for (int r0 = 0; r0 == 0 || r0 < sk; r0 += rc) {
    const int n = min(rc, sk - r0);  // table rows of this chunk
    // ... of which those whose source row lies below S
    const int nrows =
        (int)max(0LL, min((long long)n, (long long)S - start - r0));
    if (r0 > 0) __syncthreads();  // every thread is done with the last chunk
    stage_window<T, GS_LB>(win_raw, srcg, cb, S, start + r0, nrows, rc, j0,
                           tid, nth);
    if constexpr (TILES) {
      // index and weight rows (d, r0 .. r0 + n) of the slab, at tile row
      // d * rc + r
      for (int d = 0; d < D; ++d) {
        const long long row0 = tab + (long long)d * sk + r0;
        stage_index_rows<I, GS_LB>(
            sidx_raw + (size_t)d * rc * GS_LB * sizeof(I), dest, row0, n,
            j0, tid, nth);
        stage_index_rows<T, GS_LB>(
            sw_raw + (size_t)d * rc * GS_LB * sizeof(T), wts, row0, n, j0,
            tid, nth);
      }
    }
    cp_async_commit();
    if (r0 == 0)  // the accumulator, while the copies fly
      for (int i = tid; i < cb * k_out * GS_LB; i += nth) acc[i] = T(0);
    cp_async_wait<0>();
    __syncthreads();
    // the ordered scatter of channel c, entries f = r * D + d: the output
    // row of entry (r, d) (-1: it adds nothing), its weight, the next entry
    const int ne = nrows * D;
    auto row = [&](int r, int d) -> int {
      int q = -1;
      if (r < nrows && d < D) {
        if constexpr (TILES)
          q = (int)sidx[(d * rc + r) * GS_LB + x];
        else
          q = (int)dest[(tab + (long long)d * sk + r0 + r) * LANES + j0 + x];
      }
      return (unsigned)q < (unsigned)k_out ? q : -1;
    };
    auto weight = [&](int r, int d) -> T {
      if constexpr (TILES) return sw[(d * rc + r) * GS_LB + x];
      else return wts[(tab + (long long)d * sk + r0 + r) * LANES + j0 + x];
    };
    for (int c = y; c < cb; c += ky) {
      // entry f: its row q, weight w, window value v and accumulator row a;
      // entry f + 1: its position (r1, d1) and row q1
      int q = row(0, 0);
      T w = T(0), v = T(0), a = T(0);
      if (q >= 0) w = weight(0, 0), v = win_at(c, 0), a = acc_at(c, q);
      int r1 = D > 1 ? 0 : 1, d1 = D > 1 ? 1 : 0;
      int q1 = row(r1, d1);
      int qp = -1;  // the row entry f - 1 stored (-1: none) ...
      T sp = T(0);  // ... and its sum
      for (int f = 0; f < ne; ++f) {
        T w1 = T(0), v1 = T(0), a1 = T(0);
        if (q1 >= 0)  // read before entry f's store
          w1 = weight(r1, d1), v1 = win_at(c, r1), a1 = acc_at(c, q1);
        int r2 = r1, d2 = d1 + 1;
        if (d2 == D) d2 = 0, ++r2;
        const int q2 = row(r2, d2);
        if (q >= 0) {
          sp = (q == qp ? sp : a) + w * v;
          acc_at(c, q) = sp;
        }
        qp = q;
        q = q1, w = w1, v = v1, a = a1;
        q1 = q2, r1 = r2, d1 = d2;
      }
    }
  }
  __syncthreads();  // the sums are complete
  // the block's (cb, k_out, 32) slab, 128-byte rows (256 for float64)
  for (int i = y; i < cb * k_out; i += ky) {
    const int c = i / k_out, q = i - c * k_out;
    out[(((long long)t * C + c0 + c) * k_out + q) * LANES + j0 + x] =
        acc_at(c, q);
  }
}

template <typename T, typename I, bool TILES>
static int launch_gs(const void* src, const void* starts, const void* dest,
                     const void* wts, void* out, int C, int S, int nT, int D,
                     int sk, int k_out, int ky, int cb, int rc, size_t smem,
                     cudaStream_t stream) {
  auto kern = lane_scatter_weighted_kernel<T, I, TILES>;
  static size_t opted_in = 48 * 1024;  // per instance: no call per launch
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 block(GS_LB, ky);
  dim3 grid(nT * (LANES / GS_LB), (C + cb - 1) / cb);
  kern<<<grid, block, smem, stream>>>(
      (const T*)src, (const int32_t*)starts, (const I*)dest, (const T*)wts,
      (T*)out, C, S, D, sk, k_out, cb, rc);
  return (int)cudaGetLastError();
}

extern "C" int lane_scatter_weighted(
    int vt, int it, const void* src, const void* starts, const void* dest,
    const void* wts, void* out, int C, int S, int nT, int D, int sk,
    int k_out, int ky, int cb, int rc, int tiles, long long smem,
    void* stream) {
  const size_t vbytes = vt == 1 ? 8 : 4;
  if (C < 1 || D < 0 || sk < 0 || k_out < 0 || ky < 1
      || GS_LB * ky > GS_MAX_THREADS || cb < 1 || cb > C || rc < 1
      || (size_t)smem != gs_smem_bytes(cb, k_out, rc, D, tiles != 0, vbytes,
                                       it == 1 ? 4 : 1))
    return (int)cudaErrorInvalidValue;
  if (nT <= 0 || k_out == 0) return 0;
#define CALL(T, I)                                                          \
  return tiles ? launch_gs<T, I, true>(src, starts, dest, wts, out, C, S,   \
                                       nT, D, sk, k_out, ky, cb, rc,        \
                                       (size_t)smem, (cudaStream_t)stream)  \
               : launch_gs<T, I, false>(src, starts, dest, wts, out, C, S,  \
                                        nT, D, sk, k_out, ky, cb, rc,       \
                                        (size_t)smem, (cudaStream_t)stream)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return 0;
}
