// lane_scatter_cm -- cells-minor bin scatter (element vectors -> bin partials).
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_scatter_cm:
//   out[c, t, r, j] = sum over (v, k) with idx[t,v,k,j] == r of src[v*C+c, t, k, j]
// src (V*C, T, K, 128); idx (T, V, K, 128) in [-1, k_out) -- the SAME table
// the gather uses; out (C, T, k_out, 128). The sources of a row are added
// one by one to a zero in (v, k) order, v outer and k inner, as the plain
// version adds them: the result is bit-equal to it, with no atomics.
//
// The kernel does not read idx. It walks its inverse, built once per plan
// on the host (tpufem_torch/lane/kernels.py:scatter_cm_table): for each bin
// t and lane column j, the slots e = v*K + k of the real entries sorted by
// destination row (a stable sort: ties keep ascending e, the plain
// version's order), slots (T, E, 128), and CSR offsets off (T, k_out+1,
// 128) into them; both int8 where V*K <= 127, else int16.
//
// Bound on this card: bytes. The rows of the kernel's table compare with
// the contract's src + idx + out (the Q2-hex box(40) plan: 92.6 MB, 0.0277
// ms at 3.35 TB/s; the n = 1024 polycrystal plan: 77.9 MB, 0.0233 ms); the
// table is this design's own and is read instead of idx (the Q2-hex plan:
// 13.1 MB of int16 against 14.4 MB of int32 idx; the polycrystal plan:
// 9.0 MB of int8 against 6.3 MB). Where padding is skipped the function
// needs less: the src of the real entries + the table + out
// (tpufem_torch/perf/scatter_cm_bench.py:real_entry_bytes) is 69.0 MB,
// 0.0206 ms, at Q2, where 52 % of the entries are padding, and 80.4 MB on
// the polycrystal plan (0.4 % padding, a table larger than idx).
//
// What held the first design (one thread per lane column, a (k_out, 128)
// accumulator in shared memory, every (v, k) walked in turn) back: 128
// threads a block for each (bin, channel), so T * C * 128 threads in all
// (50 000 on the Q2-hex and the generic r = 7 plans); k_out * 128 values
// of shared memory a block (90 KB at Q2 in float32, 180 KB in float64), so
// one or two blocks an SM; and a serial walk over every entry, padding
// included (54 % of the Q2 plan's entries), then k_out rows written, half
// of them zero at Q2. The Q2 plan's K2 took 0.152 ms, 2.9x index_add_.
//
// This design: one thread per (bin t, output row r, lane column j), all
// channels of a block in registers. The thread reads its two offsets and
// adds its few sources (at most 6 at Q2 box(40), 24 on the P1-tet box(48)
// plan; none for an empty row, which writes zeros); T * k_out * 128
// threads (2.9 M at Q2), no accumulator in shared memory, no walk over
// padding, the writes coalesced across j. A block covers one bin, one
// 32-lane slab and all its rows. Neighbouring lanes read
// different (v, k) rows of src, one 32-byte sector a lane. So where the
// slab's src tile (V * CB * K * 32 values: 83 KB at Q2 in float32, 24 KB on
// the polycrystal plan) fits a block (``staged``, the geometry's choice:
// tpufem_torch/lane/kernels.py:scatter_cm_geometry), the block first
// copies it into shared memory by coalesced 16-byte cp.async, and the walk
// reads shared memory at bank = lane: no conflict whatever (v, k) a lane
// reads. Elsewhere (the P1-tet plan's tile of 282 KB) the walk reads src
// through L1 (__ldg). Measured (perf/scatter_cm_bench.py on an H100, event
// medians, float32): Q2 box(40) 0.044 ms staged, 0.058 through L1, 0.149
// the first design; the polycrystal plan 0.0475 staged, 0.054 through L1,
// 0.048 the first design. Channel blocks (grid y) of CB = C channels (C <=
// 3) or of a divisor of C take any channel count. An int8 table has V*K <=
// 127, so its tile (97 536 bytes at most) always fits a block: only the
// int16 tables have the L1 route.
#include "lane_async.cuh"
#include "lane_common.cuh"

#define SC_SLAB 32  // lane columns of a block
#define SC_SLABS (LANES / SC_SLAB)

template <typename T, typename S, int CB, bool STAGED>
__global__ void lane_scatter_cm_kernel(
    const T* __restrict__ src, const S* __restrict__ slots,
    const S* __restrict__ off, T* __restrict__ out, int C, int nT, int V,
    int K, int k_out, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = blockIdx.x / SC_SLABS;
  const int j0 = (blockIdx.x % SC_SLABS) * SC_SLAB;
  const int j = j0 + threadIdx.x;
  const int c0 = blockIdx.y * CB;
  // src row (v*C + c) of bin t starts at ((v*C + c) * nT + t) * K * LANES
  const long long cst = (long long)nT * K * LANES;  // one src row (channel)
  const T* sp = src + ((long long)c0 * nT + t) * K * LANES + j;
  const T* tile = nullptr;  // staged: (V, CB, K, SC_SLAB)
  if (STAGED) {
    T* st = reinterpret_cast<T*>(smem_raw);
    constexpr int PER = 16 / sizeof(T);  // values of one 16-byte copy
    constexpr int CHUNKS = SC_SLAB / PER;  // copies of one slab row
    const int rows = V * CB * K;
    const int nthr = blockDim.x * blockDim.y;
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < rows * CHUNKS;
         i += nthr) {
      const int row = i / CHUNKS, ch = i - row * CHUNKS;
      const int vc = row / K, k = row - vc * K;
      const int v = vc / CB, c = vc - v * CB;
      const T* g = src + (((long long)(v * C + c0 + c)) * nT + t) * K * LANES
                   + (long long)k * LANES + j0 + ch * PER;
      cp_async16(st + (long long)row * SC_SLAB + ch * PER, g);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tile = st + threadIdx.x;
  }
  const S* sl = slots + (long long)t * E * LANES + j;
  const S* of = off + (long long)t * (k_out + 1) * LANES + j;
  const long long ost = (long long)nT * k_out * LANES;  // one out channel
  T* op = out + ((long long)c0 * nT + t) * k_out * LANES + j;
  for (int r = threadIdx.y; r < k_out; r += blockDim.y) {
    T acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = T(0);
    const int a = (int)of[(long long)r * LANES];
    const int b = (int)of[(long long)(r + 1) * LANES];
#pragma unroll 4
    for (int s = a; s < b; ++s) {
      const int e = (int)sl[(long long)s * LANES];
      const int v = e / K, k = e - v * K;
      if (STAGED) {
        const T* p = tile + ((v * CB) * K + k) * SC_SLAB;
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[c] += p[c * K * SC_SLAB];
      } else {
        const T* p = sp + (long long)v * C * cst + (long long)k * LANES;
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[c] += __ldg(p + c * cst);
      }
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) op[c * ost + (long long)r * LANES] = acc[c];
  }
}

template <typename T, typename S, int CB>
static int launch_scatter(const void* src, const void* slots, const void* off,
                          void* out, int C, int nT, int V, int K, int k_out,
                          int E, int ry, int staged, cudaStream_t stream) {
  dim3 grid(nT * SC_SLABS, C / CB);
  dim3 block(SC_SLAB, ry);
  if (staged) {
    const size_t smem = (size_t)V * CB * K * SC_SLAB * sizeof(T);
    auto kern = lane_scatter_cm_kernel<T, S, CB, true>;
    static size_t opted_in = 48 * 1024;  // per instance: no call per launch
    if (smem > opted_in) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted_in = smem;
    }
    kern<<<grid, block, smem, stream>>>(
        (const T*)src, (const S*)slots, (const S*)off, (T*)out, C, nT, V, K,
        k_out, E);
  } else if constexpr (sizeof(S) == 1) {
    return (int)cudaErrorInvalidValue;  // an int8 table's tile always fits
  } else {
    lane_scatter_cm_kernel<T, S, CB, false><<<grid, block, 0, stream>>>(
        (const T*)src, (const S*)slots, (const S*)off, (T*)out, C, nT, V, K,
        k_out, E);
  }
  return (int)cudaGetLastError();
}

// vt: 0 float, 1 double; st: slot / offset type, 0 int8, 1 int16. cb:
// channels of a block (1-3, dividing C; grid y); ry: row threads of a
// block; staged: copy the slab's src tile into shared memory first (the
// wrapper checks that it fits; an int8 table is always staged)
extern "C" int lane_scatter_cm(
    int vt, int st, const void* src, const void* slots, const void* off,
    void* out, int C, int nT, int V, int K, int k_out, int E, int cb, int ry,
    int staged, void* stream) {
  if (nT <= 0 || C <= 0 || k_out <= 0) return 0;
  if (cb < 1 || cb > 3 || C % cb || ry < 1 || SC_SLAB * ry > 1024 ||
      E < 1 || V * K < 1)
    return (int)cudaErrorInvalidValue;
#define CALL_CB(T, S, CB)                                                   \
  return launch_scatter<T, S, CB>(src, slots, off, out, C, nT, V, K, k_out, \
                                  E, ry, staged, (cudaStream_t)stream)
#define CALL(T, S)                          \
  do {                                      \
    if (cb == 1) CALL_CB(T, S, 1);          \
    if (cb == 2) CALL_CB(T, S, 2);          \
    CALL_CB(T, S, 3);                       \
  } while (0)
  if (vt == 0 && st == 0) CALL(float, int8_t);
  if (vt == 0 && st == 1) CALL(float, int16_t);
  if (vt == 1 && st == 0) CALL(double, int8_t);
  if (vt == 1 && st == 1) CALL(double, int16_t);
#undef CALL
#undef CALL_CB
  return (int)cudaErrorInvalidValue;
}
