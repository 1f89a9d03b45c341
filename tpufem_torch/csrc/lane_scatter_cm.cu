// lane_scatter_cm -- cells-minor bin scatter (element vectors -> bin partials).
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_scatter_cm:
//   out[c, t, r, j] = sum over (v, k) with idx[t,v,k,j] == r of src[v*C+c, t, k, j]
// src (V*C, T, K, 128); idx (T, V, K, 128) in [-1, k_out) -- the SAME table
// the gather uses; out (C, T, k_out, 128).
//
// Bound on this card: bytes (src read once, index table read, out written
// once); the arithmetic is one add per source value.
//
// Design: the 128 lane columns never mix, so thread j owns column j of a
// (k_out, 128) accumulator in shared memory (address r*128 + j: bank
// j mod 32, conflict-free) and adds its (v, k) contributions serially in
// the fixed order v-outer, k-inner -- the order of the TPU kernel's
// unrolled loops -- so the sum is deterministic, needs no atomics and is
// bit-equal to the plain version. One block per (bin t, channel c) keeps
// that order while doubling (bs = 2) the blocks in flight; the index table
// is read once per channel. The loads of a few k ahead are independent of
// the running sum and are issued together (unroll) to hide their latency.
//
// Where the accumulator, k_out x 128 values, does not fit a block's shared
// memory (a 3D plan: k_out = 272 rows in float64 take 278 528 bytes), the
// output rows are split into bands of kb rows over grid z: each block keeps
// the rows [r0, r0 + kb) of its band, walks every (v, k) in the same order,
// v outer and k inner, and adds only the entries that land in its band. A
// row's sum is then the same sequence of adds, so the result stays bit-equal
// to the plain version whatever the band count. kb comes from the wrapper
// (tpufem_torch/lane/kernels.py:scatter_cm_geometry); this file checks that
// a band fits.
#include "lane_common.cuh"

// dynamic shared memory one block may use on the H100 (227 KB)
#define SC_SMEM_MAX 232448

template <typename T, typename I>
__global__ void lane_scatter_cm_kernel(
    const T* __restrict__ src, const I* __restrict__ idx,
    T* __restrict__ out, int C, int nT, int V, int K, int k_out, int kb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // (rows, LANES)
  const int j = threadIdx.x;
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const int r0 = blockIdx.z * kb;  // the band's first output row
  const int rows = min(kb, k_out - r0);
  for (int r = 0; r < rows; ++r) acc[r * LANES + j] = T(0);
  for (int v = 0; v < V; ++v) {
    const I* ip = idx + (((long long)t * V + v) * K) * LANES + j;
    const T* sp = src + ((((long long)(v * C + c)) * nT + t) * K) * LANES + j;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int i = (int)ip[(long long)k * LANES] - r0;
      const T val = sp[(long long)k * LANES];
      if (i >= 0 && i < rows) acc[i * LANES + j] += val;
    }
  }
  T* op = out + (((long long)c * nT + t) * k_out + r0) * LANES + j;
  for (int r = 0; r < rows; ++r) op[(long long)r * LANES] = acc[r * LANES + j];
}

template <typename T, typename I>
static int launch_scatter(const void* src, const void* idx, void* out, int C,
                          int nT, int V, int K, int k_out, int kb,
                          cudaStream_t stream) {
  const size_t smem = (size_t)kb * LANES * sizeof(T);
  if (smem > SC_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = lane_scatter_cm_kernel<T, I>;
  static size_t opted_in = 48 * 1024;  // per instance: no call per launch
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 grid(nT, C, (k_out + kb - 1) / kb);
  kern<<<grid, LANES, smem, stream>>>((const T*)src, (const I*)idx, (T*)out,
                                      C, nT, V, K, k_out, kb);
  return (int)cudaGetLastError();
}

// kb: output rows per band (k_out, or fewer where k_out rows do not fit)
extern "C" int lane_scatter_cm(
    int vt, int it, const void* src, const void* idx, void* out,
    int C, int nT, int V, int K, int k_out, int kb, void* stream) {
  if (nT <= 0 || C <= 0 || k_out <= 0) return 0;
  if (kb < 1 || kb > k_out) return (int)cudaErrorInvalidValue;
#define CALL(T, I)                                                     \
  return launch_scatter<T, I>(src, idx, out, C, nT, V, K, k_out, kb,   \
                              (cudaStream_t)stream)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return (int)cudaErrorInvalidValue;
}
