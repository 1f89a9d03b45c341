// lattice_matvec3d -- K8: y = K x for isotropic linear elasticity on a
// uniform Q1 hex lattice, as a 27-point stencil of constant 3x3 blocks.
//
// Replaces the TPU kernel tpufem/structured/pallas3d.py:make_linear_matvec
// (its pl.pallas_call at :180). x, y (3, nz+1, ny+1, nx+1), float32. For
// node n and neighbour offset delta in {-1,0,1}^3 (z, y, x; z slowest) and
// each cell chi in {-1,0}^3 (relative to n) that holds both n and n+delta,
//   y[a](n) += K[delta][chi][a][b] * x[b](n + delta)   (b, then a, inner)
// where a cell counts only if it lies in the lattice (per-axis masks: a node
// on a face or an edge has fewer incident cells). The 64 (delta, chi) pairs
// and their blocks, in that order, come from the analytic float64 element
// matrix rounded to float32 (tpufem_torch/structured/kernels3d.py). The
// reference skips zero entries; here a zero entry adds +-0, which leaves the
// value of a sum of finite terms as it was (a uniform cell has no zero
// entry). No boundary-condition treatment: the caller masks.
//
// The TPU kernel rolls whole z-slabs in VMEM with a one-plane halo
// (block_z). Here one thread owns one node: it reads the three components
// of its 27 neighbours (L1 / L2 hits: each value is read by 27 threads) and
// keeps the three sums in registers, adding in the reference's order
// (delta outer, chi, b, a inner); with the library built without fused
// multiply-adds the result equals the plain PyTorch version, which adds in
// the same order, bit for bit. The constants (2304 bytes) are a kernel argument,
// read from the constant bank; the (delta, chi) structure is unrolled at
// compile time.
//
// Bound on this card: at the ridge. Bytes: x read once, y written once,
// 24 bytes a node; operations: 18 flops for each in-lattice neighbour
// (486 a node inside). This kernel does more: up to 8 incident-cell
// blocks per neighbour, separately rounded (up to 1152 flops a node inside),
// the price of the reference's order.
#include <cuda_runtime.h>

#define LM_TX 32
#define LM_TY 4
#define LM_TERMS 64

struct Matvec3DConsts {
  float K[LM_TERMS][9];  // [term][a * 3 + b]
};

__global__ void __launch_bounds__(LM_TX * LM_TY) lattice_matvec3d_kernel(
    const float* __restrict__ x, float* __restrict__ y, int nx, int ny,
    int nz, Matvec3DConsts k) {
  const int ix = blockIdx.x * LM_TX + threadIdx.x;
  const int iy = blockIdx.y * LM_TY + threadIdx.y;
  const int iz = blockIdx.z;
  if (ix > nx || iy > ny) return;
  const int NX1 = nx + 1, NY1 = ny + 1;
  const long long comp = (long long)(nz + 1) * NY1 * NX1;
  // does the cell at node coordinate + chi (chi = -1: index 0, 0: 1) exist
  const bool mz[2] = {iz >= 1, iz < nz};
  const bool my[2] = {iy >= 1, iy < ny};
  const bool mx[2] = {ix >= 1, ix < nx};
  float acc[3] = {0.f, 0.f, 0.f};
  int t = 0;
#pragma unroll
  for (int dz = -1; dz <= 1; ++dz) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int jz = iz + dz, jy = iy + dy, jx = ix + dx;
        const bool in = jz >= 0 && jz <= nz && jy >= 0 && jy <= ny &&
                        jx >= 0 && jx <= nx;
        float xb[3];
        const long long g = ((long long)jz * NY1 + jy) * NX1 + jx;
#pragma unroll
        for (int b = 0; b < 3; ++b) xb[b] = in ? x[b * comp + g] : 0.f;
#pragma unroll
        for (int cz = -1; cz <= 0; ++cz) {
#pragma unroll
          for (int cy = -1; cy <= 0; ++cy) {
#pragma unroll
            for (int cx = -1; cx <= 0; ++cx) {
              // corner of the neighbour in cell chi: -chi + delta
              if (dz - cz < 0 || dz - cz > 1 || dy - cy < 0 || dy - cy > 1 ||
                  dx - cx < 0 || dx - cx > 1)
                continue;
              if (mz[cz + 1] && my[cy + 1] && mx[cx + 1]) {
#pragma unroll
                for (int b = 0; b < 3; ++b) {
#pragma unroll
                  for (int a = 0; a < 3; ++a) {
                    acc[a] = acc[a] + k.K[t][a * 3 + b] * xb[b];
                  }
                }
              }
              ++t;
            }
          }
        }
      }
    }
  }
  const long long g = ((long long)iz * NY1 + iy) * NX1 + ix;
#pragma unroll
  for (int a = 0; a < 3; ++a) y[a * comp + g] = acc[a];
}

extern "C" int lattice_matvec3d(const void* x, void* y, int nx, int ny,
                                int nz, const float* consts, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || nz + 1 > 65535)
    return (int)cudaErrorInvalidValue;
  Matvec3DConsts k;
  for (int t = 0; t < LM_TERMS; ++t)
    for (int e = 0; e < 9; ++e) k.K[t][e] = consts[t * 9 + e];
  dim3 block(LM_TX, LM_TY);
  dim3 grid((nx + 1 + LM_TX - 1) / LM_TX, (ny + 1 + LM_TY - 1) / LM_TY,
            nz + 1);
  lattice_matvec3d_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, nx, ny, nz, k);
  return (int)cudaGetLastError();
}
