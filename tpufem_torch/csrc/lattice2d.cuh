// The structured P1 lattice pass shared by lattice_residual.cu (K6) and
// lattice_tangent.cu (K7): nodes on an (ny+1, nx+1) lattice (x fastest),
// each cell (i, j) split into a lower triangle (v00, v10, v11) and an upper
// one (v00, v11, v01), both congruent across the lattice, so the basis
// gradients dN and the weight w of each orientation are two constants.
//
//   MODE 0 (K6): r = F(u)      -- B^T sigma(eps(u), d) per triangle
//   MODE 1 (K7): r = J(u) . v  -- B^T (d sigma / d eps)[eps(v)] per triangle
//
// with the damage of a triangle the mean of its three vertex values and the
// stress of the asymmetric elasto-damage law (asym_damage.cuh). Float32.
//
// The TPU kernels compute each node's sum by rolling whole slabs of the
// lattice (wrap-around masked, an 8-row halo for Mosaic's sublane rule).
// Here a block owns a tile of LAT_TY x LAT_TX nodes. It loads the node
// fields of the tile and a one-node halo above and to the left into shared
// memory, computes the stress of both triangles of every cell that touches
// the tile (LAT_TY+1 by LAT_TX+1 cells: the row and column before the tile
// too) once into shared memory, and after one barrier each thread adds the
// contributions of the (at most) six triangles that share its node -- lower
// vertices 0, 1, 2 then upper vertices 0, 1, 2, the order of the reference.
// Every node gets each contribution exactly once and from one thread: no
// atomics, the result is deterministic and, with the library built without
// fused multiply-adds, bit-equal to the plain PyTorch version
// (tpufem_torch/structured/kernels2d.py), which spells the same operations.
// Cells outside the lattice (the last row and column of nodes have none on
// one side) add nothing.
//
// Bound on this card: bytes (u, d, v read once, r written once; about 200
// (K6) or 330 (K7) flops per cell). Halo cells are computed by two blocks.
#pragma once

#include <cuda_runtime.h>

#include "asym_damage.cuh"

#define LAT_TX 32
#define LAT_TY 8
#define LAT_NX (LAT_TX + 2)   // node tile columns, halo included
#define LAT_NY (LAT_TY + 2)   // node tile rows, halo included
#define LAT_CX (LAT_TX + 1)   // cell tile columns
#define LAT_CY (LAT_TY + 1)   // cell tile rows

// geometry and material: dN[o][k][d] for orientation o (0 lower, 1 upper),
// vertex k, direction d; w[o]; the Lame parameters, all float32 as the
// reference's kernel rounds them
struct Lattice2DConsts {
  float dN[2][3][2];
  float w[2];
  float lam;
  float mu;
};

// vertex lattice offsets (dy, dx) per orientation, element vertex order
__device__ __constant__ static const int LAT_OFF[2][3][2] = {
    {{0, 0}, {0, 1}, {1, 1}},   // lower: v00, v10, v11
    {{0, 0}, {1, 1}, {1, 0}}};  // upper: v00, v11, v01

template <int MODE>
__global__ void __launch_bounds__(LAT_TX * LAT_TY) lattice2d_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ d, float* __restrict__ out, int nx, int ny,
    Lattice2DConsts k) {
  constexpr int NF = MODE == 0 ? 3 : 5;  // ux, uy, d (, vx, vy)
  __shared__ float nodes[NF][LAT_NY][LAT_NX];
  __shared__ float stress[2][3][LAT_CY][LAT_CX];

  const int W = nx + 1;
  const long long plane = (long long)(ny + 1) * W;
  const int i0 = blockIdx.y * LAT_TY;  // first node row of the tile
  const int j0 = blockIdx.x * LAT_TX;
  const int tid = threadIdx.y * LAT_TX + threadIdx.x;
  const int nthreads = LAT_TX * LAT_TY;

  // node fields of rows i0-1 .. i0+LAT_TY, columns j0-1 .. j0+LAT_TX
  for (int e = tid; e < LAT_NY * LAT_NX; e += nthreads) {
    const int r = e / LAT_NX, c = e % LAT_NX;
    const int gi = i0 - 1 + r, gj = j0 - 1 + c;
    const bool in = gi >= 0 && gi <= ny && gj >= 0 && gj <= nx;
    const long long g = (long long)gi * W + gj;
    nodes[0][r][c] = in ? u[g] : 0.f;
    nodes[1][r][c] = in ? u[plane + g] : 0.f;
    nodes[2][r][c] = in ? d[g] : 0.f;
    if constexpr (MODE == 1) {
      nodes[3][r][c] = in ? v[g] : 0.f;
      nodes[4][r][c] = in ? v[plane + g] : 0.f;
    }
  }
  __syncthreads();

  // stress (or its directional derivative) of both triangles of cells
  // i0-1 .. i0+LAT_TY-1 by j0-1 .. j0+LAT_TX-1; local cell (r, c) has its
  // v00 at local node (r, c)
  for (int e = tid; e < LAT_CY * LAT_CX; e += nthreads) {
    const int r = e / LAT_CX, c = e % LAT_CX;
    const int ci = i0 - 1 + r, cj = j0 - 1 + c;
    if (ci < 0 || ci >= ny || cj < 0 || cj >= nx) continue;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      float ux[3], uy[3], dd[3], vx[3], vy[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int nr = r + LAT_OFF[o][q][0], nc = c + LAT_OFF[o][q][1];
        ux[q] = nodes[0][nr][nc];
        uy[q] = nodes[1][nr][nc];
        dd[q] = nodes[2][nr][nc];
        if constexpr (MODE == 1) {
          vx[q] = nodes[3][nr][nc];
          vy[q] = nodes[4][nr][nc];
        }
      }
      // gradient component sum_q f[q] * dN[q][x], q ascending
      auto grad = [&](const float* f, int x) {
        return f[0] * k.dN[o][0][x] + f[1] * k.dN[o][1][x] +
               f[2] * k.dN[o][2][x];
      };
      const float gxx = grad(ux, 0), gxy = grad(ux, 1);
      const float gyx = grad(uy, 0), gyy = grad(uy, 1);
      const float e12 = 0.5f * (gxy + gyx);
      const float dc = (dd[0] + dd[1] + dd[2]) / 3.0f;
      float s11, s22, s12;
      if constexpr (MODE == 0) {
        asym_stress<float>(gxx, gyy, e12, dc, k.lam, k.mu, s11, s22, s12);
      } else {
        const float t12 = 0.5f * (grad(vx, 1) + grad(vy, 0));
        asym_stress_jvp<float>(gxx, gyy, e12, grad(vx, 0), grad(vy, 1), t12,
                               dc, k.lam, k.mu, s11, s22, s12);
      }
      stress[o][0][r][c] = s11;
      stress[o][1][r][c] = s22;
      stress[o][2][r][c] = s12;
    }
  }
  __syncthreads();

  // node (i, j) gathers B^T sigma of the triangles that have it as vertex
  // q: cell (i - dy_q, j - dx_q), local cell (ty + 1 - dy_q, tx + 1 - dx_q)
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i > ny || j > nx) return;
  float ax = 0.f, ay = 0.f;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int dy = LAT_OFF[o][q][0], dx = LAT_OFF[o][q][1];
      const int ci = i - dy, cj = j - dx;
      if (ci < 0 || ci >= ny || cj < 0 || cj >= nx) continue;
      const int r = threadIdx.y + 1 - dy, c = threadIdx.x + 1 - dx;
      const float s11 = stress[o][0][r][c];
      const float s22 = stress[o][1][r][c];
      const float s12 = stress[o][2][r][c];
      const float fx = k.w[o] * (s11 * k.dN[o][q][0] + s12 * k.dN[o][q][1]);
      const float fy = k.w[o] * (s12 * k.dN[o][q][0] + s22 * k.dN[o][q][1]);
      ax = ax + fx;
      ay = ay + fy;
    }
  }
  const long long g = (long long)i * W + j;
  out[g] = ax;
  out[plane + g] = ay;
}

template <int MODE>
static int lattice2d_launch(const void* u, const void* v, const void* d,
                            void* out, int nx, int ny, const float* consts,
                            void* stream) {
  if (nx < 1 || ny < 1) return (int)cudaErrorInvalidValue;
  Lattice2DConsts k;
  for (int o = 0; o < 2; ++o)
    for (int q = 0; q < 3; ++q)
      for (int dd = 0; dd < 2; ++dd) k.dN[o][q][dd] = consts[o * 6 + q * 2 + dd];
  k.w[0] = consts[12];
  k.w[1] = consts[13];
  k.lam = consts[14];
  k.mu = consts[15];
  dim3 block(LAT_TX, LAT_TY);
  dim3 grid((nx + 1 + LAT_TX - 1) / LAT_TX, (ny + 1 + LAT_TY - 1) / LAT_TY);
  lattice2d_kernel<MODE><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)d, (float*)out, nx, ny,
      k);
  return (int)cudaGetLastError();
}
