// lattice_matvec3d -- K8: y = K x for isotropic linear elasticity on a
// uniform Q1 hex lattice, as a 27-point stencil of constant 3x3 blocks.
//
// Replaces the TPU kernel tpufem/structured/pallas3d.py:make_linear_matvec
// (its pl.pallas_call at :180). x, y (3, nz+1, ny+1, nx+1), float32. Node
// pair offsets delta in {-1,0,1}^3 (z, y, x; z slowest), component a
// moving along axis 2 - a. Two classes of nodes, two orders, both spelled
// by the plain PyTorch version (tpufem_torch/structured/kernels3d.py),
// which the kernel equals bit for bit (the library is built without fused
// multiply-adds):
//
// - interior nodes (1 <= i <= n - 1 on every axis, all eight incident cells
//   present): y[a] = sum_delta sum_b S[delta][a][b] * x[b](n + delta),
//   delta outer, b, a inner, over the 153 entries that are not zero by
//   symmetry (an off-diagonal entry needs delta nonzero along both its
//   axes). S is the per-cell blocks summed in float64 and rounded once;
//   the pattern is fixed here at compile time, the values are an argument.
// - boundary nodes (the six faces): the reference's order, delta outer,
//   each incident cell chi in the lattice (per-axis masks), b, a inner,
//   from the 64 float32 (delta, chi) blocks.
//
// Bound on this card. Bytes: x read once, y written once, 24 bytes a node
// (100.2 MB at 160^3, 0.030 ms at 3.35 TB/s). Operations: 306 flops an
// interior node (153 products, 153 sums), 1.27 G at 160^3 with the faces
// (0.019 ms at 67 TFLOP/s) -- but without fused multiply-adds every
// product and sum is an instruction of its own, so the floor is
// instructions: the z loop below is 566 SASS instructions an interior
// node (sm_90a, counted by chip_smoke.py: the 306 products and sums, 81
// shared loads, about 60 loads of the blocks into uniform registers,
// which FMUL reads there, the copies and the loop), 0.068 ms over 132
// SMs x 128 lanes at 1.98 GHz.
//
// Design. Interior blocks (256 threads) own a tile of 8 x 32 interior
// nodes of the (y, x) plane and march along z through a chunk of at most
// 16 planes. The halo'd x-planes (10 x 34 nodes, 3 components) stream
// through a 6-stage ring in shared memory, 4-byte cp.async copies with
// zero fill outside the lattice, two planes in flight ahead of the one
// being consumed (TMA cannot serve: its global row stride must be a
// multiple of 16 bytes, and (nx + 1) * 4 = 644 is not); a thread's copy
// offsets are computed once. Each step, after one barrier, a thread
// reads the 81 values around its node from planes z - 1, z, z + 1 of the
// ring (conflict-free: lanes read neighbouring words) with 34 registers,
// so six blocks fit an SM. The blocks are the constant bank. The face
// nodes (153 602 of 4 173 281 at 160^3) are done by face blocks of the
// same launch, one thread a node in the boundary order, so that no
// interior warp runs the boundary path; they follow the interior blocks
// in the grid. The launch geometry comes from the host
// (kernels3d.matvec3d_geometry), which this file mirrors and checks.
#include <cuda_runtime.h>

#include "lane_async.cuh"

#define LM_TX 32
#define LM_TY 8
#define LM_THREADS (LM_TX * LM_TY)
#define LM_HX (LM_TX + 2)          // staged plane columns, halo included
#define LM_HY (LM_TY + 2)          // staged plane rows, halo included
#define LM_HPLANE (LM_HY * LM_HX)  // nodes of a staged plane
#define LM_STAGE (3 * LM_HPLANE)   // floats of a staged plane
#define LM_AHEAD 2                 // planes in flight beyond the consumed one
#define LM_STAGES (LM_AHEAD + 4)   // planes q - 3 .. q + LM_AHEAD are live
                                   // while a slow warp still reads q - 1
#define LM_TERMS 64
#define LM_DELTAS 27

struct Matvec3DConsts {
  float K[LM_TERMS][9];   // boundary: [term][a * 3 + b]
  float S[LM_DELTAS][9];  // interior: [delta][a * 3 + b]
};

// offset of delta index d along the axis of component a (0 x, 1 y, 2 z)
__host__ __device__ constexpr int lm_off(int d, int a) {
  return a == 0 ? d % 3 - 1 : a == 1 ? (d / 3) % 3 - 1 : d / 9 - 1;
}

// is entry (a, b) of the interior block d not zero by symmetry
__host__ __device__ constexpr bool lm_structural(int d, int a, int b) {
  return a == b || (lm_off(d, a) != 0 && lm_off(d, b) != 0);
}

// one node in the boundary order (the parent design's per-thread sum)
__device__ __forceinline__ void lm_boundary_node(
    const float* __restrict__ x, float* __restrict__ y, int ix, int iy,
    int iz, int nx, int ny, int nz, long long comp, const Matvec3DConsts& k) {
  const int NX1 = nx + 1, NY1 = ny + 1;
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

// the interior sum of one node from the staged planes p0, p1, p2 (z - 1,
// z, z + 1); o: the node's (y, x) offset in a staged plane
__device__ __forceinline__ void lm_interior_sum(const float* p0,
                                                const float* p1,
                                                const float* p2, int o,
                                                const Matvec3DConsts& k,
                                                float acc[3]) {
  bool first[3] = {true, true, true};
#pragma unroll
  for (int d = 0; d < LM_DELTAS; ++d) {
    const float* p = d < 9 ? p0 : d < 18 ? p1 : p2;
    const int e = o + ((d / 3) % 3 - 1) * LM_HX + d % 3 - 1;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float xb = p[b * LM_HPLANE + e];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (!lm_structural(d, a, b)) continue;
        const float t = k.S[d][a * 3 + b] * xb;
        acc[a] = first[a] ? t : acc[a] + t;
        first[a] = false;
      }
    }
  }
}

__global__ void __launch_bounds__(LM_THREADS) lattice_matvec3d_kernel(
    const float* __restrict__ x, float* __restrict__ y, int nx, int ny,
    int nz, int tiles_x, int tiles_y, int z_chunk, int n_interior,
    int n_face, Matvec3DConsts k) {
  const int NX1 = nx + 1, NY1 = ny + 1;
  const long long comp = (long long)(nz + 1) * NY1 * NX1;
  const int tid = threadIdx.x;

  if ((int)blockIdx.x >= n_interior) {
    // face block: boundary node f, faces z = 0 and z = nz whole, then per
    // interior plane the rows y = 0 and y = ny, then the columns x = 0 and
    // x = nx between them (kernels3d.face_nodes)
    const long long f =
        (long long)((int)blockIdx.x - n_interior) * LM_THREADS + tid;
    if (f >= n_face) return;
    const long long NP = (long long)NY1 * NX1;
    const int Q = 2 * NX1 + 2 * (ny - 1);
    int ix, iy, iz;
    if (f < 2 * NP) {
      iz = f < NP ? 0 : nz;
      const int r = (int)(f % NP);
      iy = r / NX1;
      ix = r % NX1;
    } else {
      const long long g = f - 2 * NP;
      iz = 1 + (int)(g / Q);
      const int h = (int)(g % Q);
      if (h < 2 * NX1) {
        iy = h < NX1 ? 0 : ny;
        ix = h % NX1;
      } else {
        iy = 1 + (h - 2 * NX1) / 2;
        ix = (h - 2 * NX1) % 2 ? nx : 0;
      }
    }
    lm_boundary_node(x, y, ix, iy, iz, nx, ny, nz, comp, k);
    return;
  }

  __shared__ float ring[LM_STAGES][LM_STAGE];
  int b = blockIdx.x;
  const int ti = b % tiles_x;
  b /= tiles_x;
  const int tj = b % tiles_y;
  const int zc = b / tiles_y;
  const int ix0 = 1 + ti * LM_TX, iy0 = 1 + tj * LM_TY;
  const int z0 = 1 + zc * z_chunk;
  const int z1 = min(z0 + z_chunk, nz);  // interior planes z0 .. z1 - 1
  const int tx = tid % LM_TX, ty = tid / LM_TX;
  const int ix = ix0 + tx, iy = iy0 + ty;
  const bool active = ix <= nx - 1 && iy <= ny - 1;
  const int n_planes = z1 - z0 + 2;  // x-planes z0 - 1 .. z1

  // copy x-plane z0 - 1 + q (rows iy0 - 1 .., columns ix0 - 1 ..) into
  // stage q % LM_STAGES: the thread copies the staged values e = tid +
  // k * LM_THREADS ([component][row][column]), whose offsets in the plane
  // it computes once; nodes past the lattice are zero-filled
  constexpr int NCOPY = (LM_STAGE + LM_THREADS - 1) / LM_THREADS;
  int goff[NCOPY];
  bool gin[NCOPY];
#pragma unroll
  for (int kk = 0; kk < NCOPY; ++kk) {
    const int e = tid + kk * LM_THREADS;
    const int c = e / LM_HPLANE, rem = e % LM_HPLANE;
    const int gy = iy0 - 1 + rem / LM_HX, gx = ix0 - 1 + rem % LM_HX;
    gin[kk] = e < LM_STAGE && gy <= ny && gx <= nx;
    goff[kk] = gin[kk] ? c * (int)comp + gy * NX1 + gx : 0;
  }
  const unsigned ring_s = shared_address(&ring[0][0]);
  auto issue = [&](int q) {
    const unsigned st = ring_s + (q % LM_STAGES) * (LM_STAGE * 4);
    const float* xp = x + (z0 - 1 + q) * NY1 * NX1;
#pragma unroll
    for (int kk = 0; kk < NCOPY; ++kk) {
      const int e = tid + kk * LM_THREADS;
      if (e < LM_STAGE)
        cp_async4_zfill(st + e * 4, gin[kk] ? xp + goff[kk] : x, gin[kk]);
    }
  };

#pragma unroll
  for (int q = 0; q < LM_AHEAD; ++q) {
    if (q < n_planes) issue(q);
    cp_async_commit();
  }
  for (int q = 0; q < n_planes; ++q) {
    if (q + LM_AHEAD < n_planes) issue(q + LM_AHEAD);
    cp_async_commit();
    cp_async_wait<LM_AHEAD>();
    __syncthreads();
    if (q >= 2 && active) {
      // node z = z0 - 2 + q from planes z - 1, z, z + 1 (q - 2, q - 1, q)
      float acc[3];
      lm_interior_sum(ring[(q - 2) % LM_STAGES], ring[(q - 1) % LM_STAGES],
                      ring[q % LM_STAGES], (ty + 1) * LM_HX + tx + 1, k, acc);
      const long long g = ((long long)(z0 - 2 + q) * NY1 + iy) * NX1 + ix;
#pragma unroll
      for (int a = 0; a < 3; ++a) y[a * comp + g] = acc[a];
    }
  }
}

static int lm_cdiv(int a, int b) { return (a + b - 1) / b; }

extern "C" int lattice_matvec3d(const void* x, void* y, int nx, int ny,
                                int nz, const float* consts, int tiles_x,
                                int tiles_y, int z_chunk, int n_face,
                                void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || z_chunk < 1)
    return (int)cudaErrorInvalidValue;
  // the geometry must be kernels3d.matvec3d_geometry's
  const long long want_face = 2LL * (ny + 1) * (nx + 1) +
                              (long long)(nz - 1) * (2 * (nx + 1) + 2 * (ny - 1));
  if (tiles_x != lm_cdiv(nx - 1, LM_TX) || tiles_y != lm_cdiv(ny - 1, LM_TY) ||
      n_face != want_face)
    return (int)cudaErrorInvalidValue;
  const long long n_interior =
      (long long)tiles_x * tiles_y * lm_cdiv(nz - 1, z_chunk);
  const long long blocks = n_interior + lm_cdiv(n_face, LM_THREADS);
  // the interior blocks' copy offsets are 32-bit
  if (blocks > 0x7fffffffLL ||
      3LL * (nz + 1) * (ny + 1) * (nx + 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Matvec3DConsts k;
  for (int t = 0; t < LM_TERMS; ++t)
    for (int e = 0; e < 9; ++e) k.K[t][e] = consts[t * 9 + e];
  for (int d = 0; d < LM_DELTAS; ++d)
    for (int e = 0; e < 9; ++e) k.S[d][e] = consts[(LM_TERMS + d) * 9 + e];
  lattice_matvec3d_kernel<<<(unsigned)blocks, LM_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, nx, ny, nz, tiles_x, tiles_y, z_chunk,
      (int)n_interior, n_face, k);
  return (int)cudaGetLastError();
}
