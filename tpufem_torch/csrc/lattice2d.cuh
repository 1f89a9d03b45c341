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
// Node (i, j) adds the contributions of the (at most) six triangles that
// share it -- lower vertices 0, 1, 2 then upper vertices 0, 1, 2, the order
// of the reference -- each exactly once and from one thread: no atomics,
// deterministic and, with the library built without fused multiply-adds,
// bit-equal to the plain PyTorch version
// (tpufem_torch/structured/kernels2d.py), which spells the same operations.
// A cell outside the lattice adds +0, as in the plain version.
//
// Bound on this card. Bytes: u, d (and v) read once, r written once
// (21.0 / 29.4 MB at 1024^2: 0.0063 / 0.0088 ms). Flops: 198 / 362 a cell
// (0.0031 / 0.0057 ms at 67 TFLOP/s). Both understate the floor: the
// library is built with -fmad=false, so every product and every sum is an
// instruction, and the division by 3, 1 / r and sqrt are IEEE sequences
// with a slow-path branch each. The floor is instructions: the main loop
// below is 579 / 725 SASS instructions for one cell a thread (K6 / K7,
// sm_90a, counted by chip_smoke.py), 0.018 / 0.023 ms over 132 SMs x 128
// lanes at 1.98 GHz, times the 1.045 recomputation below.
//
// The TPU kernels compute each node's sum by rolling whole slabs of the
// lattice. Here the lattice is cut into strips of LAT_SW = 31 node columns;
// a strip's tile is LAT_RT = 8 cell rows by 32 cell columns (the strip's
// 31 cells and the one to its left), one cell per thread of a 256-thread
// block (warp = cell row, lane = cell column), so every thread computes
// the same number of cells and no round is partial. The strips, top to
// bottom one after another, form one walk of strips * (ny + 1) node rows,
// cut into as many equal segments as the card holds blocks at once
// (persistent blocks; the host passes the count, kernels2d.py computes
// and tests the geometry this file mirrors). A block walks its segment
// tile by tile down the strip (into the next strip where the segment
// crosses one), one barrier a tile:
//
//  1. the tile's node fields (9 rows x 33 columns, zero outside the
//     lattice) arrive in one of three shared-memory stages by 4-byte
//     cp.async copies issued a tile ahead, so the next tile's loads are
//     in flight while this one computes;
//  2. after the barrier, each thread first gathers its node of the
//     previous tile (lanes 1..31: the strip's 31 node columns) from that
//     tile's stress buffer, then computes its cell's stress (both
//     triangles) into this tile's buffer, rows 1..8. Row 0 is the last
//     cell row of the previous tile, carried in the registers of warp 7,
//     so a cell row is computed once; only the first tile of a piece of
//     the walk recomputes the row above it. Two stress buffers and three
//     node stages keep every buffer's last reader one barrier behind its
//     next writer.
//
// A cell is computed 32/31 times for the strip column it shares, plus one
// row per piece of a walk: 1.044 / 1.048 on average at 1024^2 with 3 / 4
// blocks an SM (1.16 for the PR 4 design's 32 x 8 node tiles). TMA cannot serve the
// node tiles: its global row stride must be a multiple of 16 bytes, and
// (nx + 1) * 4 = 4100 is not.
#pragma once

#include <cuda_runtime.h>

#include "asym_damage.cuh"
#include "lane_async.cuh"

#define LAT_SW 31                    // node columns of a strip
#define LAT_CW (LAT_SW + 1)          // cell columns of a tile: one per lane
#define LAT_RT 8                     // cell rows of a tile: one per warp
#define LAT_THREADS (LAT_CW * LAT_RT)
#define LAT_NR (LAT_RT + 1)          // node rows of a staged tile
#define LAT_NC (LAT_CW + 1)          // node columns of a staged tile
#define LAT_NTILE (LAT_NR * LAT_NC)  // nodes of a staged tile
#define LAT_STAGES 3                 // node stages: a stage is refilled
                                     // one barrier after its last reader

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

// a tile of the walk: strip s, cell rows c0 .. c0 + LAT_RT - 1, in the
// piece of the walk that gathers node rows ra .. rb - 1 of the strip and
// starts at walk position pos
struct LatTile {
  int pos, s, ra, rb, c0;
};

__device__ __forceinline__ void lat_piece(LatTile& t, int pos, int seg_end,
                                          int H) {
  t.pos = pos;
  t.s = pos / H;
  t.ra = pos % H;
  t.rb = min(H, t.ra + (seg_end - pos));
  t.c0 = t.ra - 1;  // the cell row above the piece's first node row
}

// the next tile of the walk; false at the end of the segment
__device__ __forceinline__ bool lat_next(LatTile& t, int seg_end, int H) {
  if (t.c0 + LAT_RT <= t.rb - 1) {
    t.c0 += LAT_RT;
    return true;
  }
  const int pos = t.pos + (t.rb - t.ra);
  if (pos >= seg_end) return false;
  lat_piece(t, pos, seg_end, H);
  return true;
}

template <int MODE>
__global__ void __launch_bounds__(LAT_THREADS) lattice2d_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ d, float* __restrict__ out, int nx, int ny,
    int walk, Lattice2DConsts k) {
  constexpr int NF = MODE == 0 ? 3 : 5;  // ux, uy, d (, vx, vy)
  __shared__ float nodes[LAT_STAGES][NF][LAT_NR][LAT_NC];
  __shared__ float stress[2][2][3][LAT_NR][LAT_CW];  // two tiles' buffers

  const int W = nx + 1, H = ny + 1;
  const long long plane = (long long)H * W;
  const int lane = threadIdx.x % LAT_CW, ty = threadIdx.x / LAT_CW;
  const int seg0 = (int)((long long)blockIdx.x * walk / gridDim.x);
  const int seg1 = (int)((long long)(blockIdx.x + 1) * walk / gridDim.x);
  if (seg0 >= seg1) return;

  // node fields of rows c0 .. c0 + LAT_RT, columns j0 - 1 .. j0 + LAT_SW
  // into stage st: the thread copies tile node e = threadIdx.x (row
  // e / LAT_NC, column e % LAT_NC) and, in warps 0 and 1, e + LAT_THREADS
  const float* field[5] = {u, u + plane, d, v, v + plane};
  const unsigned nodes_s = shared_address(&nodes[0][0][0][0]);
  auto issue = [&](const LatTile& t, int st) {
    const int j0 = t.s * LAT_SW;
#pragma unroll
    for (int r = 0; r < (LAT_NTILE + LAT_THREADS - 1) / LAT_THREADS; ++r) {
      const int e = threadIdx.x + r * LAT_THREADS;
      if (e < LAT_NTILE) {
        const int gi = t.c0 + e / LAT_NC, gj = j0 - 1 + e % LAT_NC;
        const bool in = gi >= 0 && gi <= ny && gj >= 0 && gj <= nx;
        const int g = in ? gi * W + gj : 0;
        const unsigned s0 = nodes_s + (st * NF * LAT_NTILE + e) * 4;
#pragma unroll
        for (int f = 0; f < NF; ++f)
          cp_async4_zfill(s0 + f * (LAT_NTILE * 4), field[f] + g, in);
      }
    }
  };

  // node (i, j) of tile t gathers B^T sigma of the triangles that have it
  // as vertex q: cell (i - dy_q, j - dx_q), row ty + 1 - dy_q, column
  // lane - dx_q of the tile's stress buffer sb
  auto gather = [&](const LatTile& t, int sb) {
    const int i = t.c0 + ty, j = t.s * LAT_SW - 1 + lane;
    if (lane >= 1 && i >= t.ra && i < t.rb && j <= nx) {
      float ax = 0.f, ay = 0.f;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int dy = LAT_OFF[o][q][0], dx = LAT_OFF[o][q][1];
          const int gi = i - dy, gj = j - dx;
          // a cell outside the lattice adds +0, as the plain version's
          // zero padding does (its shared entry may hold anything)
          const bool has = gi >= 0 && gi < ny && gj >= 0 && gj < nx;
          const int r = ty + 1 - dy, c = lane - dx;
          const float s11 = stress[sb][o][0][r][c];
          const float s22 = stress[sb][o][1][r][c];
          const float s12 = stress[sb][o][2][r][c];
          const float fx = k.w[o] * (s11 * k.dN[o][q][0] + s12 * k.dN[o][q][1]);
          const float fy = k.w[o] * (s12 * k.dN[o][q][0] + s22 * k.dN[o][q][1]);
          ax = ax + (has ? fx : 0.f);
          ay = ay + (has ? fy : 0.f);
        }
      }
      const long long g = (long long)i * W + j;
      out[g] = ax;
      out[plane + g] = ay;
    }
  };

  LatTile cur;
  lat_piece(cur, seg0, seg1, H);
  issue(cur, 0);
  cp_async_commit();
  LatTile prev = cur;
  // warp LAT_RT - 1: its cell's stress, row 0 of the next tile's buffer
  float carry[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  bool more = true;
  int st = 0, ns = 0;  // stress buffer it % 2, node stage it % LAT_STAGES
  for (int it = 0; more; ++it) {
    st = it & 1;
    LatTile nxt = cur;
    more = lat_next(nxt, seg1, H);
    // stage (it + 1) % LAT_STAGES was last read by tile it - 2's compute,
    // which every thread finished before the last barrier
    if (more) issue(nxt, ns == LAT_STAGES - 1 ? 0 : ns + 1);
    cp_async_commit();
    cp_async_wait<1>();
    // tile it's nodes are in; tile it - 1's stresses are in; tile it - 2's
    // gather (the last reader of stress buffer st) is done
    __syncthreads();
    if (it > 0) gather(prev, st ^ 1);

    if (ty == LAT_RT - 1) {
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int c = 0; c < 3; ++c) stress[st][o][c][0][lane] = carry[o][c];
    }
    // the thread's cell (ci, cj), local node (ty, lane) its v00
    const int ci = cur.c0 + ty, cj = cur.s * LAT_SW - 1 + lane;
    if (ci >= 0 && ci <= cur.rb - 1 && ci < ny && cj >= 0 && cj < nx) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        float ux[3], uy[3], dd[3], vx[3], vy[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int nr = ty + LAT_OFF[o][q][0], nc = lane + LAT_OFF[o][q][1];
          ux[q] = nodes[ns][0][nr][nc];
          uy[q] = nodes[ns][1][nr][nc];
          dd[q] = nodes[ns][2][nr][nc];
          if constexpr (MODE == 1) {
            vx[q] = nodes[ns][3][nr][nc];
            vy[q] = nodes[ns][4][nr][nc];
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
          asym_stress_jvp<float>(gxx, gyy, e12, grad(vx, 0), grad(vy, 1),
                                 t12, dc, k.lam, k.mu, s11, s22, s12);
        }
        stress[st][o][0][ty + 1][lane] = s11;
        stress[st][o][1][ty + 1][lane] = s22;
        stress[st][o][2][ty + 1][lane] = s12;
        carry[o][0] = s11;
        carry[o][1] = s22;
        carry[o][2] = s12;
      }
    }
    prev = cur;
    cur = nxt;
    ns = ns == LAT_STAGES - 1 ? 0 : ns + 1;
  }
  __syncthreads();  // the last tile's stresses are in
  gather(prev, st);
  cp_async_wait<0>();
}

// the blocks are persistent, one segment of the walk each, sized to what
// the card holds at once: ask for the largest shared-memory carveout, so
// that the driver's choice of L1 / shared split cannot hold fewer of them
// than lattice2d_occupancy counted (a second wave would double the time)
template <int MODE>
static void lattice2d_carveout() {
  static bool done = false;
  if (!done) {
    cudaFuncSetAttribute(lattice2d_kernel<MODE>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    done = true;
  }
}

template <int MODE>
static int lattice2d_launch(const void* u, const void* v, const void* d,
                            void* out, int nx, int ny, const float* consts,
                            int strips, int blocks, void* stream) {
  if (nx < 1 || ny < 1) return (int)cudaErrorInvalidValue;
  // the geometry must be kernels2d.lattice2d_geometry's
  const long long walk = (long long)strips * (ny + 1);
  // the copy offsets are 32-bit
  if (strips != (nx + 1 + LAT_SW - 1) / LAT_SW || blocks < 1 ||
      blocks > walk || 2LL * (ny + 1) * (nx + 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Lattice2DConsts k;
  for (int o = 0; o < 2; ++o)
    for (int q = 0; q < 3; ++q)
      for (int dd = 0; dd < 2; ++dd) k.dN[o][q][dd] = consts[o * 6 + q * 2 + dd];
  k.w[0] = consts[12];
  k.w[1] = consts[13];
  k.lam = consts[14];
  k.mu = consts[15];
  lattice2d_carveout<MODE>();
  lattice2d_kernel<MODE><<<blocks, LAT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)d, (float*)out, nx, ny,
      (int)walk, k);
  return (int)cudaGetLastError();
}

// blocks of lattice2d_kernel<MODE> one SM holds at once
template <int MODE>
static int lattice2d_occupancy(int* blocks_per_sm) {
  lattice2d_carveout<MODE>();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lattice2d_kernel<MODE>, LAT_THREADS, 0);
}
