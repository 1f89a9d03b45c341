// lane_fused_gen -- fused gather -> generated element physics -> bin scatter.
//
// Replaces the TPU kernel tpufem/lane/kernels.py:521 (lane_fused_elem) on
// the P1 single-point path for any integrand: the reference traces the AD
// graph of the integrand into its kernel body; here the graphs are traced
// ahead of time and emitted as C (tpufem_torch/lane/fused_gen.py), and a
// generated unit includes this template with its physics struct P and
// instantiates two kernels, one state and two (LANE_FUSED_GEN_ENTRY).
// lane_fused_elem.cu keeps the two hand-written laws.
//   ug[v*C+c, k, j] = u[c, starts[t] + idx[t,v,k,j], j]        (0 for idx = -1)
//   a  = reduced variables of ug: gradient components sum_v ug * dN, then
//        values (sum_v ug) / NV, separate multiplies and adds
//   g  = P::grad(a, w, x, coefficients)    (one state), or
//        P::jvp(a, ..., reduced variables of vg)           (two states)
//   ev[v*C+c] = g[NG+c] / NV + sum_d g[c*GD+d] * dN[v][d]
//   out[c, t, r, j] = sum over (k, v) with idx[t,v,k,j] == r of ev[v*C+c, k, j]
// u, v (C, R, 128); starts (T,) int32; idx (T, NV, K, 128) in [-1, wr);
// geom (T, DG, K, 128): dN[v][d] at row v*GD+d, the weight at NV*GD, then
// the GD quadrature-point rows where the physics reads x (XR); cd (T, DC,
// K, 128): coefficient rows. The output is stored channel-leading,
// out[c][t][r][j], as lane_fused_elem.cu stores it.
//
// The design is lane_fused_elem.cu's, with NV, C, GD, DG and DC from P, so
// that triangles and tetrahedra and 1, 2 or 3 components all instantiate
// it: a block takes LB of the 128 lane columns of one bin (grid (T, 128 /
// LB)) and KY cells a round; the cell data of each round streams through a
// ring of S shared-memory stages by 16-byte cp.async, S - 1 rounds ahead;
// each thread computes the element vectors of its cell and stages them;
// the scatter adds the staged cells in cell order, vertex inner, into the
// (C, wr, LB) accumulator in shared memory, every address by one thread
// (address (c, r) by thread row (c * wr + r) % KY), so the sum is the
// plain version's bit for bit without atomics. The state windows are
// copied into shared memory (WIN) where two blocks still fit an SM, or
// else read from global memory where a gather needs them (3D plans: a
// window of 272 rows in three channels). The physics is straight-line
// code of the traced graph; the library is built without fused
// multiply-adds, so it rounds as PyTorch's kernels do, operation by
// operation.
//
// Bound on this card: bytes, as K4's (index, geometry and coefficient rows
// read once a cell slot, the states and the output); the generated
// physics is a few hundred operations a cell, far below the arithmetic
// rate. Right before fast: no wgmma or TMA.
#pragma once

#include "lane_common.cuh"
#include "lane_async.cuh"

// the physics struct's functions: device code here (a host build of the
// same physics, for tests, defines GEN_HD as plain inline)
#ifndef GEN_HD
#define GEN_HD __device__ __forceinline__
#endif

// byte offsets of the shared-memory regions, each 16-byte aligned
struct GenLayout {
  size_t acc, win, rval, ridx, ev, ids, total;
};

__host__ __device__ inline size_t gen_pad16(size_t b) {
  return (b + 15) / 16 * 16;
}

// lb: lane columns of a block; ky: its thread rows (cells of a round);
// stages: ring depth in rounds; ns: states; win: windows staged; wr:
// window rows; nv, c: vertices and components; nval: staged value rows
// (geometry and coefficients) of a cell
template <typename T, typename I>
__host__ __device__ inline GenLayout gen_layout(int lb, int ky, int stages,
                                                int ns, bool win, int wr,
                                                int nv, int c, int nval) {
  GenLayout L;
  size_t o = 0;
  L.acc = o;   // (C, wr, lb)
  o += gen_pad16((size_t)c * wr * lb * sizeof(T));
  L.win = o;   // (ns, C, wr, lb) or nothing
  o += win ? gen_pad16((size_t)ns * c * wr * lb * sizeof(T)) : 0;
  L.rval = o;  // (stages, nval, ky, lb)
  o += gen_pad16((size_t)stages * nval * ky * lb * sizeof(T));
  L.ridx = o;  // (stages, NV, ky, lb)
  o += gen_pad16((size_t)stages * nv * ky * lb * sizeof(I));
  L.ev = o;    // (2, ky, NV * C, lb)
  o += gen_pad16((size_t)2 * ky * nv * c * lb * sizeof(T));
  L.ids = o;   // (2, ky, NV, lb)
  o += gen_pad16((size_t)2 * ky * nv * lb * sizeof(short));
  L.total = o;
  return L;
}

// the reduced variables of one state: the dof values of the cell's
// vertices (from the staged window at column j, or from global memory at
// column j0 + j), then gradient components and values
template <typename T, class P, int LB, bool WIN>
__device__ __forceinline__ void gen_reduced(const T* __restrict__ win,
                                            const T* __restrict__ state,
                                            long long start, long long R,
                                            int wr, int col, const int* i,
                                            const bool* ok,
                                            const T (*dN)[P::GD], T* a) {
  T ug[P::NV][P::C];
#pragma unroll
  for (int v = 0; v < P::NV; ++v) {
#pragma unroll
    for (int c = 0; c < P::C; ++c) {
      if constexpr (WIN) {
        ug[v][c] = ok[v] ? win[(c * wr + i[v]) * LB] : T(0);
      } else {
        long long row = start + i[v];
        row = row < R - 1 ? row : R - 1;
        ug[v][c] = ok[v] ? state[(c * R + row) * LANES + col] : T(0);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < P::C; ++c) {
#pragma unroll
    for (int d = 0; d < P::GD; ++d) {
      T acc = ug[0][c] * dN[0][d];
#pragma unroll
      for (int v = 1; v < P::NV; ++v) acc = acc + ug[v][c] * dN[v][d];
      a[c * P::GD + d] = acc;
    }
  }
#pragma unroll
  for (int c = 0; c < P::C; ++c) {
    T acc = ug[0][c];
#pragma unroll
    for (int v = 1; v < P::NV; ++v) acc = acc + ug[v][c];
    a[P::C * P::GD + c] = acc * P::INV_NV;
  }
}

// NS: states (1 grad, 2 jvp); LB: lane columns of the block; KY: its
// thread rows, the cells of a round; S: ring depth in rounds; WIN: the
// state windows staged in shared memory
template <typename T, typename I, class P, int NS, int LB, int KY, int S,
          bool WIN>
__global__ void __launch_bounds__(LB * KY) lane_fused_gen_kernel(
    const T* __restrict__ u, const T* __restrict__ vdir,
    const int32_t* __restrict__ starts, const I* __restrict__ idx,
    const T* __restrict__ geom, const T* __restrict__ cd,
    T* __restrict__ out, int R, int nT, int K, int wr) {
  constexpr int NV = P::NV, C = P::C, GD = P::GD, DG = P::DG, DC = P::DC;
  constexpr int NVAL = DG + DC;
  constexpr int NG = C * GD;
  constexpr int NR = P::NR;
  static_assert(NR == NG + C, "reduced variables: gradient, then values");
  static_assert((KY & (KY - 1)) == 0, "KY must be a power of two");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GenLayout L = gen_layout<T, I>(LB, KY, S, NS, WIN, wr, NV, C, NVAL);
  T* acc = reinterpret_cast<T*>(smem_raw + L.acc);
  T* win = reinterpret_cast<T*>(smem_raw + L.win);
  T* rval = reinterpret_cast<T*>(smem_raw + L.rval);
  I* ridx = reinterpret_cast<I*>(smem_raw + L.ridx);
  T* evs = reinterpret_cast<T*>(smem_raw + L.ev);
  short* ids = reinterpret_cast<short*>(smem_raw + L.ids);
  const int j = threadIdx.x;
  const int ky = threadIdx.y;
  const int tid = ky * LB + j;
  const int nthr = LB * KY;
  const int t = blockIdx.x;
  const int j0 = blockIdx.y * LB;
  const int rs = KY * LB;  // stride between staged rows of a stage
  const long long R_ = R;
  const long long start = starts[t];

  for (int q = tid; q < C * wr * LB; q += nthr) acc[q] = T(0);

  // the bin's state windows, columns [j0, j0 + LB): one copy group (empty
  // where the windows are read from global memory)
  if constexpr (WIN) {
    constexpr int cpr = (int)(LB * sizeof(T) / 16);
#pragma unroll
    for (int sc = 0; sc < NS * C; ++sc) {  // state-major, then channel
      const T* state = sc < C ? u : vdir;
      const long long c = sc % C;
      for (int q = tid; q < wr * cpr; q += nthr) {
        const int r = q / cpr;
        const int ch = q - r * cpr;
        long long srow = start + r;
        srow = srow < R_ - 1 ? srow : R_ - 1;
        cp_async16(reinterpret_cast<unsigned char*>(
                       win + ((size_t)sc * wr + r) * LB) + ch * 16,
                   reinterpret_cast<const unsigned char*>(
                       state + (c * R_ + srow) * LANES + j0) + ch * 16);
      }
    }
  }
  cp_async_commit();

  // the cell data of round rd (cells rd * KY ...) into ring stage `stage`
  auto issue = [&](int rd, int stage) {
    const int k0 = rd * KY;
    constexpr int icpr = (int)(LB * sizeof(I) / 16);
    for (int q = tid; q < NV * KY * icpr; q += nthr) {
      const int vk = q / icpr;
      const int ch = q - vk * icpr;
      const int v = vk / KY;
      const int kk = vk - v * KY;
      if (k0 + kk >= K) continue;
      const I* src = idx + (((long long)t * NV + v) * K + k0 + kk) * LANES + j0;
      cp_async16(reinterpret_cast<unsigned char*>(
                     ridx + (((size_t)stage * NV + v) * KY + kk) * LB) +
                     ch * 16,
                 reinterpret_cast<const unsigned char*>(src) + ch * 16);
    }
    constexpr int vcpr = (int)(LB * sizeof(T) / 16);
    for (int q = tid; q < NVAL * KY * vcpr; q += nthr) {
      const int gk = q / vcpr;
      const int ch = q - gk * vcpr;
      const int g = gk / KY;
      const int kk = gk - g * KY;
      if (k0 + kk >= K) continue;
      const T* src =
          g < DG ? geom + (((long long)t * DG + g) * K + k0 + kk) * LANES + j0
                 : cd + (((long long)t * DC + (g - DG)) * K + k0 + kk) *
                            LANES + j0;
      cp_async16(reinterpret_cast<unsigned char*>(
                     rval + (((size_t)stage * NVAL + g) * KY + kk) * LB) +
                     ch * 16,
                 reinterpret_cast<const unsigned char*>(src) + ch * 16);
    }
  };

  // all the round's staged rows and values first (independent loads),
  // then the adds in cell order, vertex inner, each into the addresses
  // this thread owns
  auto scatter = [&](int rd) {
    const int b = rd & 1;
    int rr[KY][NV];
    T ee[KY][NV][C];
#pragma unroll
    for (int kk = 0; kk < KY; ++kk) {
      const short* id_k = ids + ((size_t)(b * KY + kk) * NV) * LB + j;
      const T* ev_k = evs + ((size_t)(b * KY + kk) * NV * C) * LB + j;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        rr[kk][v] = id_k[v * LB];
#pragma unroll
        for (int c = 0; c < C; ++c) ee[kk][v][c] = ev_k[(v * C + c) * LB];
      }
    }
#pragma unroll
    for (int kk = 0; kk < KY; ++kk) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int r = rr[kk][v];
        if (r < 0) continue;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int q = c * wr + r;
          if ((q & (KY - 1)) == ky) acc[q * LB + j] += ee[kk][v][c];
        }
      }
    }
  };

  const int rounds = (K + KY - 1) / KY;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < rounds) issue(s, s);
    cp_async_commit();
  }
  for (int rd = 0; rd < rounds; ++rd) {
    // this thread's copies of the windows and of round rd have landed; the
    // barrier makes every thread's visible, and retires the ring stage of
    // round rd - 1 and the staging buffer of round rd - 2
    cp_async_wait<S - 2>();
    __syncthreads();
    if (rd + S - 1 < rounds) issue(rd + S - 1, (rd + S - 1) % S);
    cp_async_commit();
    if (rd > 0) scatter(rd - 1);

    const int stage = rd % S;
    const int b = rd & 1;
    const int k = rd * KY + ky;
    T* ev_mine = evs + ((size_t)(b * KY + ky) * NV * C) * LB + j;
    short* id_mine = ids + ((size_t)(b * KY + ky) * NV) * LB + j;
    if (k < K) {
      const I* ri = ridx + ((size_t)stage * NV * KY + ky) * LB + j;
      const T* rv = rval + ((size_t)stage * NVAL * KY + ky) * LB + j;
      int i[NV];
      bool ok[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        i[v] = (int)ri[v * rs];
        ok[v] = (i[v] >= 0) && (i[v] < wr);
      }
      T dN[NV][GD];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int d = 0; d < GD; ++d) dN[v][d] = rv[(v * GD + d) * rs];
      }
      T in[P::NIN];
      gen_reduced<T, P, LB, WIN>(win + j, u, start, R_, wr, j0 + j, i, ok,
                                 dN, in);
      in[NR] = rv[(NV * GD) * rs];
#pragma unroll
      for (int d = 0; d < GD; ++d)
        in[NR + 1 + d] = P::XR ? rv[(NV * GD + 1 + d) * rs] : T(0);
      // the averaged coefficient components

      P::coeffs(rv + DG * rs, rs, in + NR + 1 + GD);
      T g[NR];
      if constexpr (NS == 1) {
        P::grad(in, g);
      } else {
        T din[NR];
        gen_reduced<T, P, LB, WIN>(win + (size_t)C * wr * LB + j, vdir,
                                   start, R_, wr, j0 + j, i, ok, dN, din);
        P::jvp(in, din, g);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        id_mine[v * LB] = (short)(ok[v] ? i[v] : -1);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          T e = g[NG + c] * P::INV_NV;
#pragma unroll
          for (int d = 0; d < GD; ++d) e = e + g[c * GD + d] * dN[v][d];
          ev_mine[(v * C + c) * LB] = e;
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v) id_mine[v * LB] = -1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (rounds > 0) scatter(rounds - 1);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int q = tid; q < wr * LB; q += nthr) {
      const int r = q / LB;
      const int jj = q - r * LB;
      out[(((long long)c * nT + t) * wr + r) * LANES + j0 + jj] =
          acc[c * wr * LB + q];
    }
  }
}

template <typename T, typename I, class P, int NS, int LB, int KY, int S,
          bool WIN>
static int lane_fused_gen_launch_impl(const void* u, const void* v,
                                      const void* starts, const void* idx,
                                      const void* geom, const void* cd,
                                      void* out, int R, int nT, int K,
                                      int wr, long long smem,
                                      cudaStream_t stream) {
  if (nT <= 0 || K <= 0) return 0;
  if (wr <= 0 || wr > 32767 || (NS == 2 && v == nullptr) ||
      (P::DC > 0 && cd == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem != gen_layout<T, I>(LB, KY, S, NS, WIN, wr, P::NV, P::C,
                                       P::DG + P::DC).total)
    return (int)cudaErrorInvalidValue;
  auto kern = lane_fused_gen_kernel<T, I, P, NS, LB, KY, S, WIN>;
  static size_t opted_in = 48 * 1024;  // per instance: no call per launch
  if ((size_t)smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = (size_t)smem;
  }
  dim3 block(LB, KY);
  dim3 grid(nT, LANES / LB);
  kern<<<grid, block, (size_t)smem, stream>>>(
      (const T*)u, (const T*)v, (const int32_t*)starts, (const I*)idx,
      (const T*)geom, (const T*)cd, (T*)out, R, nT, K, wr);
  return (int)cudaGetLastError();
}

// an entry point of a generated unit: lane_fused_gen_launch1 (gradient) or
// lane_fused_gen_launch2 (Hessian-vector product), with the unit's physics
// struct, index type and the block layout of that state count
#define LANE_FUSED_GEN_ENTRY(P, I, NS, LB, KY, S, WIN)                       \
  extern "C" int lane_fused_gen_launch##NS(                                 \
      const void* u, const void* v, const void* starts, const void* idx,   \
      const void* geom, const void* cd, void* out, int R, int nT, int K,    \
      int wr, long long smem, void* stream) {                               \
    return lane_fused_gen_launch_impl<P::GT, I, P, NS, LB, KY, S, WIN>(     \
        u, v, starts, idx, geom, cd, out, R, nT, K, wr, smem,              \
        (cudaStream_t)stream);                                              \
  }
