// lane_fused_gen_mq -- fused gather -> generated element physics summed over
// quadrature points -> bin scatter.
//
// Replaces the TPU kernel tpufem/lane/kernels.py:521 (lane_fused_elem) on
// the multi-quadrature-point path (P2, Q1, Q2, P1 under a higher rule,
// folded terms), where the reference traces its multi-point element
// function (tpufem/lane/engine.py:1247-1329, _make_block_fns_mq) into the
// kernel body. The point graphs are traced ahead of time and emitted as C
// (tpufem_torch/lane/fused_gen.py:GenPhysicsMQ); a generated unit includes
// this template, then its basis value tables and its physics struct P, and
// instantiates two kernels, one state and two (LANE_FUSED_GEN_MQ_ENTRY).
//   ug[v*C+c, k, j] = u[c, starts[t] + idx[t,v,k,j], j]        (0 for idx = -1)
//   at each point q, in order:
//     a  = gradient components sum_v ug * dN[q], values sum_v Nf[q,v] * ug
//          (zero weights skipped, unit weights not multiplied)
//     g  = P::grad(a, w[q], x[q], coefficients at q)   (one state), or
//          P::jvp(a, ..., reduced variables of vg at q)          (two states)
//     ev[v*C+c] += sum_d g[c*GD+d] * dN[q][v][d] (+ Nf[q,v] * g[NG+c])
//   out[c, t, r, j] = sum over (k, v) with idx[t,v,k,j] == r of ev[v*C+c, k, j]
// u, v (C, R, 128); starts (T,) int32; idx (T, NV, K, 128) in [-1, wr);
// geom (T, DG, K, 128): dN[q][v][d] at row (q*NV+v)*GD+d, the NQ weights at
// NQ*NV*GD, then the NQ*GD quadrature-point rows where the physics reads x
// (XR); cd (T, DC, K, 128): coefficient rows. The output is stored
// channel-leading, out[c][t][r][j], as lane_fused_gen.cuh stores it.
//
// Design. The single-point template stages a whole cell's value rows in a
// shared-memory ring; a Q2 hexahedron has 2 214 of them (142 KB for one
// round of 16 cells), and its 81 dofs in two states and 81 element-vector
// entries would not stay in registers. So here a block takes LB of the 128
// lane columns of one bin (grid (T, 128 / LB)) and KY cells a round, one
// thread a cell, and
//   - the gathered dofs (NS states) and the element vector of each thread
//     live in shared memory, [row][thread], as do its coefficient rows;
//   - the geometry is read one quadrature point at a time straight from
//     global memory (each row is 128 contiguous lanes: a warp's read of a
//     row is one coalesced segment), the point loop rolled and the physics
//     inlined once inside it; the point's dN rows are read again by the
//     chain back (from L1 / L2);
//   - a lane cell whose every index is -1 (padding: about half the lane
//     cells of a 3D Q2 plan) reads nothing and computes nothing -- its
//     element vector would be scattered nowhere, so the result stays the
//     plain version's bit for bit;
//   - after a barrier the round's cells are added in cell order, vertex
//     inner, into the (C, wr, LB) accumulator in shared memory, every
//     address by one thread (address (c, r) by thread row (c*wr + r) % KY),
//     so the sum is the plain version's without atomics.
// The state windows are copied into shared memory (WIN) where the layout
// fits, else read from global memory where a gather needs them. The
// library is built without fused multiply-adds, so every product and sum
// rounds as PyTorch's kernels do, operation by operation.
//
// Bound on this card: bytes -- the geometry rows dominate (2 214 a cell for
// Q2 hexahedra, read once a cell); the arithmetic is about 50 k operations
// a cell there. Right before fast: no wgmma or TMA.
//
// The part above "#ifdef __CUDACC__" -- the per-cell computation -- also
// compiles as plain C++ (GEN_HD inline, GEN_TABLE static const), so that
// the tests hold it against the plain version on the host.
#pragma once

// the physics struct's functions and tables: device code and constant
// memory here (a host build of the same physics defines both)
#ifndef GEN_HD
#define GEN_HD __device__ __forceinline__
#endif
#ifndef GEN_TABLE
#define GEN_TABLE __constant__
#endif

// the reduced variables at point q of one state: ``ug`` the cell's dof
// rows (row r at ug[r * us]), ``dq`` the point's dN rows (row v*GD+d at
// dq[(v*GD+d) * gs])
template <typename T, class P>
GEN_HD void gen_mq_reduced(const T* __restrict__ ug, long long us,
                           const T* __restrict__ dq, long long gs, int q,
                           T* __restrict__ a) {
  constexpr int NV = P::NV, C = P::C, GD = P::GD;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int d = 0; d < GD; ++d) {
      T acc = ug[c * us] * dq[d * gs];
#pragma unroll
      for (int v = 1; v < NV; ++v)
        acc = acc + ug[(v * C + c) * us] * dq[(v * GD + d) * gs];
      a[c * GD + d] = acc;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    T acc = T(0);
    bool have = false;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const T w = P::nf(q, v);
      if (w == T(0)) continue;
      const T x = ug[(v * C + c) * us];
      const T t = w == T(1) ? x : x * w;
      acc = have ? acc + t : t;
      have = true;
    }
    a[C * GD + c] = acc;
  }
}

// one cell's element vector (NS = 1: gradient; 2: Hessian-vector product):
// ``ug`` the NS states' dof rows (state s, row r at ug[(s*NV*C + r) * us]),
// ``geom`` the cell's geometry rows (row g at geom[g * gs]), ``cdr`` its
// coefficient rows (row i at cdr[i * cs]); ``ev`` row r at ev[r * es]
template <typename T, class P, int NS>
GEN_HD void gen_mq_cell(const T* __restrict__ ug, long long us,
                        const T* __restrict__ geom, long long gs,
                        const T* __restrict__ cdr, long long cs,
                        T* __restrict__ ev, long long es) {
  constexpr int NV = P::NV, C = P::C, GD = P::GD, NQ = P::NQ;
  constexpr int NG = C * GD, NR = P::NR;
  constexpr int W0 = NQ * NV * GD;  // the first weight row
  constexpr int X0 = W0 + NQ;       // the first quadrature-point row
  static_assert(NR == NG + C, "reduced variables: gradient, then values");
#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    const T* dq = geom + (long long)q * NV * GD * gs;
    T in[P::NIN];
    gen_mq_reduced<T, P>(ug, us, dq, gs, q, in);
    in[NR] = geom[(W0 + q) * gs];
#pragma unroll
    for (int d = 0; d < GD; ++d) {
      if constexpr (P::XR != 0) {
        in[NR + 1 + d] = geom[(X0 + q * GD + d) * gs];
      } else {
        in[NR + 1 + d] = T(0);
      }
    }
    P::coeffs(q, cdr, cs, in + NR + 1 + GD);
    T g[NR];
    if constexpr (NS == 1) {
      P::grad(in, g);
    } else {
      T din[NR];
      gen_mq_reduced<T, P>(ug + (long long)NV * C * us, us, dq, gs, q, din);
      P::jvp(in, din, g);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const T w = P::nf(q, v);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        T e = g[c * GD] * dq[(v * GD) * gs];
#pragma unroll
        for (int d = 1; d < GD; ++d)
          e = e + g[c * GD + d] * dq[(v * GD + d) * gs];
        if (w != T(0)) e = e + (w == T(1) ? g[NG + c] : g[NG + c] * w);
        T* o = ev + (long long)(v * C + c) * es;
        *o = q == 0 ? e : *o + e;
      }
    }
  }
}

#ifdef __CUDACC__

#include "lane_common.cuh"
#include "lane_async.cuh"

// byte offsets of the shared-memory regions, each 16-byte aligned
struct GenMqLayout {
  size_t acc, win, ug, ev, cd, ids, total;
};

__host__ __device__ inline size_t gen_mq_pad16(size_t b) {
  return (b + 15) / 16 * 16;
}

// lb: lane columns of a block; ky: its thread rows (cells of a round); ns:
// states; win: windows staged; wr: window rows; nv, c: vertices and
// components; dc: coefficient rows of a cell
template <typename T>
__host__ __device__ inline GenMqLayout gen_mq_layout(int lb, int ky, int ns,
                                                     bool win, int wr, int nv,
                                                     int c, int dc) {
  GenMqLayout L;
  const size_t nt = (size_t)lb * ky;
  size_t o = 0;
  L.acc = o;  // (C, wr, lb)
  o += gen_mq_pad16((size_t)c * wr * lb * sizeof(T));
  L.win = o;  // (ns, C, wr, lb) or nothing
  o += win ? gen_mq_pad16((size_t)ns * c * wr * lb * sizeof(T)) : 0;
  L.ug = o;  // (ns, NV * C, threads)
  o += gen_mq_pad16((size_t)ns * nv * c * nt * sizeof(T));
  L.ev = o;  // (NV * C, threads)
  o += gen_mq_pad16((size_t)nv * c * nt * sizeof(T));
  L.cd = o;  // (DC, threads)
  o += gen_mq_pad16((size_t)dc * nt * sizeof(T));
  L.ids = o;  // (NV, threads) window rows, -1 for none
  o += gen_mq_pad16((size_t)nv * nt * sizeof(short));
  L.total = o;
  return L;
}

// NS: states (1 grad, 2 jvp); LB: lane columns of the block; KY: its
// thread rows, the cells of a round; WIN: the state windows staged in
// shared memory
template <typename T, typename I, class P, int NS, int LB, int KY, bool WIN>
__global__ void __launch_bounds__(LB * KY) lane_fused_gen_mq_kernel(
    const T* __restrict__ u, const T* __restrict__ vdir,
    const int32_t* __restrict__ starts, const I* __restrict__ idx,
    const T* __restrict__ geom, const T* __restrict__ cd,
    T* __restrict__ out, int R, int nT, int K, int wr) {
  constexpr int NV = P::NV, C = P::C, DG = P::DG, DC = P::DC;
  constexpr int NT = LB * KY;
  static_assert((KY & (KY - 1)) == 0, "KY must be a power of two");
  static_assert(!WIN || (LB * sizeof(T)) % 16 == 0,
                "a staged window row is whole 16-byte chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GenMqLayout L = gen_mq_layout<T>(LB, KY, NS, WIN, wr, NV, C, DC);
  T* acc = reinterpret_cast<T*>(smem_raw + L.acc);
  T* win = reinterpret_cast<T*>(smem_raw + L.win);
  T* ugs = reinterpret_cast<T*>(smem_raw + L.ug);
  T* evs = reinterpret_cast<T*>(smem_raw + L.ev);
  T* cds = reinterpret_cast<T*>(smem_raw + L.cd);
  short* ids = reinterpret_cast<short*>(smem_raw + L.ids);
  const int j = threadIdx.x;
  const int ky = threadIdx.y;
  const int tid = ky * LB + j;
  const int t = blockIdx.x;
  const int j0 = blockIdx.y * LB;
  const int col = j0 + j;
  const long long R_ = R;
  const long long start = starts[t];
  const long long gs = (long long)K * LANES;  // between rows of one cell

  for (int q = tid; q < C * wr * LB; q += NT) acc[q] = T(0);
  if constexpr (WIN) {
    // the bin's state windows, columns [j0, j0 + LB)
    constexpr int cpr = (int)(LB * sizeof(T) / 16);
#pragma unroll
    for (int sc = 0; sc < NS * C; ++sc) {  // state-major, then channel
      const T* state = sc < C ? u : vdir;
      const long long c = sc % C;
      for (int q = tid; q < wr * cpr; q += NT) {
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
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  const int rounds = (K + KY - 1) / KY;
  for (int rd = 0; rd < rounds; ++rd) {
    const int k = rd * KY + ky;
    bool live = false;
    if (k < K) {
      const I* ip = idx + ((long long)t * NV * K + k) * LANES + col;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int iv = (int)ip[v * gs];
        const bool ok = iv >= 0 && iv < wr;
        ids[v * NT + tid] = (short)(ok ? iv : -1);
        live = live || ok;
      }
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v) ids[v * NT + tid] = -1;
    }
    if (live) {
      // the cell's dofs of each state, then its coefficient rows
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const T* state = s == 0 ? u : vdir;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int iv = ids[v * NT + tid];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            T x = T(0);
            if (iv >= 0) {
              if constexpr (WIN) {
                x = win[(((size_t)s * C + c) * wr + iv) * LB + j];
              } else {
                long long row = start + iv;
                row = row < R_ - 1 ? row : R_ - 1;
                x = state[(c * R_ + row) * LANES + col];
              }
            }
            ugs[((s * NV + v) * C + c) * NT + tid] = x;
          }
        }
      }
      if constexpr (DC > 0) {
        const T* cp = cd + ((long long)t * DC * K + k) * LANES + col;
#pragma unroll
        for (int r = 0; r < DC; ++r) cds[r * NT + tid] = cp[r * gs];
      }
      gen_mq_cell<T, P, NS>(
          ugs + tid, NT, geom + ((long long)t * DG * K + k) * LANES + col, gs,
          cds + tid, NT, evs + tid, NT);
    }
    __syncthreads();
    // the round's cells in cell order, vertex inner, each add into the
    // addresses this thread owns
#pragma unroll 1
    for (int kk = 0; kk < KY; ++kk) {
      const int other = kk * LB + j;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int r = ids[v * NT + other];
        if (r < 0) continue;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int q = c * wr + r;
          if ((q & (KY - 1)) == ky)
            acc[q * LB + j] += evs[(v * C + c) * NT + other];
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int q = tid; q < wr * LB; q += NT) {
      const int r = q / LB;
      const int jj = q - r * LB;
      out[(((long long)c * nT + t) * wr + r) * LANES + j0 + jj] =
          acc[c * wr * LB + q];
    }
  }
}

template <typename T, typename I, class P, int NS, int LB, int KY, bool WIN>
static int lane_fused_gen_mq_launch_impl(const void* u, const void* v,
                                         const void* starts, const void* idx,
                                         const void* geom, const void* cd,
                                         void* out, int R, int nT, int K,
                                         int wr, long long smem,
                                         cudaStream_t stream) {
  if (nT <= 0 || K <= 0) return 0;
  if (wr <= 0 || wr > 32767 || (NS == 2 && v == nullptr) ||
      (P::DC > 0 && cd == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem != gen_mq_layout<T>(LB, KY, NS, WIN, wr, P::NV, P::C,
                                       P::DC).total)
    return (int)cudaErrorInvalidValue;
  auto kern = lane_fused_gen_mq_kernel<T, I, P, NS, LB, KY, WIN>;
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
// struct, index type and the block layout of that state count -- the C
// interface of lane_fused_gen.cuh's units
#define LANE_FUSED_GEN_MQ_ENTRY(P, I, NS, LB, KY, WIN)                       \
  extern "C" int lane_fused_gen_launch##NS(                                 \
      const void* u, const void* v, const void* starts, const void* idx,   \
      const void* geom, const void* cd, void* out, int R, int nT, int K,    \
      int wr, long long smem, void* stream) {                               \
    return lane_fused_gen_mq_launch_impl<P::GT, I, P, NS, LB, KY, WIN>(     \
        u, v, starts, idx, geom, cd, out, R, nT, K, wr, smem,              \
        (cudaStream_t)stream);                                              \
  }

#endif  // __CUDACC__
