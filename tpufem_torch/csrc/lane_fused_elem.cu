// lane_fused_elem -- fused gather -> P1 element physics -> bin scatter.
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_fused_elem for the
// P1 triangle with two displacement components (C = 2, nv = 3):
//   ug[v*C+c, k, j] = u[c, starts[t] + idx[t,v,k,j], j]        (0 for idx = -1)
//   ev = element gradient (one state) or Hessian-vector product (u, v)
//   out[t, c, r, j] = sum over (k, v) with idx[t,v,k,j] == r of ev[v*C+c, k, j]
// u, v (2, R, 128); starts (T,) int32; idx (T, 3, K, 128) in [-1, wr);
// geom (T, 7, K, 128): rows dN[v][d] at v*2+d, then the quadrature weight;
// cd (T, Dc, K, 128): coefficient rows (damage, modulus) or absent.
// The output is stored channel-leading, out[c][t][r][j]; the wrapper hands
// it out as the (T, C, wr, 128) view of the contract, so the transpose
// the engine needs before the owner-sum kernel is a view, not a copy.
//
// On the TPU the element function is the AD graph of the integrand traced
// into the kernel. Here the physics is written by hand, law by law:
// strain from the geometry rows, the stress of the asymmetric
// elasto-damage law (and its directional derivative) exactly as
// tpufem_torch/forms/potentials.py:asym_damage_stress_components (and
// ..._jvp_components) spell them, operation by operation, or isotropic
// linear elasticity. The library is built without fused multiply-adds, so
// the plain PyTorch version rounds the same way.
//
// Bound on this card: bytes. Per cell slot 3 index bytes, 7 geometry and
// Dc coefficient values are read once; the state windows (2 * wr rows per
// bin and state) and the output are small beside them. About 150 flops
// per cell are far below the card's arithmetic rate.
//
// Design: the 128 lane columns never mix, so thread x = lane column j: its
// index bytes, geometry and coefficient reads are coalesced along j, the
// gathered dofs are direct loads that fall into a few rows of one wr-row
// window (L1/L2 hits), and the 6 (12) dofs, 7 geometry and the
// coefficient values live in registers -- neither the gathered dofs nor
// the element vectors touch global memory.
//
// What is hard is the scatter: contributions to one (channel, row, column)
// must be added in a fixed order for the sum to be reproducible, and a
// column processed by ONE thread, cell after cell, leaves the card with
// 16 warps per SM, each a chain of dependent loads (0.115 / 0.225 ms for
// gradient / Hessian-vector product at 2.1 M cells in float32 on an H100,
// against 0.094 / 0.111 ms for this design). So a block has FUSED_KY
// thread rows, and a round handles FUSED_KY cells of the bin at once:
// every thread computes the
// element vectors of its cell and stages them (6 values and 3 window
// rows) in shared memory; after one barrier the threads of column j add
// the staged cells, in cell order and vertex-inner, into the (2, wr, 128)
// accumulator in shared memory -- each thread into its own disjoint set
// of accumulator addresses (one channel and every (KY/2)-th row), so every
// address still sees its contributions in the order cell k ascending,
// vertex v inner. No atomics, and the result does not depend on FUSED_KY:
// it is bit-equal to the plain version. All shared addresses are
// (...)*128 + j: bank j mod 32, conflict-free. The staging area is
// double-buffered, which leaves one barrier per round. One block per bin.
#include "lane_common.cuh"
#include "asym_damage.cuh"

#define FUSED_NV 3
#define FUSED_C 2
#define FUSED_DG 7
// cells of a bin in flight per block (thread rows)
#define FUSED_KY 4

// where a per-cell scalar (damage, modulus) comes from: n > 0 rows of the
// coefficient block starting at row off (averaged), else the constant
struct CellScalar {
  int off;
  int n;
  double constant;
};

template <typename T>
__device__ __forceinline__ T cell_scalar(const CellScalar s,
                                         const T* __restrict__ cd,
                                         long long cell, long long row) {
  if (s.n <= 0) return (T)s.constant;
  T acc = cd[(long long)s.off * row + cell];
  for (int i = 1; i < s.n; ++i)
    acc = acc + cd[(long long)(s.off + i) * row + cell];
  return s.n == 1 ? acc : acc * (T)(1.0 / (double)s.n);
}

template <typename T>
__device__ __forceinline__ void linear_stress(T t11, T t22, T t12, T lam,
                                              T mu, T& s11, T& s22, T& s12) {
  const T vol = lam * (t11 + t22);
  s11 = vol + T(2) * mu * t11;
  s22 = vol + T(2) * mu * t22;
  s12 = T(2) * mu * t12;
}

// gathered dofs of one state -> strain components
template <typename T>
__device__ __forceinline__ void cell_strain(
    const T* __restrict__ vals, long long R, long long start, const int* i,
    const bool* ok, int j, const T (*dN)[2], T& e11, T& e22, T& e12) {
  T ug[FUSED_NV][FUSED_C];
#pragma unroll
  for (int v = 0; v < FUSED_NV; ++v) {
#pragma unroll
    for (int c = 0; c < FUSED_C; ++c) {
      ug[v][c] = ok[v] ? vals[((long long)c * R + start + i[v]) * LANES + j]
                       : T(0);
    }
  }
  T g[FUSED_C][2];
#pragma unroll
  for (int c = 0; c < FUSED_C; ++c) {
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      g[c][dd] = ug[0][c] * dN[0][dd] + ug[1][c] * dN[1][dd] +
                 ug[2][c] * dN[2][dd];
    }
  }
  e11 = g[0][0];
  e22 = g[1][1];
  e12 = T(0.5) * (g[0][1] + g[1][0]);
}

// LAW: 0 linear elasticity, 1 asymmetric elasto-damage; NS: states (1 grad, 2 jvp)
template <typename T, typename I, int LAW, int NS>
__global__ void __launch_bounds__(LANES * FUSED_KY) lane_fused_elem_kernel(
    const T* __restrict__ u, const T* __restrict__ vdir,
    const int32_t* __restrict__ starts, const I* __restrict__ idx,
    const T* __restrict__ geom, const T* __restrict__ cd,
    T* __restrict__ out, int R, int nT, int K, int wr, int Dc,
    CellScalar dsrc, CellScalar esrc, T klam, T kmu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);       // (C, wr, LANES)
  T* evs = acc + FUSED_C * wr * LANES;           // (2, KY, NV*C, LANES)
  int* ids = reinterpret_cast<int*>(             // (2, KY, NV, LANES)
      evs + 2 * FUSED_KY * FUSED_NV * FUSED_C * LANES);
  const int j = threadIdx.x;
  const int ky = threadIdx.y;
  const int t = blockIdx.x;
  for (int r = ky; r < FUSED_C * wr; r += FUSED_KY) acc[r * LANES + j] = T(0);
  // the accumulator addresses this thread adds into: one channel and, of
  // its rows, every (KY/2)-th -- addresses of different threads are disjoint
  const int c_lo = FUSED_KY == 1 ? 0 : (ky & 1);
  const int c_hi = FUSED_KY == 1 ? FUSED_C : c_lo + 1;
  const int r_div = FUSED_KY <= 2 ? 1 : FUSED_KY / 2;
  const int r_sel = ky / 2;
  const long long start = starts[t];
  const long long row = (long long)K * LANES;  // stride between cell-data rows
  const I* ip = idx + (long long)t * FUSED_NV * row + j;
  const T* gp = geom + (long long)t * FUSED_DG * row + j;
  const T* cp = cd == nullptr ? nullptr : cd + (long long)t * Dc * row + j;
  const int rounds = (K + FUSED_KY - 1) / FUSED_KY;
  for (int round = 0; round < rounds; ++round) {
    const int k = round * FUSED_KY + ky;
    const int buf = round & 1;
    T* ev_mine = evs + ((buf * FUSED_KY + ky) * FUSED_NV * FUSED_C) * LANES + j;
    int* id_mine = ids + ((buf * FUSED_KY + ky) * FUSED_NV) * LANES + j;
    if (k < K) {
      const long long ko = (long long)k * LANES;
      int i[FUSED_NV];
      bool ok[FUSED_NV];
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) {
        i[v] = (int)ip[v * row + ko];
        ok[v] = (i[v] >= 0) && (i[v] < wr);
      }
      T dN[FUSED_NV][2];
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) {
        dN[v][0] = gp[(v * 2) * row + ko];
        dN[v][1] = gp[(v * 2 + 1) * row + ko];
      }
      const T w = gp[6 * row + ko];
      const T E = cell_scalar<T>(esrc, cp, ko, row);
      const T lam = E * klam;
      const T mu = E * kmu;

      T e11, e22, e12, s11, s22, s12;
      cell_strain<T>(u, R, start, i, ok, j, dN, e11, e22, e12);
      if (NS == 2) {
        T t11, t22, t12;
        cell_strain<T>(vdir, R, start, i, ok, j, dN, t11, t22, t12);
        if (LAW == 1) {
          const T d = cell_scalar<T>(dsrc, cp, ko, row);
          asym_stress_jvp<T>(e11, e22, e12, t11, t22, t12, d, lam, mu, s11,
                             s22, s12);
        } else {
          linear_stress<T>(t11, t22, t12, lam, mu, s11, s22, s12);
        }
      } else if (LAW == 1) {
        const T d = cell_scalar<T>(dsrc, cp, ko, row);
        asym_stress<T>(e11, e22, e12, d, lam, mu, s11, s22, s12);
      } else {
        linear_stress<T>(e11, e22, e12, lam, mu, s11, s22, s12);
      }
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) {
        id_mine[v * LANES] = ok[v] ? i[v] : -1;
        ev_mine[(v * 2) * LANES] = w * (s11 * dN[v][0] + s12 * dN[v][1]);
        ev_mine[(v * 2 + 1) * LANES] = w * (s12 * dN[v][0] + s22 * dN[v][1]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) id_mine[v * LANES] = -1;
    }
    // one barrier per round: the staging area is double-buffered, so a
    // thread that runs ahead writes the other buffer
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FUSED_KY; ++kk) {
      const T* ev_k = evs + ((buf * FUSED_KY + kk) * FUSED_NV * FUSED_C) * LANES + j;
      const int* id_k = ids + ((buf * FUSED_KY + kk) * FUSED_NV) * LANES + j;
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) {
        const int r = id_k[v * LANES];
        if (r >= 0 && (r % r_div) == r_sel) {
          for (int c = c_lo; c < c_hi; ++c)
            acc[(c * wr + r) * LANES + j] += ev_k[(v * 2 + c) * LANES];
        }
      }
    }
  }
  __syncthreads();
  for (int rr = ky; rr < FUSED_C * wr; rr += FUSED_KY) {
    const int c = rr / wr;
    const int r = rr - c * wr;
    out[(((long long)c * nT + t) * wr + r) * LANES + j] = acc[rr * LANES + j];
  }
}

template <typename T, typename I, int LAW, int NS>
static int launch_fused(const void* u, const void* v, const void* starts,
                        const void* idx, const void* geom, const void* cd,
                        void* out, int R, int nT, int K, int wr, int Dc,
                        CellScalar dsrc, CellScalar esrc, double klam,
                        double kmu, cudaStream_t stream) {
  const size_t smem =
      ((size_t)FUSED_C * wr + 2 * FUSED_KY * FUSED_NV * FUSED_C) * LANES *
          sizeof(T) +
      (size_t)2 * FUSED_KY * FUSED_NV * LANES * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lane_fused_elem_kernel<T, I, LAW, NS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 block(LANES, FUSED_KY);
  lane_fused_elem_kernel<T, I, LAW, NS><<<nT, block, smem, stream>>>(
      (const T*)u, (const T*)v, (const int32_t*)starts, (const I*)idx,
      (const T*)geom, (const T*)cd, (T*)out, R, nT, K, wr, Dc, dsrc, esrc,
      (T)klam, (T)kmu);
  return (int)cudaGetLastError();
}

// law: 0 linear elasticity, 1 asymmetric elasto-damage. n_states: 1 (u) or
// 2 (u, v). cd may be null when no coefficient row is read. d_* / e_*:
// where damage and modulus come from (see CellScalar). klam, kmu: the Lame
// factors of the Poisson ratio, lam = E * klam, mu = E * kmu.
extern "C" int lane_fused_elem(
    int vt, int it, int law, int n_states, const void* u, const void* v,
    const void* starts, const void* idx, const void* geom, const void* cd,
    void* out, int R, int nT, int K, int wr, int Dc, int d_off, int d_n,
    double d_const, int e_off, int e_n, double e_const, double klam,
    double kmu, void* stream) {
  if (nT <= 0 || K <= 0) return 0;
  if ((law != 0 && law != 1) || (n_states != 1 && n_states != 2))
    return (int)cudaErrorInvalidValue;
  if ((d_n > 0 || e_n > 0) && cd == nullptr) return (int)cudaErrorInvalidValue;
  if (d_n > 0 && (d_off < 0 || d_off + d_n > Dc)) return (int)cudaErrorInvalidValue;
  if (e_n > 0 && (e_off < 0 || e_off + e_n > Dc)) return (int)cudaErrorInvalidValue;
  const CellScalar dsrc = {d_off, d_n, d_const};
  const CellScalar esrc = {e_off, e_n, e_const};
#define ARGS                                                            \
  u, v, starts, idx, geom, cd, out, R, nT, K, wr, Dc, dsrc, esrc, klam, \
      kmu, (cudaStream_t)stream
#define CALL(T, I)                                                     \
  do {                                                                 \
    if (law == 1 && n_states == 1) return launch_fused<T, I, 1, 1>(ARGS); \
    if (law == 1) return launch_fused<T, I, 1, 2>(ARGS);               \
    if (n_states == 1) return launch_fused<T, I, 0, 1>(ARGS);          \
    return launch_fused<T, I, 0, 2>(ARGS);                             \
  } while (0)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
