// lane_fused_elem -- fused gather -> P1 element physics -> bin scatter.
//
// Replaces the TPU kernel tpufem/lane/kernels.py:521 (lane_fused_elem) for
// the P1 triangle with two displacement components (C = 2, nv = 3):
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
// Dc coefficient values are read once, beside the states and the output
// (162 MB for the Hessian-vector product at the n = 1024 plan, 0.048 ms).
// About 150 flops per cell are far below the card's arithmetic rate.
//
// The scatter is what is hard: contributions to one (channel, row, column)
// must be added in a fixed order for the sum to be reproducible. A block
// has KY thread rows, and a round handles KY cells of the bin at once:
// every thread computes the element vectors of its cell and stages them
// (6 values and 3 window rows) in shared memory; after the next barrier
// the threads of column j add the staged cells, in cell order and
// vertex-inner, into the (2, wr, columns) accumulator in shared memory --
// each thread into its own disjoint set of addresses (one channel and
// every (KY/2)-th row), so every address sees its contributions in the
// order cell k ascending, vertex v inner. No atomics: the result is bit
// for bit the plain version's.
//
// What held the previous design back (2.3x its bound): one block of 512
// threads per bin held the whole 128-column accumulator, staging and ids
// (76 KB in float32) at the 64-register cap, so two blocks fitted on an SM
// and some instances spilled; every round paid a full memory latency --
// the cell data of a round was loaded, then the gathers that depend on
// it, with nothing of the next round in flight; a warp's gathers from the
// window touched up to a cache line per thread; and the ordered scatter
// was a chain of dependent shared-memory loads and stores, one staged
// entry after another.
//
// This design: (1) the 128 lane columns never mix, so a block takes LB of
// them (grid (T, 128 / LB)) and needs only LB / 128 of the accumulator,
// the staging and the windows; (2) the bin's state windows (wr rows from
// starts[t], clamped to the last row as the plain version clamps them) are
// copied into shared memory once per block, so every gather reads shared
// memory at column j, bank j mod 32; (3) the cell data of each round
// (index, geometry and coefficient rows of its KY cells, contiguous runs
// of LB columns) streams through a ring of S shared-memory stages by
// 16-byte cp.async, S - 1 rounds ahead, so the loads of later rounds
// overlap the physics and the scatter of earlier ones; one barrier per
// round; (4) the scatter loads all of a round's staged rows and values
// first and then adds, so only the adds are ordered; (5) the copy loops
// divide by compile-time constants only; (6) no register cap. The wrapper
// picks the block layout (LB, KY, S) and computes the shared-memory size
// (tpufem_torch/lane/kernels.py:fused_elem_geometry), and raises where no
// layout fits; this file checks the size against its own layout.
#include "lane_common.cuh"
#include "lane_async.cuh"
#include "asym_damage.cuh"

#define FUSED_NV 3
#define FUSED_C 2
#define FUSED_DG 7

// where a per-cell scalar (damage, modulus) comes from: n > 0 rows of the
// coefficient block starting at row off (averaged), else the constant
struct CellScalar {
  int off;
  int n;
  double constant;
};

// byte offsets of the shared-memory regions, each 16-byte aligned
struct FusedLayout {
  size_t acc, win, rval, ridx, ev, ids, total;
};

__host__ __device__ inline size_t fused_pad16(size_t b) {
  return (b + 15) / 16 * 16;
}

// lb: lane columns of a block; ky: its thread rows (cells of a round);
// stages: ring depth in rounds; ns: states; wr: window rows; dn: staged
// coefficient rows
template <typename T, typename I>
__host__ __device__ inline FusedLayout fused_layout(int lb, int ky,
                                                   int stages, int ns,
                                                   int wr, int dn) {
  FusedLayout L;
  size_t o = 0;
  L.acc = o;   // (C, wr, lb)
  o += fused_pad16((size_t)FUSED_C * wr * lb * sizeof(T));
  L.win = o;   // (ns, C, wr, lb)
  o += fused_pad16((size_t)ns * FUSED_C * wr * lb * sizeof(T));
  L.rval = o;  // (stages, 7 + dn, ky, lb)
  o += fused_pad16((size_t)stages * (FUSED_DG + dn) * ky * lb * sizeof(T));
  L.ridx = o;  // (stages, NV, ky, lb)
  o += fused_pad16((size_t)stages * FUSED_NV * ky * lb * sizeof(I));
  L.ev = o;    // (2, ky, NV * C, lb)
  o += fused_pad16((size_t)2 * ky * FUSED_NV * FUSED_C * lb * sizeof(T));
  L.ids = o;   // (2, ky, NV, lb)
  o += fused_pad16((size_t)2 * ky * FUSED_NV * lb * sizeof(short));
  L.total = o;
  return L;
}

// a per-cell scalar from the staged coefficient rows (row stride rs)
template <typename T>
__device__ __forceinline__ T cell_scalar(const CellScalar s,
                                         const T* __restrict__ rows, int rs) {
  if (s.n <= 0) return (T)s.constant;
  T acc = rows[s.off * rs];
  for (int i = 1; i < s.n; ++i) acc = acc + rows[(s.off + i) * rs];
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

// gathered dofs of one state (its staged window, (C, wr, lb) at column j)
// -> strain components
template <typename T>
__device__ __forceinline__ void cell_strain(const T* __restrict__ win,
                                            int wr, int lb, const int* i,
                                            const bool* ok, const T (*dN)[2],
                                            T& e11, T& e22, T& e12) {
  T ug[FUSED_NV][FUSED_C];
#pragma unroll
  for (int v = 0; v < FUSED_NV; ++v) {
#pragma unroll
    for (int c = 0; c < FUSED_C; ++c)
      ug[v][c] = ok[v] ? win[(c * wr + i[v]) * lb] : T(0);
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

// LAW: 0 linear elasticity, 1 asymmetric elasto-damage; NS: states (1 grad,
// 2 jvp); LB: lane columns of the block; KY: its thread rows, the cells of
// a round; S: ring depth in rounds
template <typename T, typename I, int LAW, int NS, int LB, int KY, int S>
__global__ void __launch_bounds__(LB * KY) lane_fused_elem_kernel(
    const T* __restrict__ u, const T* __restrict__ vdir,
    const int32_t* __restrict__ starts, const I* __restrict__ idx,
    const T* __restrict__ geom, const T* __restrict__ cd,
    T* __restrict__ out, int R, int nT, int K, int wr, int Dc, int dn,
    CellScalar dsrc, CellScalar esrc, T klam, T kmu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FusedLayout L = fused_layout<T, I>(LB, KY, S, NS, wr, dn);
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
  const int nval = FUSED_DG + dn;
  const int rs = KY * LB;  // stride between staged rows of a stage
  const long long R_ = R;

  for (int q = tid; q < FUSED_C * wr * LB; q += nthr) acc[q] = T(0);

  // the bin's state windows, columns [j0, j0 + LB): one copy group
  {
    const long long start = starts[t];
    constexpr int cpr = (int)(LB * sizeof(T) / 16);
#pragma unroll
    for (int sc = 0; sc < NS * FUSED_C; ++sc) {  // state-major, then channel
      const T* state = sc < FUSED_C ? u : vdir;
      const long long c = sc % FUSED_C;
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
    cp_async_commit();
  }

  // the cell data of round rd (cells rd * KY ...) into ring stage `stage`
  auto issue = [&](int rd, int stage) {
    const int k0 = rd * KY;
    constexpr int icpr = (int)(LB * sizeof(I) / 16);
    for (int q = tid; q < FUSED_NV * KY * icpr; q += nthr) {
      const int vk = q / icpr;
      const int ch = q - vk * icpr;
      const int v = vk / KY;
      const int kk = vk - v * KY;
      if (k0 + kk >= K) continue;
      const I* src =
          idx + (((long long)t * FUSED_NV + v) * K + k0 + kk) * LANES + j0;
      cp_async16(reinterpret_cast<unsigned char*>(
                     ridx + (((size_t)stage * FUSED_NV + v) * KY + kk) *
                                LB) + ch * 16,
                 reinterpret_cast<const unsigned char*>(src) + ch * 16);
    }
    constexpr int vcpr = (int)(LB * sizeof(T) / 16);
    for (int q = tid; q < nval * KY * vcpr; q += nthr) {
      const int gk = q / vcpr;
      const int ch = q - gk * vcpr;
      const int g = gk / KY;
      const int kk = gk - g * KY;
      if (k0 + kk >= K) continue;
      const T* src =
          g < FUSED_DG
              ? geom + (((long long)t * FUSED_DG + g) * K + k0 + kk) * LANES + j0
              : cd + (((long long)t * Dc + (g - FUSED_DG)) * K + k0 + kk) *
                         LANES + j0;
      cp_async16(reinterpret_cast<unsigned char*>(
                     rval + (((size_t)stage * nval + g) * KY + kk) * LB) +
                     ch * 16,
                 reinterpret_cast<const unsigned char*>(src) + ch * 16);
    }
  };

  // the accumulator addresses this thread adds into: one channel and, of
  // its rows, every (KY/2)-th -- addresses of different threads are disjoint
  const int c_lo = ky & 1;
  const int r_sel = ky >> 1;
  constexpr int r_div = KY / 2;
  // all the round's staged rows and values first (independent loads),
  // then the adds in cell order, vertex inner
  auto scatter = [&](int rd) {
    const int b = rd & 1;
    int rr[KY][FUSED_NV];
    T ee[KY][FUSED_NV];
#pragma unroll
    for (int kk = 0; kk < KY; ++kk) {
      const short* id_k = ids + ((size_t)(b * KY + kk) * FUSED_NV) * LB + j;
      const T* ev_k =
          evs + ((size_t)(b * KY + kk) * FUSED_NV * FUSED_C) * LB + j;
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) {
        rr[kk][v] = id_k[v * LB];
        ee[kk][v] = ev_k[(v * 2 + c_lo) * LB];
      }
    }
#pragma unroll
    for (int kk = 0; kk < KY; ++kk) {
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) {
        const int r = rr[kk][v];
        if (r >= 0 && (r % r_div) == r_sel)
          acc[(c_lo * wr + r) * LB + j] += ee[kk][v];
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
    if (rd + S - 1 < rounds)
      issue(rd + S - 1, (rd + S - 1) % S);
    cp_async_commit();
    if (rd > 0) scatter(rd - 1);

    const int stage = rd % S;
    const int b = rd & 1;
    const int k = rd * KY + ky;
    T* ev_mine = evs + ((size_t)(b * KY + ky) * FUSED_NV * FUSED_C) * LB + j;
    short* id_mine = ids + ((size_t)(b * KY + ky) * FUSED_NV) * LB + j;
    if (k < K) {
      const I* ri = ridx + ((size_t)stage * FUSED_NV * KY + ky) * LB + j;
      const T* rv = rval + ((size_t)stage * nval * KY + ky) * LB + j;
      int i[FUSED_NV];
      bool ok[FUSED_NV];
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) {
        i[v] = (int)ri[v * rs];
        ok[v] = (i[v] >= 0) && (i[v] < wr);
      }
      T dN[FUSED_NV][2];
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) {
        dN[v][0] = rv[(v * 2) * rs];
        dN[v][1] = rv[(v * 2 + 1) * rs];
      }
      const T w = rv[6 * rs];
      const T* crow = rv + FUSED_DG * rs;
      const T E = cell_scalar<T>(esrc, crow, rs);
      const T lam = E * klam;
      const T mu = E * kmu;

      T e11, e22, e12, s11, s22, s12;
      cell_strain<T>(win + j, wr, LB, i, ok, dN, e11, e22, e12);
      if (NS == 2) {
        T t11, t22, t12;
        cell_strain<T>(win + (size_t)FUSED_C * wr * LB + j, wr, LB, i, ok,
                       dN, t11, t22, t12);
        if (LAW == 1) {
          const T d = cell_scalar<T>(dsrc, crow, rs);
          asym_stress_jvp<T>(e11, e22, e12, t11, t22, t12, d, lam, mu, s11,
                             s22, s12);
        } else {
          linear_stress<T>(t11, t22, t12, lam, mu, s11, s22, s12);
        }
      } else if (LAW == 1) {
        const T d = cell_scalar<T>(dsrc, crow, rs);
        asym_stress<T>(e11, e22, e12, d, lam, mu, s11, s22, s12);
      } else {
        linear_stress<T>(e11, e22, e12, lam, mu, s11, s22, s12);
      }
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) {
        id_mine[v * LB] = (short)(ok[v] ? i[v] : -1);
        ev_mine[(v * 2) * LB] = w * (s11 * dN[v][0] + s12 * dN[v][1]);
        ev_mine[(v * 2 + 1) * LB] = w * (s12 * dN[v][0] + s22 * dN[v][1]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < FUSED_NV; ++v) id_mine[v * LB] = -1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (rounds > 0) scatter(rounds - 1);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < FUSED_C; ++c) {
    for (int q = tid; q < wr * LB; q += nthr) {
      const int r = q / LB;
      const int jj = q - r * LB;
      out[(((long long)c * nT + t) * wr + r) * LANES + j0 + jj] =
          acc[c * wr * LB + q];
    }
  }
}

template <typename T, typename I, int LAW, int NS, int LB, int KY, int S>
static int launch_fused(const void* u, const void* v, const void* starts,
                        const void* idx, const void* geom, const void* cd,
                        void* out, int R, int nT, int K, int wr, int Dc,
                        int dn, CellScalar dsrc, CellScalar esrc, double klam,
                        double kmu, size_t smem, cudaStream_t stream) {
  auto kern = lane_fused_elem_kernel<T, I, LAW, NS, LB, KY, S>;
  static size_t opted_in = 48 * 1024;  // per instance: no call per launch
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 block(LB, KY);
  dim3 grid(nT, LANES / LB);
  kern<<<grid, block, smem, stream>>>(
      (const T*)u, (const T*)v, (const int32_t*)starts, (const I*)idx,
      (const T*)geom, (const T*)cd, (T*)out, R, nT, K, wr, Dc, dn, dsrc,
      esrc, (T)klam, (T)kmu);
  return (int)cudaGetLastError();
}

template <typename T, typename I, int LAW, int NS>
static int launch_lb(int lb, int ky, int stages, const void* u, const void* v, const void* starts,
                     const void* idx, const void* geom, const void* cd,
                     void* out, int R, int nT, int K, int wr, int Dc, int dn,
                     CellScalar dsrc, CellScalar esrc, double klam,
                     double kmu, long long smem, cudaStream_t stream) {
  if ((size_t)smem != fused_layout<T, I>(lb, ky, stages, NS, wr, dn).total)
    return (int)cudaErrorInvalidValue;
#define LB_CALL(LBV, KYV, SV)                                               \
  if (lb == LBV && ky == KYV && stages == SV)                               \
  return launch_fused<T, I, LAW, NS, LBV, KYV, SV>(                         \
      u, v, starts, idx, geom, cd, out, R, nT, K, wr, Dc, dn, dsrc, esrc,   \
      klam, kmu, (size_t)smem, stream)
  LB_CALL(32, 4, 3);
  LB_CALL(16, 4, 3);
#undef LB_CALL
  return (int)cudaErrorInvalidValue;
}

// law: 0 linear elasticity, 1 asymmetric elasto-damage. n_states: 1 (u) or
// 2 (u, v). cd may be null when no coefficient row is read. d_* / e_*:
// where damage and modulus come from (see CellScalar). klam, kmu: the Lame
// factors of the Poisson ratio, lam = E * klam, mu = E * kmu. lb: lane
// columns of a block (16 or 32); dn: coefficient rows staged (those
// the law reads); smem: the dynamic shared memory the wrapper computed.
extern "C" int lane_fused_elem(
    int vt, int it, int law, int n_states, const void* u, const void* v,
    const void* starts, const void* idx, const void* geom, const void* cd,
    void* out, int R, int nT, int K, int wr, int Dc, int d_off, int d_n,
    double d_const, int e_off, int e_n, double e_const, double klam,
    double kmu, int lb, int ky, int stages, int dn, long long smem,
    void* stream) {
  if (nT <= 0 || K <= 0) return 0;
  if ((law != 0 && law != 1) || (n_states != 1 && n_states != 2) || wr <= 0 ||
      wr > 32767)
    return (int)cudaErrorInvalidValue;
  if (dn < 0 || dn > Dc || (dn > 0 && cd == nullptr))
    return (int)cudaErrorInvalidValue;
  if (d_n > 0 && (d_off < 0 || d_off + d_n > dn)) return (int)cudaErrorInvalidValue;
  if (e_n > 0 && (e_off < 0 || e_off + e_n > dn)) return (int)cudaErrorInvalidValue;
  const CellScalar dsrc = {d_off, d_n, d_const};
  const CellScalar esrc = {e_off, e_n, e_const};
#define ARGS                                                                \
  lb, ky, stages, u, v, starts, idx, geom, cd, out, R, nT, K, wr, Dc, dn,   \
      dsrc, esrc,                                                           \
      klam, kmu, smem, (cudaStream_t)stream
#define CALL(T, I)                                                        \
  do {                                                                    \
    if (law == 1 && n_states == 1) return launch_lb<T, I, 1, 1>(ARGS);    \
    if (law == 1) return launch_lb<T, I, 1, 2>(ARGS);                     \
    if (n_states == 1) return launch_lb<T, I, 0, 1>(ARGS);                \
    return launch_lb<T, I, 0, 2>(ARGS);                                   \
  } while (0)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
