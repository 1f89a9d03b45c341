// lane_pass_update -- all owner-sum (or copy-refresh) passes plus the
// bin-block update, in one launch.
//
// Replaces the TPU kernel tpufem/lane/kernels.py:356 (lane_pass_update):
//   acc[c,k,j] = sum over passes p of
//                values[c, starts[p,t] + idx[p,t,k,j], (j - shifts[p]) mod 128]
//                (0 where idx = -1 or outside [0, wrs[p]))
//   head = 1 (owner-sum): rows [0, K) of every wg-row bin block get base + acc,
//                         the other rows are copied;
//   head = 0 (refresh):   rows [wg-K, wg) are SET to acc (zeros included),
//                         the other rows are copied.
// values (C, T*wg, 128); starts (P, T) int32; idx (P, T, K, 128);
// out (C, T, wg, 128) is a NEW buffer: neighbouring bins read rows that
// this kernel writes, so it cannot work in place.
//
// Bound on this card: bytes -- the state is read once and written once,
// plus the index table (57 MB, 0.017 ms at the n = 1024 plan's owner-sum).
//
// What held the first design back, at 3.3x its bound: its grid was
// (bin, channel), so every channel read the whole index table again; and
// each thread walked the passes one after another, an index load and
// then the value load that depends on it, one gather in flight at a time
// -- it waited on latency, not on bandwidth.
//
// This design, for the copy-refresh: one block per bin (and per group of
// 32 updated rows) serves two channels (grid z walks channel pairs: one
// for the engine's C = 2), so each index byte is read once per pair. The
// bin's work is a list of units, one per pass (or per tile of a pass whose
// window is taller than a ring stage holds): the unit's index rows and
// its window rows of the block's channels are copied into a ring of
// PASS_STAGES shared-memory stages by 16-byte cp.async, PASS_STAGES - 1
// units ahead of the one being summed, so the copies of later passes
// overlap the sums of earlier ones. The gather then reads shared memory:
// thread j reads column (j - shift) mod 128 of a staged row, the 32
// threads of a warp in 32 different banks. Each thread keeps its rows'
// sums in registers, pass after pass in pass order from zero -- the plain
// version's order, so the result is bit for bit the plain version's. The
// rows that are only copied move as 16-byte vectors. A window row past the
// last row of the state is staged as that last row, as the plain version
// clamps it. The unit list and the tile height come from the wrapper
// (tpufem_torch/lane/kernels.py:pass_update_geometry); this file checks
// that its shared-memory size is the one the wrapper computed.
//
// The owner-sum keeps the first design (lane_owner_sum_kernel), now with
// the clamp: on the H100 at the n = 1024 plan it ran 6 % faster than the
// staged ring in the same call, where the refresh ran 15 % faster staged
// (PERF.md, Findings). Also measured there and slower for both modes: a
// deeper ring (5 stages), staging only the 16-byte chunks the valid
// entries read (the tables are about one tenth valid), the index rows
// staged with the gathers made direct from global memory, and blocks of
// 16 updated rows held to 3 per SM.
#include "lane_common.cuh"
#include "lane_async.cuh"

#define PASS_MAX 64
#define PASS_MAX_UNITS 256
#define PASS_KY 4                        // thread rows of a block
#define PASS_RPT 8                       // updated rows per thread row
#define PASS_ROWS (PASS_KY * PASS_RPT)   // updated rows per block
#define PASS_CB 2                        // channels per block
#define PASS_STAGES 3                    // ring depth, in units

struct PassPlan {
  int n_units;
  short unit_pass[PASS_MAX_UNITS];  // pass of the unit
  short unit_row0[PASS_MAX_UNITS];  // first window row of the unit's tile
  short unit_rows[PASS_MAX_UNITS];  // window rows in the tile
  short shift[PASS_MAX];            // lane shift, reduced to [0, 128)
  short wr[PASS_MAX];               // window rows of the pass
};

// a ring stage: the index rows of a group, then cb x wt window rows
template <typename T, typename I>
__host__ __device__ inline size_t pass_stage_bytes(int C, int K, int wt) {
  const int rows = K < PASS_ROWS ? K : PASS_ROWS;
  const int cb = C < PASS_CB ? C : PASS_CB;
  return (size_t)rows * LANES * sizeof(I) + (size_t)cb * wt * LANES * sizeof(T);
}

template <typename T, typename I>
__global__ void __launch_bounds__(LANES * PASS_KY) lane_pass_update_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ starts,
    const I* __restrict__ idx, T* __restrict__ out, PassPlan plan, int C,
    int nT, int P, int K, int wg, int head, int wt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_start[PASS_MAX];
  constexpr int CPR = (int)(LANES * sizeof(T) / 16);  // 16-byte chunks a row
  const int j = threadIdx.x;
  const int ky = threadIdx.y;
  const int tid = ky * LANES + j;
  const int nthr = LANES * PASS_KY;
  const int t = blockIdx.x;
  const int kg0 = blockIdx.y * PASS_ROWS;  // first updated row of the group
  const int kb = min(K - kg0, PASS_ROWS);  // updated rows of the group
  const int c0 = blockIdx.z * PASS_CB;     // the block's channels
  const int cb = min(C - c0, PASS_CB);
  const long long R = (long long)nT * wg;
  const long long bin0 = (long long)t * wg;  // first row of the bin
  const int row0 = head ? 0 : wg - K;        // rows [row0, row0 + K) get acc
  const size_t idx_bytes =
      (size_t)(K < PASS_ROWS ? K : PASS_ROWS) * LANES * sizeof(I);
  const size_t stage_bytes = pass_stage_bytes<T, I>(C, K, wt);

  for (int p = tid; p < P; p += nthr) s_start[p] = starts[p * nT + t];
  __syncthreads();

  // stage unit u: its pass's index rows of this group, then its window
  // rows for each of the block's channels (128 columns each); a window row
  // past the last state row is staged as that row (the plain version
  // clamps it)
  auto issue = [&](int u, int stage) {
    unsigned char* sbase = smem_raw + (size_t)stage * stage_bytes;
    const int p = plan.unit_pass[u];
    const int n = plan.unit_rows[u];
    const unsigned char* gidx = reinterpret_cast<const unsigned char*>(
        idx + (((long long)p * nT + t) * K + kg0) * LANES);
    const int idx_chunks = (int)((size_t)kb * LANES * sizeof(I) / 16);
    for (int q = tid; q < idx_chunks; q += nthr)
      cp_async16(sbase + (size_t)q * 16, gidx + (size_t)q * 16);
    unsigned char* swin = sbase + idx_bytes;
    const long long wrow0 = (long long)s_start[p] + plan.unit_row0[u];
    for (int c = 0; c < cb; ++c) {
      for (int q = tid; q < n * CPR; q += nthr) {
        const int r = q / CPR;
        const int ch = q - r * CPR;
        long long srow = wrow0 + r;
        srow = srow < R - 1 ? srow : R - 1;
        cp_async16(swin + (((size_t)c * wt + r) * LANES) * sizeof(T) + ch * 16,
                   reinterpret_cast<const unsigned char*>(
                       values + ((long long)(c0 + c) * R + srow) * LANES) +
                       ch * 16);
      }
    }
  };

  const int U = plan.n_units;
#pragma unroll
  for (int s = 0; s < PASS_STAGES - 1; ++s) {
    if (s < U) issue(s, s);
    cp_async_commit();
  }

  // the rows that are only copied (group 0 of the bin), 16 bytes a thread
  if (blockIdx.y == 0) {
    for (int c = c0; c < c0 + cb; ++c) {
      for (int q = tid; q < (wg - K) * CPR; q += nthr) {
        const int rr = q / CPR;
        const int v = q - rr * CPR;
        const int row = rr < row0 ? rr : rr + K;
        const long long o = ((long long)c * R + bin0 + row) * LANES;
        reinterpret_cast<uint4*>(out + o)[v] =
            reinterpret_cast<const uint4*>(values + o)[v];
      }
    }
  }

  T acc[PASS_CB][PASS_RPT];
#pragma unroll
  for (int c = 0; c < PASS_CB; ++c)
#pragma unroll
    for (int q = 0; q < PASS_RPT; ++q) acc[c][q] = T(0);

  for (int u = 0; u < U; ++u) {
    // unit u has landed (this thread's copies); the barrier makes every
    // thread's copies visible and retires the stage that unit u - 1 used
    cp_async_wait<PASS_STAGES - 2>();
    __syncthreads();
    if (u + PASS_STAGES - 1 < U)
      issue(u + PASS_STAGES - 1, (u + PASS_STAGES - 1) % PASS_STAGES);
    cp_async_commit();
    const unsigned char* sbase =
        smem_raw + (size_t)(u % PASS_STAGES) * stage_bytes;
    const I* sidx = reinterpret_cast<const I*>(sbase);
    const T* swin = reinterpret_cast<const T*>(sbase + idx_bytes);
    const int a = plan.unit_row0[u];
    const int n = plan.unit_rows[u];
    const int col = (j - plan.shift[plan.unit_pass[u]]) & (LANES - 1);
#pragma unroll
    for (int q = 0; q < PASS_RPT; ++q) {
      const int k = ky + PASS_KY * q;
      if (k < kb) {
        const int i = (int)sidx[k * LANES + j] - a;
        if (i >= 0 && i < n) {
#pragma unroll
          for (int c = 0; c < PASS_CB; ++c)
            if (c < cb) acc[c][q] += swin[((size_t)c * wt + i) * LANES + col];
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int q = 0; q < PASS_RPT; ++q) {
    const int k = ky + PASS_KY * q;
    if (k < kb) {
      const long long row = bin0 + row0 + kg0 + k;
#pragma unroll
      for (int c = 0; c < PASS_CB; ++c) {
        if (c < cb) {
          const long long o = ((long long)(c0 + c) * R + row) * LANES + j;
          out[o] = head ? values[o] + acc[c][q] : acc[c][q];
        }
      }
    }
  }
}

// Owner-sum (head = 1) keeps the first design, measured faster than the
// staged ring for it on the card: grid (bin, channel), thread j = lane
// column j, PASS_KY thread rows walk the bin's rows, and each updated row
// sums its passes in pass order straight from global memory.
// (No launch bounds: with them ptxas trades registers for occupancy and
// spills; rows are int -- R = T * wg rows fit.)
template <typename T, typename I>
__global__ void lane_owner_sum_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ starts,
    const I* __restrict__ idx, T* __restrict__ out, PassPlan plan, int nT,
    int P, int K, int wg) {
  const int j = threadIdx.x;
  const int t = blockIdx.x;
  const int R = nT * wg;
  const T* vc = values + (long long)blockIdx.y * R * LANES;
  T* oc = out + (long long)blockIdx.y * R * LANES;
  for (int row = threadIdx.y; row < wg; row += PASS_KY) {
    const long long o = ((long long)t * wg + row) * LANES + j;
    T res = vc[o];
    if (row < K) {
      T acc = T(0);
      for (int p = 0; p < P; ++p) {
        const int i = (int)idx[(((long long)p * nT + t) * K + row) * LANES + j];
        if (i >= 0 && i < plan.wr[p]) {
          const int srow = min(starts[p * nT + t] + i, R - 1);
          acc += vc[(long long)srow * LANES +
                    ((j - plan.shift[p]) & (LANES - 1))];
        }
      }
      res = res + acc;
    }
    oc[o] = res;
  }
}

template <typename T, typename I>
static int launch_owner_sum(const void* values, const void* starts,
                            const void* idx, void* out, const PassPlan& plan,
                            int C, int nT, int P, int K, int wg,
                            cudaStream_t stream) {
  auto kern = lane_owner_sum_kernel<T, I>;
  dim3 grid(nT, C);
  dim3 block(LANES, PASS_KY);
  kern<<<grid, block, 0, stream>>>(
      (const T*)values, (const int32_t*)starts, (const I*)idx, (T*)out, plan,
      nT, P, K, wg);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
static int launch_pass(const void* values, const void* starts,
                       const void* idx, void* out, const PassPlan& plan,
                       int C, int nT, int P, int K, int wg, int head, int wt,
                       size_t smem, cudaStream_t stream) {
  if (smem != PASS_STAGES * pass_stage_bytes<T, I>(C, K, wt))
    return (int)cudaErrorInvalidValue;
  auto kern = lane_pass_update_kernel<T, I>;
  static size_t opted_in = 48 * 1024;  // per instance: no call per launch
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  dim3 block(LANES, PASS_KY);
  dim3 grid(nT, (K + PASS_ROWS - 1) / PASS_ROWS, (C + PASS_CB - 1) / PASS_CB);
  kern<<<grid, block, smem, stream>>>(
      (const T*)values, (const int32_t*)starts, (const I*)idx, (T*)out, plan,
      C, nT, P, K, wg, head, wt);
  return (int)cudaGetLastError();
}

// units: n_units (pass, first window row, rows) triples in pass order, the
// tiles of each pass's window [0, wrs[p]); wt: the tallest tile; smem: the
// dynamic shared memory the wrapper computed for this geometry.
extern "C" int lane_pass_update(
    int vt, int it, const void* values, const void* starts, const void* idx,
    void* out, const int* shifts, const int* units, int n_units, int wt,
    long long smem, int C, int nT, int P, int K, int wg, int head,
    void* stream) {
  if (nT <= 0 || C <= 0) return 0;
  if (P > PASS_MAX || K > wg || K <= 0 || n_units > PASS_MAX_UNITS ||
      n_units < 0 || wt <= 0)
    return (int)cudaErrorInvalidValue;
  PassPlan plan;
  plan.n_units = n_units;
  for (int p = 0; p < P; ++p) {
    plan.shift[p] = (short)(((shifts[p] % LANES) + LANES) % LANES);
    plan.wr[p] = 0;
  }
  for (int u = 0; u < n_units; ++u) {
    const int p = units[3 * u], a = units[3 * u + 1], n = units[3 * u + 2];
    if (p < 0 || p >= P || a < 0 || n <= 0 || n > wt || a + n > 32767)
      return (int)cudaErrorInvalidValue;
    plan.unit_pass[u] = (short)p;
    plan.unit_row0[u] = (short)a;
    plan.unit_rows[u] = (short)n;
    plan.wr[p] = (short)(plan.wr[p] + n);
  }
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL(T, I)                                                         \
  do {                                                                       \
    if (head)                                                                \
      return launch_owner_sum<T, I>(values, starts, idx, out, plan, C, nT, P, \
                                    K, wg, s);                               \
    return launch_pass<T, I>(values, starts, idx, out, plan, C, nT, P, K, wg, \
                             head, wt, (size_t)smem, s);                     \
  } while (0)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return (int)cudaErrorInvalidValue;
}
