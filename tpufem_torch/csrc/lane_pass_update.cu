// lane_pass_update -- all owner-sum (or copy-refresh) passes plus the
// bin-block update, in one launch.
//
// Replaces the TPU kernel tpufem/lane/kernels.py:lane_pass_update:
//   acc[c,k,j] = sum over passes p of
//                values[c, starts[p,t] + idx[p,t,k,j], (j - shifts[p]) mod 128]
//                (0 where idx = -1 or outside [0, wrs[p]))
//   head = 1 (owner-sum): rows [0, K) of every wg-row bin block get base + acc,
//                         the other rows are copied;
//   head = 0 (refresh):   rows [wg-K, wg) are SET to acc (zeros included),
//                         the other rows are copied.
// values (C, T*wg, 128); starts (P, T) int32; idx (P, T, K, 128);
// out (C, T, wg, 128) is a NEW buffer, so every read sees pre-update values.
//
// Bound on this card: bytes -- the whole state is read once and written
// once, plus the index tables; the gathered reads hit rows of nearby bins
// already in L2.
//
// Design: thread x = lane column j, so the base copy, the index reads and
// the output writes are coalesced; the lane shift is just a different
// column of the same 128-wide row (one coalesced segment, rotated), where
// the TPU kernel needs an in-register roll of a staged window. Passes are
// summed in pass order starting from zero, which matches the plain version
// bit for bit. Per-pass shifts and window heights travel by value in the
// kernel arguments (no device table, no allocation).
#include "lane_common.cuh"

#define MAX_PASSES 64
#define PASS_KY 4

struct PassMeta {
  int shift[MAX_PASSES];  // already reduced to [0, 128)
  int wr[MAX_PASSES];
};

template <typename T, typename I>
__global__ void lane_pass_update_kernel(
    const T* __restrict__ values, const int32_t* __restrict__ starts,
    const I* __restrict__ idx, T* __restrict__ out, PassMeta meta,
    int nT, int P, int K, int wg, int head) {
  const int j = threadIdx.x;
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const long long R = (long long)nT * wg;
  const T* vc = values + (long long)c * R * LANES;
  const long long blk = ((long long)c * nT + t) * wg;  // first row of the bin
  const int row0 = head ? 0 : wg - K;  // rows [row0, row0 + K) get acc
  for (int row = threadIdx.y; row < wg; row += PASS_KY) {
    const T base = vc[((long long)t * wg + row) * LANES + j];
    const int k = row - row0;
    T res = base;
    if (k >= 0 && k < K) {
      T acc = T(0);
      for (int p = 0; p < P; ++p) {
        const int i =
            (int)idx[(((long long)p * nT + t) * K + k) * LANES + j];
        if (i >= 0 && i < meta.wr[p]) {
          const long long srow = (long long)starts[p * nT + t] + i;
          const int sl = (j - meta.shift[p] + LANES) & (LANES - 1);
          acc += vc[srow * LANES + sl];
        }
      }
      res = head ? base + acc : acc;
    }
    out[(blk + row) * LANES + j] = res;
  }
}

extern "C" int lane_pass_update(
    int vt, int it, const void* values, const void* starts, const void* idx,
    void* out, const int* shifts, const int* wrs, int C, int nT, int P,
    int K, int wg, int head, void* stream) {
  if (nT <= 0 || C <= 0) return 0;
  if (P > MAX_PASSES || K > wg) return (int)cudaErrorInvalidValue;
  PassMeta meta;
  for (int p = 0; p < P; ++p) {
    meta.shift[p] = ((shifts[p] % LANES) + LANES) % LANES;
    meta.wr[p] = wrs[p];
  }
  dim3 block(LANES, PASS_KY);
  dim3 grid(nT, C);
#define CALL(T, I)                                                          \
  lane_pass_update_kernel<T, I><<<grid, block, 0, (cudaStream_t)stream>>>(  \
      (const T*)values, (const int32_t*)starts, (const I*)idx, (T*)out,     \
      meta, nT, P, K, wg, head)
  LANE_DISPATCH(vt, it, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
