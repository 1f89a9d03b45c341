// Shared helpers for the lane-layout kernels (plain C interface, no
// PyTorch headers: each file builds in seconds with nvcc alone).
//
// Layout conventions: L = 128 lane columns are the minor dimension of
// every array, so thread j of a block always touches column j and every
// warp access along j is one coalesced segment. Index tables hold -1 for
// "no entry" and come as int8 (windows below 127 rows) or int32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LANES 128

// value type code: 0 = float, 1 = double; index type code: 0 = int8, 1 = int32
#define LANE_DISPATCH(vt, it, CALL)                         \
  do {                                                      \
    if ((vt) == 0 && (it) == 0) { CALL(float, int8_t); }    \
    else if ((vt) == 0 && (it) == 1) { CALL(float, int32_t); } \
    else if ((vt) == 1 && (it) == 0) { CALL(double, int8_t); } \
    else if ((vt) == 1 && (it) == 1) { CALL(double, int32_t); } \
    else { return (int)cudaErrorInvalidValue; }             \
  } while (0)
