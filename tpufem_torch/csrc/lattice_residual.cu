// lattice_residual -- K6: the fused residual pass of the asymmetric
// elasto-damage law on the structured P1 lattice.
//
// Replaces the TPU kernel tpufem/structured/pallas2d.py:make_residual_kernel
// (its pl.pallas_call at :197): r = F(u) for u (2, ny+1, nx+1) and the
// vertex damage d (ny+1, nx+1), float32, one read of u and d, one write of
// r. The pass itself, its bound and its design are in lattice2d.cuh.
#include "lattice2d.cuh"

extern "C" int lattice_residual(const void* u, const void* d, void* out,
                                int nx, int ny, const float* consts,
                                void* stream) {
  return lattice2d_launch<0>(u, nullptr, d, out, nx, ny, consts, stream);
}
