// lattice_tangent -- K7: the fused tangent action J(u) . v of the
// asymmetric elasto-damage law on the structured P1 lattice (the CG
// operator of the structured Newton-Krylov solve).
//
// Replaces the TPU kernel tpufem/structured/pallas2d.py:make_tangent_kernel
// (its pl.pallas_call at :391): u, v (2, ny+1, nx+1), d (ny+1, nx+1),
// float32; the strain of u and of the direction v per triangle, the
// hand-derived directional derivative of the stress (asym_damage.cuh:
// asym_stress_jvp), B^T of it added to the three vertices. The pass, its
// bound and its design are in lattice2d.cuh.
#include "lattice2d.cuh"

extern "C" int lattice_tangent(const void* u, const void* d, const void* v,
                               void* out, int nx, int ny, const float* consts,
                               void* stream) {
  return lattice2d_launch<1>(u, v, d, out, nx, ny, consts, stream);
}
