// The asymmetric elasto-damage stress and its directional derivative,
// per element, shared by the fused lane kernel (lane_fused_elem.cu) and the
// structured lattice kernels (lattice_residual.cu, lattice_tangent.cu).
//
// Both functions spell, operation by operation, what
// tpufem_torch/forms/potentials.py:asym_damage_stress_components and
// asym_damage_stress_jvp_components compute -- the order of the reference's
// tpufem/structured/pallas2d.py:_stress and _stress_jvp. The library is
// built without fused multiply-adds, so those plain PyTorch functions
// round exactly as these do.
#pragma once

#include <cuda_runtime.h>

// sigma = d psi / d eps of the asymmetric elasto-damage law
template <typename T>
__device__ __forceinline__ void asym_stress(T e11, T e22, T e12, T d, T lam,
                                            T mu, T& s11, T& s22, T& s12) {
  const T i1 = e11 + e22;
  const T diff = e11 - e22;
  const T delta = diff * diff + T(4) * e12 * e12;
  const bool degen = delta == T(0);
  const T r = degen ? T(0) : sqrt(degen ? T(1) : delta);
  const T eig1 = T(0.5) * (i1 + r);
  const T eig2 = T(0.5) * (i1 - r);
  const T a1 = eig1 < T(0) ? T(0) : T(1);
  const T a2 = eig2 < T(0) ? T(0) : T(1);
  const T a = i1 < T(0) ? T(0) : T(1);
  const T inv_r = degen ? T(0) : T(1) / (degen ? T(1) : r);
  const T p11 = degen ? T(0.5) : (e11 - eig2) * inv_r;
  const T p22 = degen ? T(0.5) : (e22 - eig2) * inv_r;
  const T p12 = degen ? T(0) : e12 * inv_r;
  const T vol = lam * i1 * (T(1) - a * d);
  const T c1 = T(2) * mu * (T(1) - a1 * d) * eig1;
  const T c2 = T(2) * mu * (T(1) - a2 * d) * eig2;
  s11 = vol + c1 * p11 + c2 * (T(1) - p11);
  s22 = vol + c1 * p22 + c2 * (T(1) - p22);
  s12 = c1 * p12 - c2 * p12;
}

// (d sigma / d eps)[t]: the switches are piecewise constant; on the
// coalescent set delta == 0 the isotropic smooth limit is used
template <typename T>
__device__ __forceinline__ void asym_stress_jvp(T e11, T e22, T e12, T t11,
                                                T t22, T t12, T d, T lam,
                                                T mu, T& s11, T& s22,
                                                T& s12) {
  const T i1 = e11 + e22;
  const T di1 = t11 + t22;
  const T diff = e11 - e22;
  const T ddiff = t11 - t22;
  const T delta = diff * diff + T(4) * e12 * e12;
  const bool degen = delta == T(0);
  const T r0 = sqrt(degen ? T(1) : delta);
  const T inv_r = degen ? T(0) : T(1) / r0;
  const T r = degen ? T(0) : r0;
  const T dr = (T(2) * diff * ddiff + T(8) * e12 * t12) * T(0.5) * inv_r;

  const T eig1 = T(0.5) * (i1 + r);
  const T eig2 = T(0.5) * (i1 - r);
  const T deig1 = T(0.5) * (di1 + dr);
  const T deig2 = T(0.5) * (di1 - dr);
  const T a1 = eig1 < T(0) ? T(0) : T(1);
  const T a2 = eig2 < T(0) ? T(0) : T(1);
  const T a = i1 < T(0) ? T(0) : T(1);

  const T p11 = (e11 - eig2) * inv_r;
  const T p22 = (e22 - eig2) * inv_r;
  const T p12 = e12 * inv_r;
  const T inv_r2 = inv_r * inv_r;
  const T dp11 = (t11 - deig2) * inv_r - (e11 - eig2) * dr * inv_r2;
  const T dp22 = (t22 - deig2) * inv_r - (e22 - eig2) * dr * inv_r2;
  const T dp12 = t12 * inv_r - e12 * dr * inv_r2;

  const T dvol = lam * di1 * (T(1) - a * d);
  const T c1 = T(2) * mu * (T(1) - a1 * d) * eig1;
  const T c2 = T(2) * mu * (T(1) - a2 * d) * eig2;
  const T dc1 = T(2) * mu * (T(1) - a1 * d) * deig1;
  const T dc2 = T(2) * mu * (T(1) - a2 * d) * deig2;

  const T dev = T(2) * mu * (T(1) - a * d);
  s11 = degen ? dvol + dev * t11
              : dvol + dc1 * p11 + c1 * dp11 + dc2 * (T(1) - p11) - c2 * dp11;
  s22 = degen ? dvol + dev * t22
              : dvol + dc1 * p22 + c1 * dp22 + dc2 * (T(1) - p22) - c2 * dp22;
  s12 = degen ? dev * t12 : (dc1 - dc2) * p12 + (c1 - c2) * dp12;
}
