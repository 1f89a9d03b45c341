"""Constitutive energy densities.

All functions map (strain-like tensor, coefficients) -> scalar energy
density and are differentiated by ``torch.func``: sigma = grad(psi)
w.r.t. the strain argument, consistent tangent = hessian. Branches are
``torch.where`` chains (the same code runs per cell under ``vmap`` and
on flat ``(M,)`` component tensors); every sqrt argument is clamped on
the untaken branch to keep gradients NaN-free -- ``torch.where``
propagates a NaN gradient from the unselected branch, the trap the
reference dodges symbolically by switching to the symmetric potential
when i1=i2=0 (doc.tex:925-931, ``asym_ufl.py:50-53``).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

# -- hand-written laws of the fused element kernel ------------------------------
#
# The fused lane kernel (lane/kernels.py:lane_fused_elem) cannot trace an
# integrand: its physics is written by hand, one law per tagged energy
# below. While an engine probes an integrand under ``record_fused_laws``
# every call of a tagged energy notes its name and arguments, which tells
# the engine WHICH law the integrand evaluates and what it passes for the
# damage, the modulus and the Poisson ratio. The engine then proves the
# match numerically; the tag alone decides nothing.

_law_calls = contextvars.ContextVar("tpufem_torch_fused_law_calls",
                                    default=None)


@contextlib.contextmanager
def record_fused_laws():
    """Collect ``(law name, positional arguments)`` of every tagged energy
    called inside the block; yields the list."""
    calls = []
    token = _law_calls.set(calls)
    try:
        yield calls
    finally:
        _law_calls.reset(token)


def _fused_law(name):
    def tag(fn):
        @functools.wraps(fn)
        def tagged(*args):
            calls = _law_calls.get()
            if calls is not None:
                calls.append((name, args))
            return fn(*args)

        tagged.fused_law = name
        return tagged

    return tag


def lame_parameters(E, nu):
    """Plane-strain/3D Lame parameters from Young modulus + Poisson ratio
    (asym_ufl.py:26-27)."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return lam, mu


@_fused_law("linear_elastic")
def linear_elastic_psi(eps, E, nu):
    """Isotropic linear elasticity: psi = lam/2 tr(eps)^2 + mu eps:eps.

    Written with index arithmetic (no trace/sum on the matrix) so it
    accepts both tensors and the forms.smat.SMat containers the lane
    engine's reduced physics path uses."""
    lam, mu = lame_parameters(E, nu)
    n = eps.shape[0]
    tr = eps[0, 0]
    for i in range(1, n):
        tr = tr + eps[i, i]
    frob = None
    for i in range(n):
        for j in range(n):
            t = eps[i, j] * eps[i, j]
            frob = t if frob is None else frob + t
    return 0.5 * lam * tr * tr + mu * frob


def _step(x):
    """0 where x < 0, else 1, in x's dtype (no gradient)."""
    return 1.0 - (x < 0.0).to(x.dtype)


@_fused_law("asym_damage")
def asym_damage_psi(eps, d, E, nu):
    """Asymmetric traction/compression elasto-damage free energy (2D).

    psi(eps,d) = (1-a d) lam/2 tr(eps)^2 + mu sum_i (1-a_i d) L_i^2 with
    a, a_i in {0,1} switching on the sign of tr(eps) and of the strain
    eigenvalues L_i (doc.tex:188-203; UFL version asym_ufl.py:37-53).
    Damage acts only on tension-like modes.

    ``eps``: (2,2) symmetric strain (tensor or SMat). Branch structure
    matches the reference exactly: the symmetric damaged potential is
    used when i1 = i2 = 0 (zero strain); everywhere else the spectral
    form. The sqrt discriminant is clamped via ``torch.where`` so grad /
    hessian stay finite at eps = 0 and at spherical strain (eigenvalue
    coalescence), where the reference's generated code divides by
    sqrt(0).
    """
    lam, mu = lame_parameters(E, nu)
    e11, e22 = eps[0, 0], eps[1, 1]
    e12 = 0.5 * (eps[0, 1] + eps[1, 0])
    i1 = e11 + e22
    # discriminant of the 2x2 symmetric eigenproblem (always >= 0)
    delta = (e11 - e22) ** 2 + 4.0 * e12 * e12
    sq = e11 * e11 + e22 * e22 + 2.0 * e12 * e12  # eps:eps

    # spectral branch -- clamp sqrt argument on the degenerate set
    degen = delta == 0.0
    delta_safe = torch.where(degen, torch.ones_like(delta), delta)
    r = torch.sqrt(delta_safe)
    r = torch.where(degen, torch.zeros_like(r), r)
    eig1 = 0.5 * (i1 + r)
    eig2 = 0.5 * (i1 - r)
    a1 = _step(eig1)
    a2 = _step(eig2)
    a = _step(i1)
    psi_asym = (
        0.5 * lam * i1 * i1 * (1.0 - a * d)
        + mu * ((1.0 - a1 * d) * eig1 * eig1 + (1.0 - a2 * d) * eig2 * eig2)
    )

    # reference selection: zero strain (i1=0 and i2=0 <=> delta=0 and i1=0)
    # -> symmetric form (asym_ufl.py:53). We extend it to the whole
    # coalescent set delta==0 where the spectral derivative is singular;
    # there a1=a2=a and both forms coincide analytically.
    return torch.where(
        degen, psi_sym_at_coalescence(lam, mu, i1, sq, d, a), psi_asym
    )


def psi_sym_at_coalescence(lam, mu, i1, sq, d, a):
    """psi on the eigenvalue-coalescent set (L1=L2=i1/2): smooth limit of
    the spectral form; equals the symmetric form when i1=0 (zero strain)."""
    return 0.5 * lam * i1 * i1 * (1.0 - a * d) + mu * (1.0 - a * d) * sq


def asym_damage_stress_components(e11, e22, e12, d, lam, mu):
    """Hand-derived spectral stress (s11, s22, s12) = d psi / d eps of
    :func:`asym_damage_psi`, elementwise on tensors of any one shape.

    The closed-form eigen-decomposition stress of ``asym_manual.py:35-88``
    and MFEM's hand-coded ``asym_stress`` (MFEM/mechanic2d/
    asym_elasto_damage_model.cc:205-329), with the branch structure of
    :func:`asym_damage_psi`: the switches read the signs of the
    eigenvalues and of the trace, and on the coalescent set
    ``delta == 0`` (zero or spherical strain) the projectors are I/2 and
    ``1/r`` is never formed. The CUDA kernel ``csrc/lane_fused_elem.cu``
    repeats these lines operation by operation."""
    i1 = e11 + e22
    diff = e11 - e22
    delta = diff * diff + 4.0 * e12 * e12
    degen = delta == 0.0
    one, zero = torch.ones_like(delta), torch.zeros_like(delta)
    r = torch.where(degen, zero, torch.sqrt(torch.where(degen, one, delta)))
    eig1 = 0.5 * (i1 + r)
    eig2 = 0.5 * (i1 - r)
    a1 = torch.where(eig1 < 0.0, zero, one)
    a2 = torch.where(eig2 < 0.0, zero, one)
    a = torch.where(i1 < 0.0, zero, one)
    inv_r = torch.where(degen, zero, 1.0 / torch.where(degen, one, r))
    half = 0.5 * one
    p11 = torch.where(degen, half, (e11 - eig2) * inv_r)
    p22 = torch.where(degen, half, (e22 - eig2) * inv_r)
    p12 = torch.where(degen, zero, e12 * inv_r)
    vol = lam * i1 * (1.0 - a * d)
    c1 = 2.0 * mu * (1.0 - a1 * d) * eig1
    c2 = 2.0 * mu * (1.0 - a2 * d) * eig2
    s11 = vol + c1 * p11 + c2 * (1.0 - p11)
    s22 = vol + c1 * p22 + c2 * (1.0 - p22)
    s12 = c1 * p12 - c2 * p12
    return s11, s22, s12


def asym_damage_stress_jvp_components(e11, e22, e12, t11, t22, t12, d,
                                      lam, mu):
    """Directional derivative (ds11, ds22, ds12) = (d sigma / d eps)[t] of
    :func:`asym_damage_stress_components` -- the hand-derived consistent
    tangent action (the math MFEM hand-codes at MFEM/...cc:766-871, in
    forward mode). The switches are piecewise constant (derivative 0
    almost everywhere); on the coalescent set ``delta == 0`` the
    smooth-limit isotropic form is used, which is what ``jvp(grad)`` of
    :func:`asym_damage_psi` gives through its ``where`` structure."""
    i1 = e11 + e22
    di1 = t11 + t22
    diff = e11 - e22
    ddiff = t11 - t22
    delta = diff * diff + 4.0 * e12 * e12
    degen = delta == 0.0
    one, zero = torch.ones_like(delta), torch.zeros_like(delta)
    r = torch.sqrt(torch.where(degen, one, delta))
    inv_r = torch.where(degen, zero, 1.0 / r)
    r = torch.where(degen, zero, r)
    dr = (2.0 * diff * ddiff + 8.0 * e12 * t12) * 0.5 * inv_r

    eig1 = 0.5 * (i1 + r)
    eig2 = 0.5 * (i1 - r)
    deig1 = 0.5 * (di1 + dr)
    deig2 = 0.5 * (di1 - dr)
    a1 = torch.where(eig1 < 0.0, zero, one)
    a2 = torch.where(eig2 < 0.0, zero, one)
    a = torch.where(i1 < 0.0, zero, one)

    p11 = (e11 - eig2) * inv_r
    p22 = (e22 - eig2) * inv_r
    p12 = e12 * inv_r
    inv_r2 = inv_r * inv_r
    dp11 = (t11 - deig2) * inv_r - (e11 - eig2) * dr * inv_r2
    dp22 = (t22 - deig2) * inv_r - (e22 - eig2) * dr * inv_r2
    dp12 = t12 * inv_r - e12 * dr * inv_r2

    dvol = lam * di1 * (1.0 - a * d)
    c1 = 2.0 * mu * (1.0 - a1 * d) * eig1
    c2 = 2.0 * mu * (1.0 - a2 * d) * eig2
    dc1 = 2.0 * mu * (1.0 - a1 * d) * deig1
    dc2 = 2.0 * mu * (1.0 - a2 * d) * deig2

    ds11 = dvol + dc1 * p11 + c1 * dp11 + dc2 * (1.0 - p11) - c2 * dp11
    ds22 = dvol + dc1 * p22 + c1 * dp22 + dc2 * (1.0 - p22) - c2 * dp22
    ds12 = (dc1 - dc2) * p12 + (c1 - c2) * dp12

    # coalescent limit: isotropic damaged Hooke on the direction
    dev = 2.0 * mu * (1.0 - a * d)
    ds11 = torch.where(degen, dvol + dev * t11, ds11)
    ds22 = torch.where(degen, dvol + dev * t22, ds22)
    ds12 = torch.where(degen, dev * t12, ds12)
    return ds11, ds22, ds12


def _sym_components(m):
    return m[0, 0], m[1, 1], 0.5 * (m[0, 1] + m[1, 0])


def _sym_matrix(s11, s22, s12):
    return torch.stack([torch.stack([s11, s12]), torch.stack([s12, s22])])


def asym_damage_stress_manual(eps, d, E, nu):
    """Hand-derived spectral stress sigma = d psi / d eps -- the 'manual'
    variant, as a (2,2) tensor.

    Kept as an independent derivation for the variant-redundancy test
    (SURVEY.md section 4.3): it must agree with grad(asym_damage_psi) to
    machine precision. ``eps``: (2,2) tensor.
    """
    lam, mu = lame_parameters(E, nu)
    return _sym_matrix(*asym_damage_stress_components(
        *_sym_components(eps), d, lam, mu))


def asym_damage_stress_jvp_manual(eps, t, d, E, nu):
    """Hand-derived tangent action (d sigma / d eps)[t] as a (2,2) tensor;
    must agree with ``jvp(grad(asym_damage_psi))`` along the symmetric
    direction ``t``, at zero and spherical strain too."""
    lam, mu = lame_parameters(E, nu)
    return _sym_matrix(*asym_damage_stress_jvp_components(
        *_sym_components(eps), *_sym_components(t), d, lam, mu))


def neo_hookean_psi(grad_u, E, nu):
    """Compressible neo-Hookean energy (BASELINE.json config 4):
    psi = mu/2 (I_C - tr I - 2 ln J) + lam/2 (ln J)^2, F = I + grad u.

    The consistent tangent the reference derives with dual numbers
    (``admfem.hpp`` Hessian path) comes from ``torch.func.hessian`` here.
    Written against the small-matrix helpers of ``forms.smat`` (trace,
    matmul, det, add_identity), so it runs on tensors and on SMat
    containers alike.
    """
    from tpufem_torch.forms import smat

    lam, mu = lame_parameters(E, nu)
    dim = grad_u.shape[0]
    F = smat.add_identity(grad_u)
    Ic = smat.trace(smat.matmul(F.T, F))
    detF = smat.det(F)
    # clamp for AD safety under inverted trial states
    J_safe = torch.clamp(detF, min=1e-12)
    lnJ = torch.log(J_safe)
    return 0.5 * mu * (Ic - dim - 2.0 * lnJ) + 0.5 * lam * lnJ * lnJ
