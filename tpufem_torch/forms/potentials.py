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

import torch


def lame_parameters(E, nu):
    """Plane-strain/3D Lame parameters from Young modulus + Poisson ratio
    (asym_ufl.py:26-27)."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return lam, mu


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


def asym_damage_stress_manual(eps, d, E, nu):
    """Hand-derived spectral stress sigma = d psi / d eps -- the 'manual'
    variant.

    Mirrors the closed-form eigen-decomposition stress of
    ``asym_manual.py:35-88`` and MFEM's hand-coded ``asym_stress``
    (MFEM/mechanic2d/asym_elasto_damage_model.cc:205-329). Kept as an
    independent derivation for the variant-redundancy test (SURVEY.md
    section 4.3): it must agree with grad(asym_damage_psi) to machine
    precision. ``eps``: (2,2) tensor.
    """
    lam, mu = lame_parameters(E, nu)
    e11, e22 = eps[0, 0], eps[1, 1]
    e12 = 0.5 * (eps[0, 1] + eps[1, 0])
    i1 = e11 + e22
    delta = (e11 - e22) ** 2 + 4.0 * e12 * e12
    degen = delta == 0.0
    delta_safe = torch.where(degen, torch.ones_like(delta), delta)
    r = torch.sqrt(delta_safe)
    zero = torch.zeros_like(r)

    eig1 = 0.5 * (i1 + torch.where(degen, zero, r))
    eig2 = 0.5 * (i1 - torch.where(degen, zero, r))
    a1 = _step(eig1)
    a2 = _step(eig2)
    a = _step(i1)

    # eigenvector projectors: P1 = (eps - eig2 I)/(eig1-eig2), P2 = I - P1
    inv_r = torch.where(degen, zero, 1.0 / r)
    I2 = torch.eye(2, dtype=eps.dtype, device=eps.device)
    S = torch.stack([torch.stack([e11, e12]), torch.stack([e12, e22])])
    P1 = torch.where(degen, 0.5 * I2, (S - eig2 * I2) * inv_r)
    P2 = I2 - P1

    sig_vol = lam * i1 * (1.0 - a * d) * I2
    sig_dev = 2.0 * mu * (
        (1.0 - a1 * d) * eig1 * P1 + (1.0 - a2 * d) * eig2 * P2
    )
    return sig_vol + sig_dev
