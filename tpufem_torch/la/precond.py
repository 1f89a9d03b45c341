"""Preconditioners: Jacobi (the reference workload's), Chebyshev
smoothing, the shared smoother of the multilevel preconditioners
(``structured.mg2d`` and ``lane.twolevel``), and the power iteration that
sets its interval."""

from __future__ import annotations

from typing import Callable

import torch


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """M ~ A^-1 as 1/diag (guarded: 1 where the diagonal is 0)."""
    one = torch.ones_like(diag)
    inv = torch.where(diag != 0.0, 1.0 / torch.where(diag == 0.0, one, diag),
                      one)

    def M(r):
        return inv * r

    return M


def chebyshev_iterate(A: Callable, inv_d, lmax, b, x, *, degree: int,
                      lmin_ratio: float = 1.0 / 30.0,
                      lmax_scale: float = 1.1):
    """degree-step Chebyshev iteration on D^-1 A targeting the smoother
    band [lmin_ratio*lmax_scale*lmax, lmax_scale*lmax], starting from x.

    A fixed polynomial in A, hence a *linear*, symmetric operation -- safe
    inside plain CG. ``lmax`` may be a Python float (the coefficients are
    then host scalars and every update is one kernel) or a 0-dim tensor.
    ``x=None`` starts from zero and skips the product A(0), which is
    exactly zero.
    """
    lam_max = lmax_scale * lmax
    lam_min = lmin_ratio * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    res = inv_d * b if x is None else inv_d * (b - A(x))
    d = res / theta
    for i in range(degree):
        x = d if x is None else x + d
        res = torch.addcmul(res, inv_d, A(d), value=-1.0)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
        rho = rho_new
    return x


def power_lambda_max(A: Callable, inv_d, free, iters: int) -> float:
    """lambda_max(D^-1 A) by ``iters`` normalized power iterations from
    the deterministic start vector the multilevel builders use (+1/-1 by
    the parity of the flat index, masked by ``free``), then one Rayleigh
    quotient; one read of the device. Reproducible run to run."""
    v0 = torch.where(
        torch.arange(inv_d.numel(), device=inv_d.device) % 2 == 0, 1.0, -1.0
    ).reshape(inv_d.shape).to(inv_d.dtype) * free
    v = v0 / torch.sqrt(torch.sum(v0 * v0))
    for _ in range(iters):
        w = inv_d * A(v)
        v = w / torch.sqrt(torch.sum(w * w))
    w = inv_d * A(v)
    return float(torch.sum(v * w) / torch.sum(v * v))
