"""Preconditioners: Jacobi (the reference workload's), the Chebyshev
preconditioner of the flat Newton solver (``nls.newton_jit``), the
Chebyshev smoothing of the multilevel preconditioners (``structured.mg2d``
and ``lane.twolevel``), and the power iteration that sets the interval
of both."""

from __future__ import annotations

from typing import Callable

import torch


def check_matmul_precision(t: torch.Tensor) -> None:
    """A float32 product on the card must run in full float32, as the
    reference forces ``default_matmul_precision("float32")``: the dense
    coarse solves of the multigrid, two-level and SA-AMG cycles call
    this before their ``matmul``."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the multilevel "
            "preconditioners need full float32 matrix products")


def inverse_diagonal(diag: torch.Tensor) -> torch.Tensor:
    """1/diag, guarded: 1 where the diagonal is 0."""
    one = torch.ones_like(diag)
    return torch.where(diag != 0.0,
                       1.0 / torch.where(diag == 0.0, one, diag), one)


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """M ~ A^-1 as 1/diag (guarded: 1 where the diagonal is 0)."""
    inv = inverse_diagonal(diag)

    def M(r):
        return inv * r

    return M


def estimate_lambda_max(A: Callable, diag: torch.Tensor, n: int, *,
                        iters: int = 12) -> float:
    """Power iteration estimate of lambda_max(D^-1 A) for Chebyshev
    bounds (``tpufem.la.precond.estimate_lambda_max``): the iteration of
    :func:`power_lambda_max` over all ``n`` entries.

    Deterministic start vector (alternating signs) so the estimate is
    reproducible across runs and devices; ~12 iterations give the 2-5 %
    accuracy Chebyshev needs.
    """
    return power_lambda_max(A, inverse_diagonal(diag),
                            torch.ones(n, dtype=diag.dtype,
                                       device=diag.device), iters)


def chebyshev_preconditioner(
    A: Callable, diag: torch.Tensor, *, degree: int = 4,
    lmax_scale: float = 1.1, lmin_ratio: float = 0.25, lmax=None,
) -> Callable:
    """Chebyshev polynomial of the Jacobi-scaled operator
    (``tpufem.la.precond.chebyshev_preconditioner``).

    Approximates A^-1 with a fixed-degree Chebyshev recurrence on D^-1 A,
    assuming eigenvalues in [lmin_ratio * lambda_max, lmax_scale *
    lambda_max]. lambda_max of D^-1 A defaults to 2.0 (an upper bound for
    SPD FEM operators with Jacobi scaling); pass a measured value (that
    of :func:`estimate_lambda_max`) for tighter clustering. The band differs from
    :func:`chebyshev_iterate`'s, which starts from a given x.
    """
    inv_d = inverse_diagonal(diag)
    lam_max = (float(lmax) if lmax is not None else 2.0) * lmax_scale
    lam_min = lam_max * lmin_ratio
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)

    def M(r):
        sigma = theta / delta
        rho_old = 1.0 / sigma
        x = torch.zeros_like(r)
        res = inv_d * r
        d_k = res / theta
        for _ in range(degree - 1):
            x = x + d_k
            res = res - inv_d * A(d_k)
            rho_new = 1.0 / (2.0 * sigma - rho_old)
            d_k = rho_new * rho_old * d_k + (2.0 * rho_new / delta) * res
            rho_old = rho_new
        return x + d_k  # the last residual is never read: no A(d_k)

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
    exactly zero. The last step adds its update and stops: the residual
    after it is never read, so its product A(d) is not made.
    """
    lam_max = lmax_scale * lmax
    lam_min = lmin_ratio * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    res = inv_d * b if x is None else inv_d * (b - A(x))
    d = res / theta
    for _ in range(degree - 1):
        x = d if x is None else x + d
        res = torch.addcmul(res, inv_d, A(d), value=-1.0)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * res
        rho = rho_new
    return d if x is None else x + d


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
