"""Newton solver with pluggable residual/Jacobian and both convergence
conventions of the reference.

Mirrors dolfinx::nls::NewtonSolver as configured at
FEniCSx/mechanic2d/asym_elasto_damage_model.cc:704-894 (setF/setJ/
set_form/set_convergence_check; rtol 1e-7, atol 5e-8, max_it 10,
error_on_nonconvergence) and mfem::NewtonSolver (MFEM/...cc:1531-1548),
and ``tpufem.nls.newton``. The two codes differ in what the relative
residual is measured against -- the documented 6-vs-4 iteration gap
(doc.tex:2065-2068): ``convergence='r0'`` reproduces MFEM (the first
step's right-hand side sets the scale), ``'du0'`` dolfinx (it checks
*after* the first update, so its scale is the residual at the first
corrected state).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from tpufem_torch.config import SolverConfig
from tpufem_torch.la.cg import cg


class NewtonResult(NamedTuple):
    u: torch.Tensor
    iterations: int
    converged: bool
    residual_norms: list
    krylov_iters: list


class NonConvergenceError(RuntimeError):
    """Raised when error_on_nonconvergence is set -- the analog of the
    reference's MPI_Abort(-1234) (FEniCSx/...cc:906)."""


class NewtonSolver:
    """Newton-Krylov driver over callbacks.

    setF/setJ-style: the problem object provides
      - ``rhs(u)``      -> lifted RHS b for the step system (BCs included)
      - ``operator(u)`` -> linear map v -> A v (matrix-free)
      - ``precond(u)``  -> optional preconditioner map
    The step solve is A delta = b by :func:`tpufem_torch.la.cg`; update
    u <- u + delta. The
    right-hand side at the corrected state, which the convergence test
    needs, is also the next step's ``b``: it is evaluated once, not twice
    as in the reference (``rhs`` is a function of ``u``).
    """

    def __init__(self, config: Optional[SolverConfig] = None):
        self.config = config or SolverConfig()

    def solve(
        self,
        u0: torch.Tensor,
        *,
        rhs: Callable,
        operator: Callable,
        precond: Optional[Callable] = None,
    ) -> NewtonResult:
        cfg = self.config
        if cfg.convergence not in ("r0", "du0"):
            raise ValueError(f"convergence={cfg.convergence!r}: 'r0' or "
                             "'du0'")
        u = u0
        norms = []
        kiters = []
        r0_norm = None
        converged = False
        it = 0
        dot = torch.dot

        r_new = None
        for it in range(1, cfg.newton_maxit + 1):
            b = rhs(u) if r_new is None else r_new
            A = operator(u)
            M = precond(u) if precond is not None else None
            res = cg(
                A, b, M=M, rtol=cfg.cg_rtol, atol=cfg.cg_atol,
                maxit=cfg.cg_maxit,
            )
            u = u + res.x
            kiters.append(res.iters)

            # convergence on the *new* residual (dolfinx convention:
            # assemble F at the corrected state and test; MFEM tests the
            # incoming residual against ||r0||)
            r_new = rhs(u)
            rnorm = float(torch.sqrt(dot(r_new, r_new)))
            norms.append(rnorm)
            if r0_norm is None:
                # first measured norm defines the relative scale
                b0 = float(torch.sqrt(dot(b, b)))
                r0_norm = b0 if cfg.convergence == "r0" else max(rnorm,
                                                                 1e-300)
            rel = rnorm / max(r0_norm, 1e-300)
            if cfg.verbose:
                print(
                    f"Newton iteration {it}: r (abs) = {rnorm:.6e} "
                    f"(tol = {cfg.newton_atol}) r (rel) = {rel:.6e} "
                    f"(tol = {cfg.newton_rtol})"
                )
            if rel < cfg.newton_rtol or rnorm < cfg.newton_atol:
                converged = True
                break

        if not converged and cfg.error_on_nonconvergence:
            raise NonConvergenceError(
                f"Newton did not converge in {it} iterations "
                f"(last |r| = {norms[-1] if norms else float('nan'):.3e})"
            )
        return NewtonResult(
            u=u, iterations=it, converged=converged,
            residual_norms=norms, krylov_iters=kiters,
        )
