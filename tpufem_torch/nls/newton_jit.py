"""The flat Newton-Krylov solver: Newton around preconditioned CG on the
flat ``Assembler``, with the assembled ELL Jacobian or the matrix-free
element action.

``tpufem.nls.newton_jit`` runs this loop as one XLA program (a
``lax.while_loop`` around CG's). In eager PyTorch there is no such
program, so the loop runs on the host with the same stopping rule and
arithmetic: the Newton test reads one norm a step, and ``la.cg`` reads
its counter once a chunk. Dirichlet handling is the reference's
"BCs-in-initial-guess" formulation (FEniCSx/mechanic2d/
asym_elasto_damage_model.cc:665-668): with u0[bc] = g the lifting term
J.(g - u) vanishes identically, so each step solves A^ delta = -M F(u)
with delta[bc] = 0 -- no lifting.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from tpufem_torch.assemble.assembler import Assembler
from tpufem_torch.config import SolverConfig
from tpufem_torch.la.amg import (amg_preconditioner, assembler_hierarchy,
                                 ell_to_scipy)
from tpufem_torch.la.block_jacobi import BlockJacobiPlan
from tpufem_torch.la.cg import cg
from tpufem_torch.la.precond import (chebyshev_preconditioner,
                                     estimate_lambda_max,
                                     jacobi_preconditioner)

PRECONDITIONERS = ("jacobi", "chebyshev", "none", "block_jacobi", "amg")
# cells per slab of the element matrices: a 24-dof hex's Hessian under
# torch.func keeps tens of KB of float64 temporaries a cell
ELEMENT_BATCH = 1 << 16


def check_preconditioner(pc: str) -> None:
    """Raise for a preconditioner the flat solvers do not run."""
    if pc not in PRECONDITIONERS:
        raise ValueError(
            f"preconditioner={pc!r}: the flat Newton solver runs "
            f"{', '.join(PRECONDITIONERS)} (twolevel / mg are the lane and "
            "structured solvers' preconditioners)"
        )


class JitSolveResult(NamedTuple):
    u: torch.Tensor
    newton_iters: int
    final_residual: float
    r0: float
    converged: bool
    total_cg_iters: int
    # seconds per stage over all Newton steps, each ended on a device
    # synchronize: "tangent" (element matrices or the ELL matrix, and the
    # diagonal), "lambda_max" (Chebyshev's power iteration), "cg",
    # "residual" (right-hand sides and their norms); under block_jacobi
    # also "block_inverse" (extraction and batched inverse of the blocks),
    # under amg "amg_setup" (the matrix at the first iterate and the
    # hierarchy, once per solver)
    phase_s: dict
    cg_iters: list  # CG iterations of each Newton step


def make_newton_solver(
    asm: Assembler,
    cfg: Optional[SolverConfig] = None,
    *,
    use_matrix: bool = True,
    batch: Optional[int] = ELEMENT_BATCH,
):
    """Build solve(u0, coeffs) -> JitSolveResult.

    ``use_matrix=True`` assembles the ELL Jacobian once per Newton
    iteration and runs CG on its matvec (the reference's assembled-PETSc
    path); ``False`` runs CG on the element action: J is taken once per
    Newton step (``Assembler.linearize``: the element matrices and the
    facet Hessians) and gives both the operator
    (``Assembler.constrained_action(u, coeffs, em)``) and the diagonal,
    where the reference takes a jvp of the residual per application (the
    same operator to rounding). Preconditioners: ``jacobi``,
    ``chebyshev`` (lambda_max by ``estimate_lambda_max`` on the step's
    operator), ``none``, ``block_jacobi`` (``cfg.block_size`` blocks of
    the step's matrix, inverted every Newton step) and ``amg`` (one SA-AMG
    V-cycle of degree ``cfg.amg_degree``; the hierarchy comes from the
    matrix at ``set_bc(u0)`` of the first solve and serves every solve of
    this solver); the last two need ``use_matrix``. ``batch``: the
    element matrices in cell slabs of this size (bounds the Hessian's
    temporaries on large meshes).
    """
    cfg = cfg or SolverConfig()
    pc = cfg.preconditioner
    check_preconditioner(pc)
    if pc in ("block_jacobi", "amg") and not use_matrix:
        raise ValueError(f"{pc} requires use_matrix=True")
    if use_matrix:
        asm.pattern  # built once, before the first solve
    bj_plan = None
    if pc == "block_jacobi":
        bj_plan = BlockJacobiPlan.build(asm.pattern, cfg.block_size,
                                        device=asm.device)
    amg_cache = {}
    dot = torch.dot

    def solve(u0, coeffs) -> JitSolveResult:
        u = asm.set_bc(u0)
        free = asm.free_mask(u.dtype)
        sync = (torch.cuda.synchronize if u.device.type == "cuda"
                else lambda: None)
        phase_s = dict(tangent=0.0, lambda_max=0.0, cg=0.0, residual=0.0)
        if pc == "block_jacobi":
            phase_s["block_inverse"] = 0.0
        if pc == "amg":
            phase_s["amg_setup"] = 0.0

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            sync()
            phase_s[name] += time.perf_counter() - t0
            return out

        if pc == "amg" and "h" not in amg_cache:
            amg_cache["h"] = timed("amg_setup", lambda: assembler_hierarchy(
                asm, ell_to_scipy(asm.matrix(u, coeffs, batch=batch)), cfg,
                dtype=u.dtype).to(u.device))

        def rhs(w):
            b = -asm.residual(w, coeffs, batch=batch) * free
            return b, float(torch.sqrt(dot(b, b)))

        b, r0 = timed("residual", lambda: rhs(u))
        bnorm, it, cg_tot, cg_iters = r0, 0, 0, []
        while (bnorm >= max(cfg.newton_rtol * r0, cfg.newton_atol)
               and it < cfg.newton_maxit):
            if use_matrix:
                mat = timed("tangent", lambda: asm.matrix(u, coeffs,
                                                          batch=batch))
                A = mat.matvec
                diag = timed("tangent", mat.diagonal)
            else:
                em = timed("tangent", lambda: asm.linearize(
                    u, coeffs, batch=batch))
                A = asm.constrained_action(u, coeffs, em)
                diag = timed("tangent", lambda: asm.diagonal(u, coeffs, em))
            if pc == "jacobi":
                M = jacobi_preconditioner(diag)
            elif pc == "chebyshev":
                lmax = timed("lambda_max", lambda: estimate_lambda_max(
                    A, diag, b.shape[0]))
                M = chebyshev_preconditioner(A, diag, lmax=lmax)
            elif pc == "block_jacobi":
                M = timed("block_inverse",
                          lambda: bj_plan.preconditioner(mat))
            elif pc == "amg":
                M = amg_preconditioner(amg_cache["h"], degree=cfg.amg_degree)
            else:
                M = None
            res = timed("cg", lambda: cg(
                A, b, M=M, rtol=cfg.cg_rtol, atol=cfg.cg_atol,
                maxit=cfg.cg_maxit))
            u = u + res.x
            b, bnorm_new = timed("residual", lambda: rhs(u))
            if cfg.convergence == "du0" and it == 0:
                # dolfinx convention: relative scale is the residual after
                # the FIRST correction (doc.tex:2065-2068)
                r0 = bnorm_new
            bnorm = bnorm_new
            it += 1
            cg_tot += res.iters
            cg_iters.append(res.iters)
            # the step's operator (element matrices or matrix) goes before
            # the next step builds its own
            del A, M, diag, res
            mat = em = None
        converged = bnorm < max(cfg.newton_rtol * r0, cfg.newton_atol)
        return JitSolveResult(
            u=u, newton_iters=it, final_residual=bnorm, r0=r0,
            converged=converged, total_cg_iters=cg_tot, phase_s=phase_s,
            cg_iters=cg_iters,
        )

    return solve
