"""Chunked Newton-Krylov: host-side Newton control, CG in fixed chunks,
an optional checkpoint after every Newton step.

The counterpart of ``tpufem.nls.newton_chunked``: CG runs in chunks of
``cg_chunk`` iterations with one host read of the residual norm after
each -- the structure of the reference's PETSc KSPSolve with its
per-iteration monitors (FEniCSx/mechanic2d/asym_elasto_damage_model.cc:
869-891). As in the reference, a chunk does NOT stop at convergence:
every chunk runs all its iterations, the count grows by whole chunks,
and the test after a chunk is |r| < tol. (``la.cg`` freezes a converged
state inside a chunk instead; the two give different counts and u.) The
operator is the assembled ELL Jacobian, preconditioned by Jacobi, block
Jacobi or SA-AMG.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpufem_torch.assemble.assembler import Assembler
from tpufem_torch.config import SolverConfig
from tpufem_torch.la.amg import (amg_preconditioner, assembler_hierarchy,
                                 ell_to_scipy)
from tpufem_torch.la.block_jacobi import BlockJacobiPlan
from tpufem_torch.la.precond import jacobi_preconditioner
from tpufem_torch.nls.newton import NonConvergenceError
from tpufem_torch.nls.newton_jit import ELEMENT_BATCH, check_preconditioner


class ChunkedResult(NamedTuple):
    u: torch.Tensor
    newton_iters: int
    total_cg_iters: int
    final_residual: float
    r0: float
    converged: bool
    history: list  # (newton_it, |r|, cg_iters) tuples


def make_chunked_solver(
    asm: Assembler,
    cfg: Optional[SolverConfig] = None,
    *,
    cg_chunk: int = 100,
    checkpoint_path: Optional[str] = None,
    batch: Optional[int] = ELEMENT_BATCH,
):
    """Returns solve(u0, coeffs) -> ChunkedResult.

    ``checkpoint_path``: save (u, newton state) after every Newton
    iteration and resume from the file if it exists -- the
    checkpoint/restart capability the reference study lacks (its runs
    are always start-to-finish). ``batch``: the element matrices in cell
    slabs of this size.

    Preconditioners: ``jacobi``; ``block_jacobi`` (the blocks of each
    Newton step's matrix inverted at that step); ``amg`` (one V-cycle; the
    hierarchy from the matrix of the first Newton step this solver runs,
    kept for its life). ``none`` and ``chebyshev`` raise ``ValueError``
    (the reference runs Jacobi for them without a word).
    """
    cfg = cfg or SolverConfig()
    pc = cfg.preconditioner
    check_preconditioner(pc)
    if pc not in ("jacobi", "block_jacobi", "amg"):
        raise ValueError(f"preconditioner={pc!r}: the chunked solver runs "
                         "'jacobi', 'block_jacobi' and 'amg'")
    asm.pattern
    bj_plan = None
    if pc == "block_jacobi":
        bj_plan = BlockJacobiPlan.build(asm.pattern, cfg.block_size,
                                        device=asm.device)
    amg_state = {}
    dot = torch.dot

    def rhs(u, coeffs):
        b = -asm.residual(u, coeffs, batch=batch) * asm.free_mask(u.dtype)
        return b, float(torch.sqrt(dot(b, b)))

    def assemble(u, coeffs):
        """The step's matrix and its preconditioner M(r)."""
        mat = asm.matrix(u, coeffs, batch=batch)
        if bj_plan is not None:
            return mat, bj_plan.preconditioner(mat)
        if pc == "amg":
            if "M" not in amg_state:
                amg_state["M"] = amg_preconditioner(
                    assembler_hierarchy(asm, ell_to_scipy(mat), cfg,
                                        dtype=mat.vals.dtype
                                        ).to(mat.vals.device),
                    degree=cfg.amg_degree)
            return mat, amg_state["M"]
        return mat, jacobi_preconditioner(mat.diagonal())

    def cg_chunk_fn(nsteps, mat, M, state):
        x, r, z, p, rz = state
        for _ in range(nsteps):
            Ap = mat.matvec(p)
            alpha = rz / dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        return (x, r, z, p, rz), math.sqrt(float(dot(r, r)))

    def solve(u0, coeffs) -> ChunkedResult:
        u = asm.set_bc(u0)
        history = []
        r0 = None
        total_cg = 0
        it = 0
        it_start = 1
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            from tpufem_torch.io.checkpoint import load_checkpoint

            ck = load_checkpoint(checkpoint_path)
            u = torch.as_tensor(ck["u"], dtype=u.dtype, device=u.device)
            it_start = int(ck["newton_it"]) + 1
            r0 = float(ck["r0"]) if np.isfinite(ck["r0"]) else None
            total_cg = int(ck["total_cg"])
        for it in range(it_start, cfg.newton_maxit + 1):
            b, bnorm = rhs(u, coeffs)
            if r0 is None and (cfg.convergence == "r0" or it >= 2):
                # 'du0' (dolfinx) measures relative to the residual after
                # the first correction (doc.tex:2065-2068)
                r0 = bnorm
            ref = r0 if r0 is not None else bnorm
            if bnorm < max(cfg.newton_rtol * ref, cfg.newton_atol):
                it -= 1
                break
            mat, M = assemble(u, coeffs)
            z = M(b)
            state = (torch.zeros_like(b), b, z, z, dot(b, z))
            tol = max(cfg.cg_rtol * bnorm, cfg.cg_atol)
            k = 0
            while k < cfg.cg_maxit:
                nsteps = min(cg_chunk, cfg.cg_maxit - k)
                state, rr = cg_chunk_fn(nsteps, mat, M, state)
                k += nsteps
                if rr < tol:
                    break
            del mat, M
            u = u + state[0] * asm.free_mask(u.dtype)
            total_cg += k
            history.append((it, bnorm, k))
            if checkpoint_path is not None:
                from tpufem_torch.io.checkpoint import save_checkpoint

                save_checkpoint(
                    checkpoint_path,
                    dict(u=u.cpu().numpy(), newton_it=it,
                         r0=r0 if r0 is not None else np.nan,
                         total_cg=total_cg),
                )
            if cfg.verbose:
                print(
                    f"Newton iteration {it}: |r| = {bnorm:.6e} "
                    f"(cg {k} iters)"
                )
        b, bnorm = rhs(u, coeffs)
        if r0 is None:
            r0 = bnorm
        converged = bnorm < max(cfg.newton_rtol * r0, cfg.newton_atol)
        if not converged and cfg.error_on_nonconvergence:
            raise NonConvergenceError(
                f"chunked Newton: |r| = {bnorm:.3e} after {it} iterations"
            )
        return ChunkedResult(
            u=u, newton_iters=it, total_cg_iters=total_cg,
            final_residual=bnorm, r0=r0 or bnorm, converged=converged,
            history=history,
        )

    return solve
