"""Chunked Newton-Krylov on the structured fast path (2D and 3D lattices).

Matrix-free in the reference's sense: no sparse matrix and no gathers --
the CG operator is a lattice stencil. BCs by mask fields on the lattice.
CG runs in chunks of ``cg_chunk`` iterations between two reads of the
residual norm, and the count is kept in whole chunks: the iterations
after convergence inside the last chunk run too, as in the reference.

Operators, per Newton step:
- ``mg_matvec_factory`` given: its raw linear matvec (e.g. K8,
  ``structured.kernels3d``) as the fine CG operator and, per level, in
  the V-cycle's smoothers where it returns one (in 3D such a level
  stores no stencil: its smoother data come from ``grid.diagonal`` and
  power iterations through the matvec);
- otherwise the tangent linearized once into a stored stencil
  (``grid.operator``: a 7-point stencil in 2D, 27-point in 3D) -- the
  reference applies ``jax.jvp`` of the residual per CG iteration, free
  under ``jit``, a host-side AD replay in eager PyTorch.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import torch

from tpufem_torch.config import SolverConfig
from tpufem_torch.structured import mg2d, mg3d
from tpufem_torch.structured.grid3d import StructuredGrid3D


class GridSolveResult(NamedTuple):
    u: torch.Tensor
    newton_iters: int
    total_cg_iters: int
    final_residual: float
    r0: float
    converged: bool
    # per Newton step that ran CG: the residual norm it started from and
    # its CG count (in whole chunks)
    residuals: Tuple[float, ...] = ()
    cg_iters: Tuple[int, ...] = ()
    # host seconds in the CG loops (each chunk ends in a read of the
    # device), preconditioner set-up excluded
    cg_seconds: float = 0.0


def _dot(a, b):
    return torch.sum(a * b)


def make_grid_solver(
    grid,
    cfg: Optional[SolverConfig] = None,
    *,
    cg_chunk: int = 200,
    inner_dtype=None,
    mg_matvec_factory=None,
):
    """Returns solve(u0, fields, free_mask, bc_values, load=None) ->
    :class:`GridSolveResult`, for a ``StructuredGrid2D`` or
    ``StructuredGrid3D``. The solve runs where ``u0`` lies.

    ``free_mask``: (bs, *lattice) 1.0 on unknowns; ``bc_values`` same
    shape with imposed values; ``load`` optional nodal load field.

    ``cfg.preconditioner='mg'`` uses the geometric-multigrid V-cycle
    (``structured.mg2d`` / ``mg3d``, by grid type, V(cfg.mg_degree,
    cfg.mg_degree)); anything else is point Jacobi.

    ``mg_matvec_factory``: optional callable grid_level -> raw linear
    matvec (or None); used for the CG operator at the fine level and the
    MG smoothers per level (K8 for linear constant-coefficient problems),
    called once per lattice.

    ``inner_dtype`` (e.g. torch.float32): mixed precision -- the Newton
    residual, the iterate and the update stay in u0's dtype, while each CG
    solve (and the preconditioner's set-up) runs in ``inner_dtype`` on the
    right-hand side normalized by its norm; u, the fields and the mask are
    cast. Newton is the defect-correction loop, so the iterate converges to
    the root in u0's dtype. Set ``cfg.cg_rtol`` to what the inner dtype can
    reach (~1e-6 for float32).
    """
    cfg = cfg or SolverConfig()
    use_mg = cfg.preconditioner == "mg"
    is_3d = isinstance(grid, StructuredGrid3D)
    mg_mod = mg3d if is_3d else mg2d
    cache = {}  # the factory's matvecs: the lattices repeat every step

    def level_matvec(g):
        key = (g.nx, g.ny, getattr(g, "nz", None))
        if key not in cache:
            cache[key] = mg_matvec_factory(g)
        return cache[key]

    factory = level_matvec if mg_matvec_factory is not None else None

    def rhs(u, fields, free, load_r):
        b = -(grid.residual(u, fields) - load_r) * free
        return b, torch.sqrt(_dot(b, b))

    def cg_chunk_fn(nsteps, A, M, state):
        x, r, z, p, rz = state
        for _ in range(nsteps):
            Ap = A(p)
            alpha = rz / _dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = _dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        return (x, r, z, p, rz), torch.sqrt(_dot(r, r))

    def solve(u0, fields, free, bc_values, load=None) -> GridSolveResult:
        free = free.to(u0.dtype)
        u = torch.where(free > 0, u0, bc_values.to(u0.dtype))
        load_r = (grid.load_residual(load.to(u0.dtype))
                  if load is not None else torch.zeros_like(u))
        r0 = None
        total_cg = 0
        it = 0
        residuals, cg_counts = [], []
        cg_seconds = 0.0
        for it in range(1, cfg.newton_maxit + 1):
            b, bnorm = rhs(u, fields, free, load_r)
            bnorm = float(bnorm)
            if r0 is None:
                r0 = bnorm
            if bnorm < max(cfg.newton_rtol * r0, cfg.newton_atol):
                it -= 1
                break
            if inner_dtype is not None:
                scale = bnorm if bnorm > 0 else 1.0
                b_in = (b / scale).to(inner_dtype)
                u_in = u.to(inner_dtype)
                fields_in = {k_: v.to(inner_dtype) for k_, v in fields.items()}
                free_in = free.to(inner_dtype)
            else:
                scale = 1.0
                b_in, u_in, fields_in, free_in = b, u, fields, free

            # the preconditioner and the CG operator of this step
            op = None
            if use_mg:
                if is_3d:
                    grids, data = mg3d.build_mg3d(
                        grid, u_in, fields_in, free_in,
                        matvec_factory=factory)
                else:
                    grids, data = mg2d.build_mg2d(grid, u_in, fields_in,
                                                  free_in)
                matvecs = ([factory(g) for g in grids[:-1]]
                           if factory is not None else None)

                def M(r, data=data, matvecs=matvecs):
                    return mg_mod.vcycle(data, r, degree=cfg.mg_degree,
                                         matvecs=matvecs)

                if data.levels:
                    op = data.levels[0].op
            else:
                diag = grid.diagonal(u_in, fields_in)
                diag = diag * free_in + (1.0 - free_in)
                inv_d = torch.where(diag != 0, 1.0 / diag,
                                    torch.ones_like(diag))

                def M(r, inv_d=inv_d):
                    return inv_d * r
            raw = factory(grid) if factory is not None else None
            if raw is not None:
                fixed = 1.0 - free_in

                def A(v, raw=raw, free_in=free_in, fixed=fixed):
                    return raw(v * free_in) * free_in + v * fixed
            else:
                A = op if op is not None else grid.operator(
                    u_in, fields_in, free_in)

            z0 = M(b_in)
            state = (torch.zeros_like(b_in), b_in, z0, z0, _dot(b_in, z0))
            tol = max(cfg.cg_rtol * float(torch.sqrt(_dot(b_in, b_in))),
                      cfg.cg_atol)
            k = 0
            t0 = time.perf_counter()
            while k < cfg.cg_maxit:
                nsteps = min(cg_chunk, cfg.cg_maxit - k)
                state, rr = cg_chunk_fn(nsteps, A, M, state)
                k += nsteps
                if float(rr) < tol:
                    break
            cg_seconds += time.perf_counter() - t0
            u = u + (state[0].to(u.dtype) * scale) * free
            total_cg += k
            residuals.append(bnorm)
            cg_counts.append(k)
            if cfg.verbose:
                print(f"Newton {it}: |r| = {bnorm:.6e} (cg {k})")
        b, bnorm = rhs(u, fields, free, load_r)
        bnorm = float(bnorm)
        converged = bnorm < max(cfg.newton_rtol * (r0 or 1.0),
                                cfg.newton_atol)
        return GridSolveResult(
            u=u, newton_iters=it, total_cg_iters=total_cg,
            final_residual=bnorm, r0=r0 or bnorm, converged=converged,
            residuals=tuple(residuals), cg_iters=tuple(cg_counts),
            cg_seconds=cg_seconds,
        )

    return solve
