"""Geometric multigrid preconditioner for the 2D structured lattice.

On a structured triangulation the multigrid hierarchy is *geometric* --
coarse level = the same StructuredGrid2D at half resolution with
coarsened coefficient fields -- so every transfer operator is a slice
stencil (prolongation = linear interpolation on the triangulated lattice,
restriction = its exact transpose).

P1 spaces on the uniformly-refined lattice are nested, so the
rediscretized coarse operator equals the Galerkin product for
piecewise-constant coefficients; coefficient fields are coarsened by
vertex injection / 2x2 cell averaging (a standard geometric-MG
approximation -- fine as a preconditioner).

Smoother: Chebyshev-Jacobi (fixed polynomial, symmetric => the V-cycle
stays SPD for CG). Coarsest level: dense pseudo-inverse formed at set-up
on the host in float64.

Each level's operator is linearized once, at set-up, into a
:class:`~tpufem_torch.structured.grid2d.LatticeOperator` with the
Dirichlet rows folded in; the V-cycle applies those stencils and never
differentiates.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tF

from tpufem_torch.la.precond import (check_matmul_precision, chebyshev_iterate,
                                     power_lambda_max)
from tpufem_torch.structured.grid2d import LatticeOperator, StructuredGrid2D


class MGLevel(NamedTuple):
    u_lin: torch.Tensor  # (bs, ny+1, nx+1) linearization state
    fields: Dict[str, torch.Tensor]
    free: torch.Tensor  # (bs, ny+1, nx+1) 1.0 on unknowns
    inv_d: torch.Tensor  # 1/diag of the constrained operator
    lmax: float  # lambda_max(D^-1 A) estimate
    # the constrained operator, linearized at u_lin; None on a 3D level
    # whose raw matvec the cycle is given instead (mg3d.build_mg3d)
    op: Optional[LatticeOperator]


class MGData(NamedTuple):
    levels: Tuple[MGLevel, ...]
    coarse_inv: torch.Tensor  # (nc, nc) dense inverse of coarsest operator
    # coarsest-level free mask: restricted residuals MUST be masked off
    # the coarse Dirichlet rows -- those rows are identity at scale 1
    # while the free rows carry the E-scale, so unmasked residual there
    # turns into O(1) spurious corrections against an O(E) operator
    coarse_free: torch.Tensor


# -- transfer operators (slice stencils) --------------------------------------


def prolong(c: torch.Tensor) -> torch.Tensor:
    """Linear interpolation on the right-diagonal triangulated lattice:
    coarse (..., nyc+1, nxc+1) -> fine (..., 2nyc+1, 2nxc+1). Edge
    midpoints average their two endpoints; the diagonal midpoint
    (2i+1, 2j+1) averages coarse (i, j) and (i+1, j+1) (the P1 hat
    functions of the nested coarse triangulation)."""
    nyc = c.shape[-2] - 1
    nxc = c.shape[-1] - 1
    f = c.new_zeros(c.shape[:-2] + (2 * nyc + 1, 2 * nxc + 1))
    f[..., ::2, ::2] = c
    f[..., ::2, 1::2] = 0.5 * (c[..., :, :-1] + c[..., :, 1:])
    f[..., 1::2, ::2] = 0.5 * (c[..., :-1, :] + c[..., 1:, :])
    f[..., 1::2, 1::2] = 0.5 * (c[..., :-1, :-1] + c[..., 1:, 1:])
    return f


def restrict(rf: torch.Tensor) -> torch.Tensor:
    """Exact transpose of ``prolong`` (so the coarse-grid correction is
    a Galerkin projection): fine (..., 2nyc+1, 2nxc+1) -> coarse."""
    nyc = (rf.shape[-2] - 1) // 2
    nxc = (rf.shape[-1] - 1) // 2
    p = tF.pad(rf, (1, 1, 1, 1))

    def s(dy, dx):
        return p[..., 1 + dy: 2 + dy + 2 * nyc: 2,
                 1 + dx: 2 + dx + 2 * nxc: 2]

    return s(0, 0) + 0.5 * (
        s(0, 1) + s(0, -1) + s(1, 0) + s(-1, 0) + s(1, 1) + s(-1, -1)
    )


def _inject(f: torch.Tensor) -> torch.Tensor:
    return f[..., ::2, ::2].contiguous()


def _coarsen_cell_field(f: torch.Tensor) -> torch.Tensor:
    """(2, ny, nx) per-orientation cell field -> 2x2 block mean."""
    o, ny, nx = f.shape
    return f.reshape(o, ny // 2, 2, nx // 2, 2).mean(dim=(2, 4))


def coarsen_grid(grid: StructuredGrid2D) -> StructuredGrid2D:
    return StructuredGrid2D(
        nx=grid.nx // 2, ny=grid.ny // 2,
        hx=grid.hx * 2, hy=grid.hy * 2, bs=grid.bs,
        energy_density=grid.energy_density,
        field_kinds=grid.field_kinds,
    )


def _coarsen_fields(grid: StructuredGrid2D, fields):
    out = {}
    for name, kind in grid.field_kinds.items():
        f = fields[name]
        out[name] = _inject(f) if kind == "vertex" else _coarsen_cell_field(f)
    return out


# -- setup --------------------------------------------------------------------


def level_smoother_data(op: LatticeOperator, free: torch.Tensor,
                        power_iters: int):
    """Jacobi inverse diagonal and the power-iteration lambda_max of
    D^-1 A for a constrained level operator."""
    d = op.diagonal()
    one = torch.ones_like(d)
    inv_d = torch.where(d != 0, 1.0 / torch.where(d == 0, one, d), one)
    return inv_d, power_lambda_max(op, inv_d, free, power_iters)


def dense_coarse_inverse(op: LatticeOperator, shape) -> torch.Tensor:
    """Pseudo-inverse of the coarsest constrained operator: its columns
    from one batched application to the unit vectors, then
    ``np.linalg.pinv(rcond=1e-12)`` in float64 on the host (Dirichlet
    identity rows and any semi-definiteness are safe)."""
    nc = int(np.prod(shape))
    S = op.S
    eye = torch.eye(nc, dtype=S.dtype, device=S.device).reshape(nc, *shape)
    cols = op(eye).reshape(nc, nc)  # row i = A e_i
    Ad = cols.T.cpu().to(torch.float64).numpy()
    inv = np.linalg.pinv(Ad, rcond=1e-12)
    return torch.as_tensor(inv, dtype=S.dtype, device=S.device)


def build_mg2d(
    grid: StructuredGrid2D,
    u_lin: torch.Tensor,
    fields: Dict[str, torch.Tensor],
    free: torch.Tensor,
    *,
    coarse_dofs: int = 1500,
    power_iters: int = 15,
) -> Tuple[Tuple[StructuredGrid2D, ...], MGData]:
    """Build the hierarchy at the current linearization state.

    Coarsens while nx, ny stay even and >= 8 and the level is above
    ``coarse_dofs``; the coarsest operator is materialized dense."""
    grids = [grid]
    levels = []
    g, u, flds, fr = grid, u_lin, fields, free
    while (
        g.nx % 2 == 0 and g.ny % 2 == 0
        and g.nx >= 8 and g.ny >= 8
        and u.numel() > coarse_dofs
    ):
        op = g.operator(u, flds, fr)
        inv_d, lmax = level_smoother_data(op, fr, power_iters)
        levels.append(MGLevel(u_lin=u, fields=flds, free=fr, inv_d=inv_d,
                              lmax=lmax, op=op))
        flds = _coarsen_fields(g, flds)
        u = _inject(u)
        fr = _inject(fr)
        g = coarsen_grid(g)
        grids.append(g)

    coarse_inv = dense_coarse_inverse(g.operator(u, flds, fr), u.shape)
    return tuple(grids), MGData(
        levels=tuple(levels), coarse_inv=coarse_inv, coarse_free=fr
    )


# -- apply ---------------------------------------------------------------------


def coarse_solve(coarse_inv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    check_matmul_precision(b)
    return torch.matmul(coarse_inv, b.reshape(-1)).reshape(b.shape)


def cycle(data: MGData, b: torch.Tensor, prolong: Callable,
          restrict: Callable, *, degree: int, lmin_ratio: float,
          matvecs=None) -> torch.Tensor:
    """One symmetric V(degree,degree)-cycle with the given transfers (the
    body of :func:`vcycle` and of ``mg3d.vcycle``). Level l applies
    ``matvecs[l]`` where it is given -- a raw linear operator, masked as
    v -> raw(v * free) * free + v * (1 - free) -- and its stored
    constrained stencil otherwise."""

    def level(l, b):
        if l == len(data.levels):
            return coarse_solve(data.coarse_inv, b)
        L = data.levels[l]
        if matvecs is not None and l < len(matvecs) and matvecs[l] is not None:
            raw, fixed = matvecs[l], 1.0 - L.free

            def A(v, raw=raw, L=L, fixed=fixed):
                return raw(v * L.free) * L.free + v * fixed
        elif L.op is not None:
            A = L.op
        else:
            raise ValueError(f"multigrid level {l} stores no operator: "
                             "pass its matvec in matvecs")
        kw = dict(degree=degree, lmin_ratio=lmin_ratio)
        x = chebyshev_iterate(A, L.inv_d, L.lmax, b, None, **kw)
        res = (b - A(x)) * L.free
        next_free = (
            data.levels[l + 1].free
            if l + 1 < len(data.levels)
            else data.coarse_free
        )
        bc = restrict(res) * next_free
        xc = level(l + 1, bc)
        x = x + prolong(xc) * L.free
        return chebyshev_iterate(A, L.inv_d, L.lmax, b, x, **kw)

    return level(0, b)


def vcycle(data: MGData, b: torch.Tensor, *, degree: int = 3,
           lmin_ratio: float = 1.0 / 8.0, matvecs=None) -> torch.Tensor:
    """One symmetric V(degree,degree)-cycle on the stored level
    operators of ``data`` (from build_mg2d); ``matvecs``: optional
    per-level raw linear operators overriding the stored stencils (see
    :func:`cycle`)."""
    return cycle(data, b, prolong, restrict, degree=degree,
                 lmin_ratio=lmin_ratio, matvecs=matvecs)


def mg_preconditioner(*, degree: int = 3,
                      lmin_ratio: float = 1.0 / 8.0) -> Callable:
    """(data, r) -> z."""

    def M(data, r):
        return vcycle(data, r, degree=degree, lmin_ratio=lmin_ratio)

    return M
