"""Geometric multigrid for the 3D structured (Q1 hex lattice) path.

The design of structured.mg2d (see there for the coarse-Dirichlet
masking): Q1 spaces are nested under dyadic refinement, trilinear
interpolation is the exact nested prolongation and its transpose the
restriction -- both compositions of 1-D [1/2, 1, 1/2] stencils per axis,
so everything is slice arithmetic. A level the caller gives a raw matvec
(K8, ``structured.kernels3d``) keeps no operator of its own: its Jacobi
diagonal comes from ``grid.diagonal`` and its lambda_max from power
iterations through the masked matvec, as the reference takes them from
the diagonal and the tangent. Any other level is linearized once, at
set-up, into a 27-point stencil with the Dirichlet rows folded in; the
coarsest is inverted densely on the host in float64. The V-cycle plugs
into ``make_grid_solver`` unchanged (preconditioner='mg' dispatches on
the grid type).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as tF

from tpufem_torch.la.precond import power_lambda_max
from tpufem_torch.structured.grid3d import StructuredGrid3D
from tpufem_torch.structured.mg2d import (MGData, MGLevel, cycle,
                                          dense_coarse_inverse,
                                          level_smoother_data)

COARSE_DOFS = 3000  # coarsen while a level holds more dofs than this
POWER_ITERS = 15  # power iterations for each level's lambda_max
LMIN_RATIO = 1.0 / 8.0  # the Chebyshev smoother's band: its low end / top


def _prolong_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    c = torch.movedim(c, axis, -1)
    m = c.shape[-1] - 1
    f = c.new_zeros(c.shape[:-1] + (2 * m + 1,))
    f[..., ::2] = c
    f[..., 1::2] = 0.5 * (c[..., :-1] + c[..., 1:])
    return torch.movedim(f, -1, axis)


def _restrict_axis(r: torch.Tensor, axis: int) -> torch.Tensor:
    r = torch.movedim(r, axis, -1)
    m = (r.shape[-1] - 1) // 2
    p = tF.pad(r, (1, 1))
    out = (
        p[..., 1: 2 + 2 * m: 2]
        + 0.5 * (p[..., 0: 1 + 2 * m: 2] + p[..., 2: 3 + 2 * m: 2])
    )
    return torch.movedim(out, -1, axis)


def prolong(c: torch.Tensor) -> torch.Tensor:
    """(bs, nzc+1, nyc+1, nxc+1) -> fine, trilinear."""
    for ax in (1, 2, 3):
        c = _prolong_axis(c, ax)
    return c


def restrict(rf: torch.Tensor) -> torch.Tensor:
    """Exact transpose of :func:`prolong`."""
    for ax in (3, 2, 1):
        rf = _restrict_axis(rf, ax)
    return rf


def _inject(f):
    return f[..., ::2, ::2, ::2].contiguous()


def _coarsen_cell_field(f):
    nz, ny, nx = f.shape[-3:]
    return f.reshape(
        f.shape[:-3] + (nz // 2, 2, ny // 2, 2, nx // 2, 2)
    ).mean(dim=(-5, -3, -1))


def coarsen_grid(grid: StructuredGrid3D) -> StructuredGrid3D:
    return StructuredGrid3D(
        nx=grid.nx // 2, ny=grid.ny // 2, nz=grid.nz // 2,
        hx=grid.hx * 2, hy=grid.hy * 2, hz=grid.hz * 2, bs=grid.bs,
        energy_density=grid.energy_density,
        field_kinds=grid.field_kinds,
    )


def _coarsen_fields(grid, fields):
    out = {}
    for name, kind in grid.field_kinds.items():
        f = fields[name]
        out[name] = _inject(f) if kind == "vertex" else _coarsen_cell_field(f)
    return out


def build_mg3d(
    grid: StructuredGrid3D,
    u_lin: torch.Tensor,
    fields: Dict[str, torch.Tensor],
    free: torch.Tensor,
    *,
    matvec_factory: Optional[Callable] = None,
) -> Tuple[Tuple[StructuredGrid3D, ...], MGData]:
    """Build the hierarchy at the current linearization state: coarsens
    while nx, ny, nz stay even and >= 4 and the level is above
    ``COARSE_DOFS``; the coarsest operator is materialized dense.

    ``matvec_factory``: optional callable level grid -> raw linear matvec
    or None (``make_grid_solver``'s ``mg_matvec_factory``). A level with a
    matvec stores no stencil (``MGLevel.op`` is None): the V-cycle must
    then be given that matvec (``vcycle(matvecs=)``)."""
    grids = [grid]
    levels = []
    g, u, flds, fr = grid, u_lin, fields, free
    while (
        g.nx % 2 == 0 and g.ny % 2 == 0 and g.nz % 2 == 0
        and min(g.nx, g.ny, g.nz) >= 4
        and u.numel() > COARSE_DOFS
    ):
        raw = matvec_factory(g) if matvec_factory is not None else None
        if raw is None:
            op = g.operator(u, flds, fr)
            inv_d, lmax = level_smoother_data(op, fr, POWER_ITERS)
        else:
            op = None
            d = g.diagonal(u, flds) * fr + (1.0 - fr)
            one = torch.ones_like(d)
            inv_d = torch.where(d != 0, 1.0 / torch.where(d == 0, one, d),
                                one)
            fixed = 1.0 - fr

            def A(v, raw=raw, fr=fr, fixed=fixed):
                return raw(v * fr) * fr + v * fixed

            lmax = power_lambda_max(A, inv_d, fr, POWER_ITERS)
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


def vcycle(data: MGData, b: torch.Tensor, *, degree: int = 3,
           matvecs=None) -> torch.Tensor:
    """One symmetric V(degree,degree)-cycle on the level operators of
    ``data`` (from build_mg3d). ``matvecs``: optional per-level raw
    linear operators (e.g. the K8 constant-stencil matvec,
    structured.kernels3d) replacing the stored stencil in the smoothers --
    the fine level dominates the cycle's cost; a level built without a
    stencil needs its matvec here."""
    return cycle(data, b, prolong, restrict, degree=degree,
                 lmin_ratio=LMIN_RATIO, matvecs=matvecs)
