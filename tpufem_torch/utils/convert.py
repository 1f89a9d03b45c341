"""State handed over as numpy: plans, coefficient vectors, lane states.

A port engine can be built on a plan that another planner produced (for
instance the JAX package's, in the comparison tests) by passing its
fields through :func:`lane_plan_from_numpy` and the ``plan=`` keyword of
``LaneEngine``; :func:`to_torch` uploads any array-like. The cell data a
fused engine streams into ``lane_fused_elem`` travels the same way:
:func:`fused_cell_data` reads it off any engine as numpy and
:func:`set_fused_cell_data` puts it on a port engine. The two-level
preconditioner's tables and lattice-MG hierarchy travel through
:func:`twolevel_from_numpy`, so a comparison can feed the port and the
reference identical tables and check the cycle apart from the host build.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from tpufem_torch.lane.plan import LanePlan


def lane_plan_fields(plan: Any) -> Dict[str, Any]:
    """The fields of a lane plan (any object with LanePlan's attributes)
    as a plain dict of numpy arrays / ints / pass lists."""
    return {f.name: getattr(plan, f.name)
            for f in dataclasses.fields(LanePlan)}


def lane_plan_from_numpy(fields: Dict[str, Any]) -> LanePlan:
    """Build a :class:`LanePlan` from a dict of its fields (numpy arrays,
    ints, and the pass lists of (p, q, idx, start, wr) tuples)."""
    names = {f.name for f in dataclasses.fields(LanePlan)}
    unknown = set(fields) - names
    if unknown:
        raise KeyError(f"not LanePlan fields: {sorted(unknown)}")
    return LanePlan(**fields)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def fused_cell_data(engine: Any, coeff_cells: Dict[str, Any]) -> Dict[str, Any]:
    """The cell data of a fused lane engine as numpy: ``fused_geom``
    (G, Dg, kc, 128) and, when the engine has coefficients, the ``_cd``
    block (G, Dc, kc, 128) of its ``prepare_coeffs`` result. Works on
    any engine with these attributes (torch tensors or arrays that
    ``np.asarray`` takes)."""
    out = {"fused_geom": _numpy(engine.fused_geom)}
    if "_cd" in coeff_cells:
        out["_cd"] = _numpy(coeff_cells["_cd"])
    return out


def set_fused_cell_data(engine, coeff_cells: Dict[str, torch.Tensor],
                        fields: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Put cell data read by :func:`fused_cell_data` (from another
    engine on the same plan) on a fused port engine: sets
    ``engine.fused_geom`` and returns ``coeff_cells`` with its ``_cd``
    entry replaced. Shapes must match the engine's own."""
    geom = to_torch(fields["fused_geom"], engine.device, engine.dtype)
    if geom.shape != engine.fused_geom.shape:
        raise ValueError(f"fused_geom {tuple(geom.shape)} does not fit the "
                         f"engine's {tuple(engine.fused_geom.shape)}")
    engine.fused_geom = geom
    out = dict(coeff_cells)
    if "_cd" in fields:
        cd = to_torch(fields["_cd"], engine.device, engine.dtype)
        if "_cd" not in out or cd.shape != out["_cd"].shape:
            raise ValueError("_cd does not fit the engine's coefficient "
                             "block")
        out["_cd"] = cd
    return out


def twolevel_from_numpy(engine, static: Dict[str, Any], geo: Dict[str, Any],
                        *, hx: float, hy: float, field_kinds: Dict[str, str],
                        inv_d, lmax):
    """The port's two-level structures from numpy.

    ``static``: the integer fields of a ``TwoLevelStatic`` (SC, WRp, WRr,
    Kc, ncx, ncy, Rv, degree). ``geo``: the transfer tables (S, p_starts,
    p_idx, p_wts, r_starts, r_idx, r_wts, o_dst, o_src), ``coarse_free``
    and ``mg_data`` = dict(levels=[dict(u_lin, fields, free, inv_d,
    lmax), ...], coarse_inv, coarse_free). ``hx``, ``hy``: the finest
    lattice spacing; ``field_kinds``: coefficient name -> 'vertex' |
    'cell'. ``inv_d``, ``lmax``: the fine smoother data. Each level's
    operator is linearized from its ``u_lin`` and ``fields`` by the
    port's own lattice discretization of ``engine.functional``; every
    array keeps its values (float arrays in the engine's dtype). Returns
    ``(TwoLevelStatic, TwoLevelData)``."""
    from tpufem_torch.lane import twolevel as tl
    from tpufem_torch.structured import mg2d

    dev, dt = engine.device, engine.dtype

    def up(a):
        return to_torch(a, dev, dt)

    grid = tl.lattice_grid(engine.functional, engine.bs, field_kinds,
                           hx=hx, hy=hy, ncx=int(static["ncx"]),
                           ncy=int(static["ncy"]))
    levels = []
    for lv in geo["mg_data"]["levels"]:
        u, free = up(lv["u_lin"]), up(lv["free"])
        fields = {k: up(v) for k, v in lv["fields"].items()}
        levels.append(mg2d.MGLevel(
            u_lin=u, fields=fields, free=free, inv_d=up(lv["inv_d"]),
            lmax=float(np.asarray(lv["lmax"])),
            op=grid.operator(u, fields, free)))
        grid = mg2d.coarsen_grid(grid)
    mg = mg2d.MGData(levels=tuple(levels),
                     coarse_inv=up(geo["mg_data"]["coarse_inv"]),
                     coarse_free=up(geo["mg_data"]["coarse_free"]))
    st = tl.TwoLevelStatic(
        **{k: int(static[k]) for k in ("SC", "WRp", "WRr", "Kc", "ncx",
                                       "ncy", "Rv", "degree")})
    tables = {k: _numpy(geo[k]) for k in (
        "S", "p_starts", "p_idx", "p_wts", "r_starts", "r_idx", "r_wts",
        "o_dst", "o_src")}
    return st, tl.TwoLevelData(
        **tl.upload_tables(engine, tables), mg_data=mg,
        coarse_free=up(geo["coarse_free"]), inv_d=up(inv_d),
        lmax=float(np.asarray(lmax)))


def to_torch(array_like, device=None, dtype=None) -> torch.Tensor:
    """Upload an array-like (numpy array, list, JAX array exported through
    ``np.asarray``) as a tensor on ``device`` (default CUDA)."""
    from tpufem_torch.config import resolve_device

    return torch.as_tensor(
        np.asarray(array_like), dtype=dtype, device=resolve_device(device)
    )
