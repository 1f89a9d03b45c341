"""State handed over as numpy: plans, coefficient vectors, lane states.

A port engine can be built on a plan that another planner produced (for
instance the JAX package's, in the comparison tests) by passing its
fields through :func:`lane_plan_from_numpy` and the ``plan=`` keyword of
``LaneEngine``; :func:`to_torch` uploads any array-like. The cell data a
fused engine streams into ``lane_fused_elem`` travels the same way:
:func:`fused_cell_data` reads it off any engine as numpy and
:func:`set_fused_cell_data` puts it on a port engine.
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


def to_torch(array_like, device=None, dtype=None) -> torch.Tensor:
    """Upload an array-like (numpy array, list, JAX array exported through
    ``np.asarray``) as a tensor on ``device`` (default CUDA)."""
    from tpufem_torch.config import resolve_device

    return torch.as_tensor(
        np.asarray(array_like), dtype=dtype, device=resolve_device(device)
    )
