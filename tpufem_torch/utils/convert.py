"""State handed over as numpy: plans, coefficient vectors, lane states.

A port engine can be built on a plan that another planner produced (for
instance the JAX package's, in the comparison tests) by passing its
fields through :func:`lane_plan_from_numpy` and the ``plan=`` keyword of
``LaneEngine``; :func:`to_torch` uploads any array-like.
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


def to_torch(array_like, device=None, dtype=None) -> torch.Tensor:
    """Upload an array-like (numpy array, list, JAX array exported through
    ``np.asarray``) as a tensor on ``device`` (default CUDA)."""
    from tpufem_torch.config import resolve_device

    return torch.as_tensor(
        np.asarray(array_like), dtype=dtype, device=resolve_device(device)
    )
