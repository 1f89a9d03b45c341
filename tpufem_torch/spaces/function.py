"""Function: a field over a FunctionSpace (a tensor + metadata).

Equivalent of ``dolfinx::fem::Function`` with raw ``mutable_array`` access
(FEniCSx/mechanic2d/asym_elasto_damage_model.cc:317-319, 379),
``mfem::ParGridFunction`` and ``tpufem.spaces.function``. Values live as
a flat tensor of length ``space.n_dofs`` (byVDIM interleaved for vector
spaces) on ``device`` (default CUDA) in ``dtype`` (default float32).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tpufem_torch.config import DEFAULT_DTYPE, resolve_device
from tpufem_torch.spaces.space import FunctionSpace


class Function:
    def __init__(self, space: FunctionSpace, name: str = "f", dtype=None,
                 *, device=None):
        self.space = space
        self.name = name
        self.dtype = dtype or DEFAULT_DTYPE
        self.device = resolve_device(device)
        self.x = torch.zeros(space.n_dofs, dtype=self.dtype,
                             device=self.device)

    def interpolate(self, fn: Callable[[np.ndarray], np.ndarray]
                    ) -> "Function":
        """Set nodal values from a callable on dof coordinates.

        ``fn`` maps (n_points, gdim) -> (n_points,) for scalar spaces or
        (n_points, bs) for vector spaces -- the analog of
        ``Function::interpolate(lambda)`` (FEniCSx/...cc:563-585) and
        ``ProjectCoefficient`` (MFEM/...cc:1446-1447). Works for Lagrange
        spaces where dofs are point evaluations.
        """
        coords = self.space.dof_coords
        vals = np.asarray(fn(coords))
        if self.space.bs == 1:
            flat = vals.reshape(-1)
        else:
            flat = vals.reshape(self.space.n_scalar_dofs,
                                self.space.bs).reshape(-1)
        self.x = torch.as_tensor(flat, dtype=self.dtype, device=self.device)
        return self

    def set(self, value: float) -> "Function":
        self.x = torch.full((self.space.n_dofs,), value, dtype=self.dtype,
                            device=self.device)
        return self

    def values(self) -> np.ndarray:
        """Host copy, shape (n_scalar_dofs, bs) for vector spaces."""
        arr = self.x.cpu().numpy()
        if self.space.bs > 1:
            return arr.reshape(-1, self.space.bs)
        return arr
