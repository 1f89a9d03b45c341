"""The lane engine's generic element path: every functional that neither
the P1 nor the multi-quadrature-point specialization takes -- cell terms
of several quadrature degrees (the reference study's own functional: the
damage energy at degree 1 and the volumetric load at degree 2), terms
that read coefficient gradients, a functional with no cell term.

Host side, :func:`x_lane_host` (``tpufem/lane/engine.py:132-145``): the
vertex coordinates of every lane cell, (nvg, gdim, M), from the mesh
arrays (padding cells take cell 0's, as every lane table does).

Device side, :class:`GenericPhysics`: the functional's scalarized element
energy (``EnergyFunctional.element_energy_fn_elementwise``) under
``torch.func.vmap`` over the gathered cells (nd, M) -- ``grad`` for the
residual, ``hessian`` for the element matrices (nd, nd, M). The reference
takes a ``vmap(jvp(grad))`` per tangent application and a ``vmap(hessian)``
per diagonal; here the element matrices are taken once per Newton step
(``linearize``) and serve both: a tangent application is one
multiply-sum over them, the diagonal their diagonal. The AD runs in cell
slabs of ``GENERIC_BATCH`` cells (65 536, as the flat ``Assembler``'s callers
pass), so that its temporaries are bounded by one slab; the reference
runs all M cells in one XLA program.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch.func import grad, hessian, vmap

# cells per slab of the element AD (the flat solvers' ELEMENT_BATCH)
GENERIC_BATCH = 1 << 16


def x_lane_host(mesh, safe_order: np.ndarray) -> np.ndarray:
    """(nvg, gdim, M) float64 vertex coordinates of the lane cells
    ``safe_order`` (mesh cell of each lane cell), by per-component 1-D
    gathers straight into the cells-minor layout."""
    cells = np.asarray(mesh.cells)
    nvg, gdim = cells.shape[1], mesh.x.shape[1]
    xT = [np.ascontiguousarray(mesh.x[:, d], dtype=np.float64)
          for d in range(gdim)]
    out = np.empty((nvg, gdim, len(safe_order)))
    for v in range(nvg):
        col = cells[:, v][safe_order]
        for d in range(gdim):
            out[v, d] = xT[d][col]
    return out


class GenericPhysics:
    """Residual, energy, element matrices, tangent application and
    diagonal of the generic path on (nd, M) cells-minor element data;
    ``x`` (nvg, gdim, M) is the engine's ``x_lane`` at the state's
    dtype."""

    def __init__(self, functional, coeff_names: Sequence[str]):
        self.energy_fn = functional.element_energy_fn_elementwise()
        self.coeff_names = tuple(coeff_names)
        self.batch = GENERIC_BATCH

    def _slabs(self, kernel, u_cells, x, coeffs, out):
        """out[..., lo:hi] = kernel(u, x, coeffs) slab by slab."""
        cc = {k: coeffs[k] for k in self.coeff_names}
        M = u_cells.shape[-1]
        for lo in range(0, M, self.batch):
            hi = min(lo + self.batch, M)
            out[..., lo:hi] = kernel(
                u_cells[:, lo:hi], x[..., lo:hi],
                {k: v[..., lo:hi] for k, v in cc.items()})
        return out

    def residual(self, u_cells, coeffs: Dict[str, torch.Tensor],
                 x) -> torch.Tensor:
        """(nd, M) element vectors."""
        g = vmap(grad(self.energy_fn), in_dims=(-1, -1, -1), out_dims=-1)
        return self._slabs(g, u_cells, x, coeffs, torch.empty_like(u_cells))

    def energy(self, u_cells, coeffs, x) -> torch.Tensor:
        """(M,) element energies."""
        e = vmap(self.energy_fn, in_dims=(-1, -1, -1))
        return self._slabs(e, u_cells, x, coeffs,
                           u_cells.new_empty(u_cells.shape[-1]))

    def linearize(self, u_cells, coeffs, x) -> torch.Tensor:
        """(nd, nd, M) element matrices at a frozen state."""
        nd, M = u_cells.shape
        h = vmap(hessian(self.energy_fn), in_dims=(-1, -1, -1), out_dims=-1)
        return self._slabs(h, u_cells, x, coeffs,
                           u_cells.new_empty((nd, nd, M)))

    @staticmethod
    def apply(em, v_cells, _geom=None) -> torch.Tensor:
        """Tangent element vectors: (em * v).sum over the columns."""
        return torch.sum(em * v_cells.unsqueeze(0), dim=1)

    @staticmethod
    def diagonal(em, _geom=None) -> torch.Tensor:
        """(nd, M) diagonals of the element matrices."""
        return torch.diagonal(em, dim1=0, dim2=1).T.contiguous()
