"""Assembler: residual / tangent-action / diagonal / energy of a functional
on the flat (cell-major) layout.

Maps the reference's assembly contract (FEniCSx/mechanic2d/
asym_elasto_damage_model.cc:816-867) onto PyTorch:

- ``residual``        <-> fem::assemble_vector over ffcx vector kernels (:825)
- ``tangent_action``  <-> matrix-free J.v (what MFEM's GetGradient + Mult
                        compute without ever forming sparse J)

All element kernels come from ``torch.func.grad`` / ``hessian`` / ``jvp``
of the single element-energy function (see tpufem_torch.forms.form),
batched over cells by ``torch.func.vmap``. Scatter is a padded
gather-sum, deterministic by construction. The assembled sparse matrix
(``matrix()``) and the Dirichlet lifting helpers are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, hessian, jvp, vmap

from tpufem_torch.assemble.scatter import GatherSumPlan
from tpufem_torch.forms.form import EnergyFunctional
from tpufem_torch.spaces.bc import DirichletBC, combine_bcs


def _map_cell_slabs(fn, args, batch):
    """Evaluate a cells-minor batched kernel slab-by-slab.

    ``args`` is a tuple of cells-minor tensors ``(..., nc)`` or dicts of
    them; ``fn`` maps a slab ``(..., b)`` to outputs ``(..., b)`` (one
    tensor or a tuple). Slabs of ``batch`` cells (the last one shorter)
    are evaluated in turn and concatenated, so the AD temporaries are
    bounded by one slab instead of the whole mesh.
    """
    def cut(a, lo, hi):
        if isinstance(a, dict):
            return {k: v[..., lo:hi] for k, v in a.items()}
        return a[..., lo:hi]

    first = next(a for a in args if not isinstance(a, dict))
    nc = first.shape[-1]
    outs = []
    for lo in range(0, nc, batch):
        outs.append(fn(tuple(cut(a, lo, lo + batch) for a in args)))
    if isinstance(outs[0], tuple):
        return tuple(
            torch.cat([o[i] for o in outs], dim=-1)
            for i in range(len(outs[0]))
        )
    return torch.cat(outs, dim=-1)


class Assembler:
    def __init__(self, functional: EnergyFunctional,
                 bcs: Sequence[DirichletBC] = ()):
        self.functional = functional
        self.space = functional.space
        self.device = functional.device
        self.n_dofs = self.space.n_dofs
        self._energy_fn = functional.element_energy_fn()

        # residual reduction plan: element outputs are cells-minor
        # (nd, nc): flat source index of entry (cell, slot) is
        # slot*nc + cell -> build from dm.T.
        dm = np.asarray(functional.vec_dofmap)
        self._r_plan = GatherSumPlan.build(
            dm.T.ravel(), self.n_dofs, device=self.device
        )

        # BCs
        self.bcs = list(bcs)
        if self.bcs:
            bc_dofs, _, bc_mask = combine_bcs(self.bcs, self.n_dofs)
        else:
            bc_dofs = np.zeros(0, dtype=np.int32)
            bc_mask = np.zeros(self.n_dofs, dtype=bool)
        self.bc_dofs = torch.as_tensor(
            np.asarray(bc_dofs), dtype=torch.int64, device=self.device
        )
        self._free_dev = torch.as_tensor(
            (~bc_mask).astype(np.float64), device=self.device
        )

    # -- helpers -------------------------------------------------------------

    def free_mask(self, dtype) -> torch.Tensor:
        """1.0 on unconstrained dofs, 0.0 on Dirichlet dofs."""
        return self._free_dev.to(dtype)

    def _cell_args(self, u, coeffs):
        f = self.functional
        return (f.gather(u), f.x_cells.to(u.dtype), f.gather_coeffs(coeffs))

    def _batched(self, kernel, args, batch):
        if not batch or args[0].shape[-1] <= batch:
            return kernel(*args)
        return _map_cell_slabs(lambda a: kernel(*a), args, batch)

    # -- element-level batched kernels ----------------------------------------

    def element_vectors(self, u, coeffs: Dict[str, torch.Tensor],
                        batch: Optional[int] = None):
        """(ndofe, nc) element residual vectors = dPi_e/du_e (the ffcx
        'tabulate_tensor vector kernel' analog), cells-minor layout.

        ``batch``: evaluate in cell slabs of this size (bounds the AD
        temporaries at multi-million-cell scale); None = one batch."""
        g = vmap(grad(self._energy_fn), in_dims=(-1, -1, -1), out_dims=-1)
        return self._batched(g, self._cell_args(u, coeffs), batch)

    def element_matrices(self, u, coeffs: Dict[str, torch.Tensor],
                         batch: Optional[int] = None):
        """(ndofe, ndofe, nc) consistent element tangents = d2Pi_e/du_e2
        -- replaces the nested-dual Hessian of admfem.hpp:672-699 and the
        hand-derived d(psi)/dL tangents of MFEM/...cc:766-871."""
        h = vmap(hessian(self._energy_fn), in_dims=(-1, -1, -1),
                 out_dims=-1)
        return self._batched(h, self._cell_args(u, coeffs), batch)

    # -- global assembly -------------------------------------------------------

    def energy(self, u, coeffs, batch: Optional[int] = None) -> torch.Tensor:
        """Total potential Pi(u) (useful for validation/line search)."""
        e_fn = vmap(self._energy_fn, in_dims=(-1, -1, -1))
        return torch.sum(
            self._batched(e_fn, self._cell_args(u, coeffs), batch)
        )

    def residual(self, u, coeffs,
                 batch: Optional[int] = None) -> torch.Tensor:
        """Assembled residual F(u) (no BC treatment)."""
        ev = self.element_vectors(u, coeffs, batch=batch)
        return self._r_plan.apply(ev)

    def tangent_action(self, u, coeffs, v) -> torch.Tensor:
        """Matrix-free J(u).v via jvp of the assembled residual."""
        f = lambda w: self.residual(w, coeffs)
        return jvp(f, (u,), (v,))[1]

    def matrix(self, u, coeffs, batch: Optional[int] = None):
        raise NotImplementedError(
            "assembled sparse Jacobian is not ported yet (ROADMAP.md: "
            "tpufem_torch.assemble.pattern / Assembler.matrix)"
        )

    def diagonal(self, u, coeffs) -> torch.Tensor:
        """Jacobian diagonal (for Jacobi PC) without forming the matrix:
        element Hessian diagonals scattered; 1.0 on bc dofs."""
        em = self.element_matrices(u, coeffs)
        ed = torch.diagonal(em, dim1=0, dim2=1).T  # (ndofe, nc)
        diag = self._r_plan.apply(ed.contiguous())
        if len(self.bc_dofs):
            free = self.free_mask(diag.dtype)
            diag = diag * free + (1.0 - free)
        return diag
