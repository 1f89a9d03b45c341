"""Assembler: residual / tangent-action / diagonal / energy of a functional
on the flat (cell-major) layout.

Maps the reference's assembly contract (FEniCSx/mechanic2d/
asym_elasto_damage_model.cc:816-867) onto PyTorch:

- ``residual``        <-> fem::assemble_vector over ffcx vector kernels (:825)
- ``matrix``          <-> fem::assemble_matrix + set_diagonal (:852-859)
- ``tangent_action``  <-> matrix-free J.v (what MFEM's GetGradient + Mult
                        compute without ever forming sparse J)
- ``lifted_rhs`` / ``constrained_action`` / ``set_bc`` <-> the identity-row
  Dirichlet method (doc.tex:1670-1741): b <- b - J.(g - x0) on interior
  rows, then b[bc] = g - x0[bc]; J rows/cols zeroed with unit diagonal.

All element kernels come from ``torch.func.grad`` / ``hessian`` / ``jvp``
of the single element-energy function (see tpufem_torch.forms.form),
batched over cells by ``torch.func.vmap``. Scatter -- into the
residual's dofs and into the sparse matrix's nnz slots alike -- is a
padded gather-sum, deterministic by construction.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, jvp, vmap

from tpufem_torch.assemble.pattern import EllMatrix, SparsityPattern
from tpufem_torch.assemble.scatter import GatherSumPlan, SubsetSumPlan
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


class ElementTangent(NamedTuple):
    """The tangent J(u) of a functional, linearized once: the cell part
    and, per facet term, the facet Hessians (nf, ndf, ndf). The cell part
    is the element matrices (ndofe, ndofe, nc) in ``Assembler.linearize``
    and the lane path's per-cell Hessian (reduced-variable tables or
    element matrices) in ``LaneEngine.linearize``."""

    cells: object
    facets: Tuple[torch.Tensor, ...] = ()


class Assembler:
    def __init__(self, functional: EnergyFunctional,
                 bcs: Sequence[DirichletBC] = ()):
        self.functional = functional
        self.space = functional.space
        self.device = functional.device
        self.n_dofs = self.space.n_dofs
        self._energy_fn = functional.element_energy_fn()
        # facet terms: (energy, dofmap, x_f, normals) per term; their
        # vectors are added into the dofs by one fixed-order plan
        self._facet_fns = functional.facet_energy_fns()
        self._facet_plan = self._facet_nnz_plan = None
        if self._facet_fns:
            fdofs = np.concatenate([blk["dofmap"].ravel()
                                    for blk in functional._facet_static])
            self._facet_plan = SubsetSumPlan.build(
                fdofs, np.arange(len(fdofs)), len(fdofs), device=self.device)

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
            bc_dofs, bc_vals, bc_mask = combine_bcs(self.bcs, self.n_dofs)
        else:
            bc_dofs = np.zeros(0, dtype=np.int32)
            bc_vals = np.zeros(0)
            bc_mask = np.zeros(self.n_dofs, dtype=bool)
        self.bc_dofs = torch.as_tensor(
            np.asarray(bc_dofs), dtype=torch.int64, device=self.device
        )
        self.bc_vals_np = bc_vals
        self._bc_vals_dev = torch.as_tensor(bc_vals, dtype=torch.float64,
                                            device=self.device)
        self._free_dev = torch.as_tensor(
            (~bc_mask).astype(np.float64), device=self.device
        )

        # sparsity (lazy: built by the first ``pattern`` / ``matrix``)
        self._pattern: Optional[SparsityPattern] = None
        self._nnz_plan: Optional[GatherSumPlan] = None
        self._ell_slots_T = None
        self._ell_cols_T = None
        self._pat_rows = None
        self._pat_cols = None

    # -- helpers -------------------------------------------------------------

    def bc_values(self, dtype) -> torch.Tensor:
        return self._bc_vals_dev.to(dtype)

    def free_mask(self, dtype) -> torch.Tensor:
        """1.0 on unconstrained dofs, 0.0 on Dirichlet dofs."""
        return self._free_dev.to(dtype)

    @property
    def pattern(self) -> SparsityPattern:
        """The matrix's sparsity (host tables, built once), with the
        gather-sum plan element entry -> nnz slot and the ELL tables on
        the device."""
        if self._pattern is None:
            dm = np.asarray(self.functional.vec_dofmap)
            # the sorts run where the assembler lives
            pat = SparsityPattern.from_dofmap(dm, self.n_dofs,
                                              device=self.device)
            as_dev = lambda a: torch.as_tensor(  # noqa: E731
                np.ascontiguousarray(a), dtype=torch.int32,
                device=self.device)
            # gather plan: element-matrix entry -> nnz slot, for the
            # cells-minor (nd, nd, nc) layout: flat source of (c, i, j)
            # is (i*nd + j)*nc + c
            entry_slots = torch.empty(len(pat.perm), dtype=torch.int32,
                                      device=self.device)
            entry_slots[as_dev(pat.perm).long()] = as_dev(pat.sorted_slots)
            nc, nd = dm.shape
            slots_T = entry_slots.reshape(nc, nd * nd).T.contiguous()
            del entry_slots
            self._nnz_plan = GatherSumPlan.build(slots_T, pat.nnz,
                                                 device=self.device)
            del slots_T
            # device-resident int32 tables (ELL rows-minor)
            self._ell_slots_T = as_dev(pat.ell_slots.T)
            self._ell_cols_T = as_dev(pat.ell_cols.T)
            self._pat_rows = as_dev(pat.rows)
            self._pat_cols = as_dev(pat.cols)
            if self._facet_fns:
                self._facet_nnz_plan = self._facet_slots(pat)
            self._pattern = pat
        return self._pattern

    def _facet_slots(self, pat: SparsityPattern) -> SubsetSumPlan:
        """The plan of the facet Hessians' entries (facet, i, j) into their
        nnz slots. All dofs of a facet lie in its owner cell, so every pair
        is in the cell sparsity; the slots are found on the host by
        searchsorted on the (row, col) keys, which the pattern keeps
        sorted (the reference does it on the device,
        ``tpufem/assemble/assembler.py:158-185``)."""
        n = np.int64(self.n_dofs)
        key = pat.rows.astype(np.int64) * n + pat.cols.astype(np.int64)
        pk = np.concatenate([
            (blk["dofmap"][:, :, None] * n + blk["dofmap"][:, None, :]).ravel()
            for blk in self.functional._facet_static])
        slots = np.minimum(np.searchsorted(key, pk), len(key) - 1)
        if not np.array_equal(key[slots], pk):
            raise AssertionError("facet dof pair missing from sparsity")
        return SubsetSumPlan.build(slots, np.arange(len(slots)), len(slots),
                                   device=self.device)

    # -- facet terms ----------------------------------------------------------

    def _facet_args(self, u):
        """(energy, u at the facet dofs, x_f, normals) per facet term, at
        u's dtype."""
        return [(fn, u[dm], x_f.to(u.dtype), nrm.to(u.dtype))
                for fn, dm, x_f, nrm in self._facet_fns]

    def facet_vectors(self, u) -> torch.Tensor:
        """The facet terms' element vectors, every term's (nf * ndf,)
        flattened and concatenated: what ``_facet_plan`` adds."""
        return torch.cat([vmap(grad(fn))(uf, xf, nf).reshape(-1)
                          for fn, uf, xf, nf in self._facet_args(u)])

    def facet_matrices(self, u) -> Tuple[torch.Tensor, ...]:
        """Per facet term, the facet Hessians (nf, ndf, ndf) at ``u``."""
        return tuple(vmap(hessian(fn))(uf, xf, nf)
                     for fn, uf, xf, nf in self._facet_args(u))

    def _tangent_parts(self, em):
        """(cell element matrices, facet Hessians) of ``em``: an
        ``ElementTangent``, or the cell matrices alone for a functional
        without facet terms. For one with facet terms the cell matrices
        alone raise: the facet tangent is never dropped."""
        if isinstance(em, ElementTangent):
            return em.cells, em.facets
        if self._facet_fns:
            raise ValueError(
                "the functional has facet terms: pass what "
                "Assembler.linearize returned (cell and facet parts), not "
                "the cell element matrices alone")
        return em, ()

    def _facet_bmm(self, facets, v):
        """Per facet term H_f v_f, flattened and concatenated."""
        return torch.cat([
            torch.bmm(H, v[dm].unsqueeze(-1)).reshape(-1)
            for H, (_fn, dm, _x, _n) in zip(facets, self._facet_fns)])

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

    def linearize(self, u, coeffs: Dict[str, torch.Tensor],
                  batch: Optional[int] = None) -> ElementTangent:
        """J(u) taken once: the cell element matrices (``batch``: in cell
        slabs of this size) and the facet Hessians. What
        ``element_action``, ``constrained_action`` and ``diagonal`` take
        as ``em``."""
        return ElementTangent(self.element_matrices(u, coeffs, batch=batch),
                              self.facet_matrices(u))

    # -- global assembly -------------------------------------------------------

    def energy(self, u, coeffs, batch: Optional[int] = None) -> torch.Tensor:
        """Total potential Pi(u) (useful for validation/line search)."""
        e_fn = vmap(self._energy_fn, in_dims=(-1, -1, -1))
        total = torch.sum(
            self._batched(e_fn, self._cell_args(u, coeffs), batch)
        )
        for fn, uf, xf, nf in self._facet_args(u):
            total = total + torch.sum(vmap(fn)(uf, xf, nf))
        return total

    def residual(self, u, coeffs,
                 batch: Optional[int] = None) -> torch.Tensor:
        """Assembled residual F(u) (no BC treatment), facet terms
        included."""
        ev = self.element_vectors(u, coeffs, batch=batch)
        r = self._r_plan.apply(ev)
        if self._facet_fns:
            r = self._facet_plan.add_into(r, self.facet_vectors(u))
        return r

    def tangent_action(self, u, coeffs, v) -> torch.Tensor:
        """Matrix-free J(u).v via jvp of the assembled residual."""
        f = lambda w: self.residual(w, coeffs)
        return jvp(f, (u,), (v,))[1]

    def element_action(self, em, v) -> torch.Tensor:
        """J.v from J taken once: ``em`` is what ``linearize`` returned
        (or, for a functional without facet terms, the element matrices
        (ndofe, ndofe, nc) alone): gather v to the cells, the per-cell
        products, the residual's gather-sum, then the facet Hessians'
        products added by the facet plan. The same operator as
        ``tangent_action`` at the state ``em`` was taken at, to rounding,
        with no differentiation per application."""
        cells, facets = self._tangent_parts(em)
        v_cells = self.functional.gather(v)  # (ndofe, nc)
        y = self._r_plan.apply(torch.sum(cells * v_cells[None], dim=1))
        if facets:
            y = self._facet_plan.add_into(y, self._facet_bmm(facets, v),
                                          inplace=True)
        return y

    def matrix(self, u, coeffs, batch: Optional[int] = None) -> EllMatrix:
        """Assembled sparse Jacobian in ELL form, with Dirichlet rows
        zeroed and unit diagonal (assemble_matrix + set_diagonal
        semantics, FEniCSx/...cc:852-857). Columns for bc dofs are also
        zeroed (symmetric elimination) so CG keeps an SPD operator. The
        element entries are summed into their nnz slots by the
        gather-sum plan of ``pattern``: a fixed order, no atomics; the
        facet Hessians likewise into theirs (the exact tangent of a
        nonlinear facet energy; zero for a linear traction).
        ``batch``: the element matrices in cell slabs of this size."""
        pat = self.pattern
        em = self.element_matrices(u, coeffs, batch=batch)
        nnz_vals = self._nnz_plan.apply(em)
        del em
        if self._facet_fns:
            fh = torch.cat([H.reshape(-1) for H in self.facet_matrices(u)])
            nnz_vals = self._facet_nnz_plan.add_into(nnz_vals, fh,
                                                     inplace=True)
        if len(self.bc_dofs):
            rows, cols = self._pat_rows, self._pat_cols
            free = self.free_mask(nnz_vals.dtype)
            free_r = free.index_select(0, rows)
            keep = free_r * free.index_select(0, cols)
            diag = (rows == cols) & (free_r == 0.0)
            nnz_vals = nnz_vals * keep + diag.to(nnz_vals.dtype)
        # scatter nnz slots into the padded ELL layout (rows-minor)
        padded = torch.cat([nnz_vals, nnz_vals.new_zeros(1)])
        slots = self._ell_slots_T
        return EllMatrix(n_rows=pat.n_rows, cols=self._ell_cols_T,
                         vals=padded.index_select(0, slots.reshape(-1))
                         .view(slots.shape))

    def diagonal(self, u, coeffs, em=None) -> torch.Tensor:
        """Jacobian diagonal (for Jacobi PC) without forming the matrix:
        element and facet Hessian diagonals scattered; 1.0 on bc dofs.
        ``em``: J at ``u`` (``linearize``), if the caller has it already."""
        if em is None:
            em = self.linearize(u, coeffs)
        cells, facets = self._tangent_parts(em)
        ed = torch.diagonal(cells, dim1=0, dim2=1).T  # (ndofe, nc)
        diag = self._r_plan.apply(ed.contiguous())
        if facets:
            fd = torch.cat([torch.diagonal(H, dim1=1, dim2=2).reshape(-1)
                            for H in facets])
            diag = self._facet_plan.add_into(diag, fd, inplace=True)
        if len(self.bc_dofs):
            free = self.free_mask(diag.dtype)
            diag = diag * free + (1.0 - free)
        return diag

    # -- Dirichlet application (dolfinx contract) -------------------------------

    def lifted_rhs(self, u, coeffs, r=None):
        """Newton right-hand side with Dirichlet lifting.

        Builds b such that solving A^ delta = b (with A^ = M J M + (I-M), M
        the free-dof projector) yields the constrained Newton step:
        b_free = -r - J.w, b_bc = w, where w[bc] = g - u[bc] (zero
        elsewhere). This is apply_lifting(b,{J},{bc},{u},-1) + set_bc
        (FEniCSx/...cc:825-836) expressed matrix-free.
        """
        if r is None:
            r = self.residual(u, coeffs)
        free = self.free_mask(u.dtype)
        w = torch.zeros_like(u)
        if len(self.bc_dofs):
            w[self.bc_dofs] = self.bc_values(u.dtype) - u[self.bc_dofs]
        Jw = self.tangent_action(u, coeffs, w)
        return (-r - Jw) * free + w

    def constrained_action(self, u, coeffs, em):
        """Returns v -> A^ v = M J M v + (I-M) v (SPD if J is), J.v by
        ``element_action`` from ``em``, J(u) as ``linearize`` returns it: J
        linearized once, where the reference takes a jvp of the residual
        per application (the same operator to rounding). ``u`` and
        ``coeffs`` keep the reference's signature."""
        free = self.free_mask(u.dtype)
        fixed = 1.0 - free

        def op(v):
            return self.element_action(em, v * free) * free + v * fixed

        return op

    def constrained_matvec(self, mat: EllMatrix):
        """The constrained operator from an assembled matrix (``matrix``
        already holds the Dirichlet rows and columns)."""
        return mat.matvec

    def set_bc(self, u) -> torch.Tensor:
        """u with Dirichlet values imposed (dolfinx set_bc on a solution
        vector)."""
        if not len(self.bc_dofs):
            return u
        out = u.clone()
        out[self.bc_dofs] = self.bc_values(u.dtype)
        return out
