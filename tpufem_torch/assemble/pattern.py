"""Sparsity pattern + ELL sparse matrix.

Equivalent of PETSc MatAIJ creation via ``fem::petsc::create_matrix``
(FEniCSx/mechanic2d/asym_elasto_damage_model.cc:688) and of
``tpufem.assemble.pattern``. The pattern is computed once (the same host
tables as the reference's, entry for entry, its two sorts done by torch
on the assembler's device); assembly then reduces the
(nc * ndofe^2,) element-entry stream into nnz slots with a gather-sum in
a fixed order (``GatherSumPlan``) -- the replacement for
MatSetValues(ADD_VALUES) + MatAssembly epochs (FEniCSx/...cc:852-859),
with no floating-point atomics.

Storage is ELL (padded fixed-width rows) in the ``(width, n_rows)``
layout: the product is one gather of x and one reduction over the width.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.config import INDEX_DTYPE


@dataclasses.dataclass
class SparsityPattern:
    """COO -> slot mapping for element-matrix assembly (host tables)."""

    n_rows: int
    n_cols: int
    nnz: int
    rows: np.ndarray  # (nnz,) int32 row of each stored entry
    cols: np.ndarray  # (nnz,) int32 col of each stored entry
    # assembly plan: element entry k (flattened (cell, i, j)) lands in
    # slot entry_to_slot[k]; perm sorts entries by slot
    perm: np.ndarray  # (n_entries,) int32
    sorted_slots: np.ndarray  # (n_entries,) int32, nondecreasing
    # ELL layout
    ell_width: int
    ell_cols: np.ndarray  # (n_rows, width) int32, padded with row's own idx
    ell_slots: np.ndarray  # (n_rows, width) int32 slot index (padded -> nnz)

    @staticmethod
    def from_dofmap(dofmap: np.ndarray, n_dofs: int, *,
                    device="cpu") -> "SparsityPattern":
        """Build from a (n_cells, ndofe) vector dofmap (square operator).

        The unique-sort of the (row, col) keys and the stable sort of the
        entries by slot run with torch on ``device`` (nc * ndofe^2
        entries: 151 M for 262 144 hexes, a long sort on the host); the
        tables come back to the host."""
        nd = dofmap.shape[1]
        rows = np.repeat(dofmap, nd, axis=1).ravel()  # (nc*nd*nd,)
        cols = np.tile(dofmap, (1, nd)).ravel()
        key = torch.as_tensor(
            rows.astype(np.int64) * n_dofs + cols.astype(np.int64),
            device=device)
        del rows, cols
        uq, inv = torch.unique(key, sorted=True, return_inverse=True)
        del key
        srt, prm = torch.sort(inv, stable=True)
        del inv
        uniq = uq.cpu().numpy()
        perm = prm.to(torch.int32).cpu().numpy()
        sorted_slots = srt.to(torch.int32).cpu().numpy()
        del uq, srt, prm
        nnz = len(uniq)
        urows = (uniq // n_dofs).astype(INDEX_DTYPE)
        ucols = (uniq % n_dofs).astype(INDEX_DTYPE)

        # ELL: rows are sorted in uniq order already (row-major keys)
        counts = np.bincount(urows, minlength=n_dofs)
        width = int(counts.max()) if nnz else 0
        ell_cols = np.tile(np.arange(n_dofs, dtype=INDEX_DTYPE)[:, None],
                           (1, width))
        ell_slots = np.full((n_dofs, width), nnz, dtype=INDEX_DTYPE)
        # position of each nnz within its row
        row_start = np.zeros(n_dofs + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        within = np.arange(nnz, dtype=np.int64) - row_start[urows]
        ell_cols[urows, within] = ucols
        ell_slots[urows, within] = np.arange(nnz, dtype=INDEX_DTYPE)

        return SparsityPattern(
            n_rows=n_dofs,
            n_cols=n_dofs,
            nnz=nnz,
            rows=urows,
            cols=ucols,
            perm=perm,
            sorted_slots=sorted_slots,
            ell_width=width,
            ell_cols=ell_cols,
            ell_slots=ell_slots,
        )


@dataclasses.dataclass
class EllMatrix:
    """Assembled sparse operator in ELL form (tensors on the device).

    LAYOUT: (width, n_rows) -- rows in the minor dimension, so the x[cols]
    gather and the multiply are contiguous along the rows. The columns
    are int32, which ``index_select`` reads as they are.
    """

    n_rows: int
    cols: torch.Tensor  # (width, n_rows) int32
    vals: torch.Tensor  # (width, n_rows)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x as a dense gather + reduction over the width."""
        xc = x.index_select(0, self.cols.reshape(-1)).view(self.cols.shape)
        return torch.sum(self.vals * xc, dim=0)

    def diagonal(self) -> torch.Tensor:
        row_ids = torch.arange(self.n_rows, dtype=self.cols.dtype,
                               device=self.cols.device)[None, :]
        on_diag = self.cols == row_ids
        return torch.sum(
            torch.where(on_diag, self.vals, torch.zeros_like(self.vals)),
            dim=0)

    def to_dense(self) -> torch.Tensor:
        n = self.n_rows
        out = torch.zeros((n, n), dtype=self.vals.dtype,
                          device=self.vals.device)
        rows = torch.arange(n, dtype=self.cols.dtype,
                            device=self.cols.device).repeat(
                                self.cols.shape[0])
        return out.index_put_((rows, self.cols.reshape(-1)),
                              self.vals.reshape(-1), accumulate=True)
