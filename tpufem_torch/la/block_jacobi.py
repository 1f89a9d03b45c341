"""Block-Jacobi (non-overlapping additive Schwarz) preconditioner
(``tpufem.la.block_jacobi``).

Dofs are grouped into contiguous blocks of size B (after an RCM / SFC node
ordering the blocks are geometric patches). The B x B diagonal blocks are
taken from the assembled ELL matrix with one gather through a static
table, inverted batched, and applied per CG iteration as one batched
product: reshape and ``bmm``, no gather in the hot loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.assemble.pattern import EllMatrix, SparsityPattern
from tpufem_torch.config import INDEX_DTYPE, resolve_device
from tpufem_torch.la.precond import check_matmul_precision


@dataclasses.dataclass
class BlockJacobiPlan:
    """Static plan: ELL-flat position of each in-block matrix entry."""

    n: int  # true number of dofs
    B: int  # block size
    nb: int  # number of blocks (ceil(n/B))
    # (nb, B, B) int32 into the ELL value array flattened as (w*n,);
    # missing entries point to w*n (a zero is appended before gathering)
    ell_pos: torch.Tensor

    @staticmethod
    def build(pattern: SparsityPattern, B: int = 128, *,
              device=None) -> "BlockJacobiPlan":
        """The table from the pattern's host arrays (the reference's, entry
        for entry), put on ``device`` (CUDA unless the caller asks for
        another)."""
        n = pattern.n_rows
        nb = -(-n // B)
        rows = pattern.rows.astype(np.int64)
        cols = pattern.cols.astype(np.int64)
        in_block = rows // B == cols // B
        r = rows[in_block]
        c = cols[in_block]
        # position of each nnz in the (w, n) ELL layout: nnz k sits at
        # (within-row index, row) -- recompute the within-row index
        counts = np.bincount(rows, minlength=n)
        row_start = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        within = np.arange(pattern.nnz, dtype=np.int64) - row_start[rows]
        flat = within * n + rows  # ELL flat index of nnz k
        flat_in = flat[in_block]

        w = pattern.ell_width
        pos = np.full((nb, B, B), w * n, dtype=INDEX_DTYPE)
        pos[r // B, r % B, c % B] = flat_in
        return BlockJacobiPlan(
            n=n, B=B, nb=nb,
            ell_pos=torch.as_tensor(pos, device=resolve_device(device)))

    def extract(self, mat: EllMatrix) -> torch.Tensor:
        """(nb, B, B) dense diagonal blocks from the assembled matrix.
        Padding rows (beyond n) get a unit diagonal, so the inverse
        exists."""
        ext = torch.cat([mat.vals.reshape(-1), mat.vals.new_zeros(1)])
        blocks = ext.index_select(0, self.ell_pos.reshape(-1)).view(
            self.nb, self.B, self.B)
        tail = self.nb * self.B - self.n
        if tail > 0:  # only the last block holds padding rows
            blocks[-1].diagonal()[self.B - tail:] = 1.0
        return blocks

    def apply(self, inv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """y = blockdiag(inv) r: one batched product."""
        check_matmul_precision(inv)
        pad = self.nb * self.B - self.n
        rp = torch.nn.functional.pad(r, (0, pad)) if pad else r
        y = torch.bmm(inv, rp.view(self.nb, self.B, 1)).reshape(-1)
        return y[:self.n] if pad else y

    def preconditioner(self, mat: EllMatrix):
        """Invert the blocks once, return M(r) ~ A^-1 r."""
        inv = torch.linalg.inv(self.extract(mat))

        def M(r):
            return self.apply(inv, r)

        return M
