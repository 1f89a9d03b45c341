"""Gather-based scatter-reduction plans -- the deterministic assembly
primitive.

``index_add_`` on a CUDA tensor accumulates with float atomics, so its
result changes from run to run. The fix is to transpose the reduction at
plan time: for every target row (dof) precompute the fixed list of
source entries that feed it, padded to the max count K. The reduction
then is K dense gathers added in a fixed order -- no atomics,
bit-deterministic (unlike MatSetValues(ADD_VALUES) whose epoch ordering
the reference has to manage,
FEniCSx/mechanic2d/asym_elasto_damage_model.cc:853-859).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufem_torch.config import INDEX_DTYPE, resolve_device


@dataclasses.dataclass
class GatherSumPlan:
    """Precomputed transpose of a scatter-add.

    ``apply(values)`` computes out[i] = sum_k values[idx[k, i]] for the
    (K, n_targets) index table, where padded slots point one past the
    end of ``values`` (a zero is appended before the gather). The K
    terms are added left to right.
    """

    n_targets: int
    n_sources: int
    idx: torch.Tensor  # (K, n_targets) int32, pad == n_sources

    @staticmethod
    def build_table(targets: np.ndarray, n_targets: int) -> np.ndarray:
        """Host table (K, n_targets) int32 for ``targets[e]`` = target
        row of source entry e; pad == len(targets)."""
        flat = np.asarray(targets).ravel()
        n_src = flat.shape[0]
        from tpufem_torch import native

        if n_src:
            idx_t = native.gather_plan(flat, n_targets)
            if idx_t is not None:
                return idx_t
        order = np.argsort(flat, kind="stable")
        sorted_t = flat[order]
        counts = np.bincount(flat, minlength=n_targets)
        K = int(counts.max()) if n_src else 1
        row_start = np.zeros(n_targets + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        idx = np.full((n_targets, max(K, 1)), n_src, dtype=INDEX_DTYPE)
        within = np.arange(n_src, dtype=np.int64) - row_start[sorted_t]
        idx[sorted_t, within] = order.astype(INDEX_DTYPE)
        return np.ascontiguousarray(idx.T)

    @staticmethod
    def build(targets, n_targets: int, *, device=None) -> "GatherSumPlan":
        """The plan for ``targets[e]`` = target row of source entry e (a
        host array or a tensor): the table of :meth:`build_table` (each
        target's sources in ascending order), made by one stable sort
        with torch on ``device``, so that streams too long for the host
        (the nnz plan of a large assembled matrix) stay on the card."""
        t = torch.as_tensor(targets, device=resolve_device(device))
        t = t.reshape(-1).to(torch.int64)
        n_src = t.numel()
        dev = t.device
        counts = torch.bincount(t, minlength=n_targets)
        K = int(counts.max()) if n_src else 1
        sorted_t, order = torch.sort(t, stable=True)
        del t
        row_start = torch.zeros(n_targets + 1, dtype=torch.int64,
                                device=dev)
        torch.cumsum(counts, 0, out=row_start[1:])
        within = torch.arange(n_src, device=dev) - row_start[sorted_t]
        idx = torch.full((max(K, 1), n_targets), n_src, dtype=torch.int32,
                         device=dev)
        idx[within, sorted_t] = order.to(torch.int32)
        return GatherSumPlan(n_targets=n_targets, n_sources=n_src, idx=idx)

    def apply(self, values: torch.Tensor) -> torch.Tensor:
        ext = torch.cat(
            [values.reshape(-1), values.new_zeros(1)]
        )
        acc = ext.index_select(0, self.idx[0])
        for k in range(1, self.idx.shape[0]):
            acc = acc + ext.index_select(0, self.idx[k])
        return acc


@dataclasses.dataclass
class SubsetSumPlan:
    """A scatter-add into a few targets of a larger array, transposed on
    the host: ``add_into(out, values)`` adds, to every distinct target
    slot t of ``out`` (flattened), the values of the source entries that
    feed it, in a fixed order (the facet terms' residual, tangent,
    diagonal and nnz adds: a vertex belongs to two facets, so targets
    repeat, and ``index_add_`` on the card would add them with float
    atomics). The sum is one gather of the (K, n_targets) table (pad: one
    past the end of ``values``, where a zero is appended) and one sum over
    K; the targets are then updated by one indexed store, which is exact
    because they are distinct."""

    targets: torch.Tensor  # (n_targets,) int64, distinct
    idx: torch.Tensor  # (K, n_targets) int64 into values.reshape(-1)
    n_values: int

    @staticmethod
    def build(targets, sources, n_values: int, *,
              device=None) -> "SubsetSumPlan":
        """Source entry e adds ``values.reshape(-1)[sources[e]]`` into
        ``out.reshape(-1)[targets[e]]``; ``n_values`` is the size of
        ``values``."""
        t = np.asarray(targets, dtype=np.int64).ravel()
        src = np.asarray(sources, dtype=np.int64).ravel()
        uniq, inv = np.unique(t, return_inverse=True)
        table = GatherSumPlan.build_table(inv.ravel(), len(uniq))
        pad = table == len(t)
        table = np.where(pad, n_values, src[np.where(pad, 0, table)])
        dev = resolve_device(device)
        return SubsetSumPlan(
            targets=torch.as_tensor(uniq, device=dev),
            idx=torch.as_tensor(np.ascontiguousarray(table),
                                dtype=torch.int64, device=dev),
            n_values=int(n_values))

    def sums(self, values: torch.Tensor) -> torch.Tensor:
        """(n_targets,) the summed sources of every target."""
        ext = torch.cat([values.reshape(-1), values.new_zeros(1)])
        K, n = self.idx.shape
        return ext.index_select(0, self.idx.reshape(-1)).view(K, n).sum(0)

    def add_into(self, out: torch.Tensor, values: torch.Tensor,
                 inplace: bool = False) -> torch.Tensor:
        """``out`` with the sums added at the targets: a new tensor, or
        ``out`` itself updated when ``inplace`` (outside autograd)."""
        flat = out.view(-1) if inplace else out.reshape(-1)
        new = flat.index_select(0, self.targets) + self.sums(values)
        if inplace:
            flat.index_put_((self.targets,), new)
            return out
        return flat.index_put((self.targets,), new).view(out.shape)
