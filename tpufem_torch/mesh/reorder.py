"""Mesh reordering for memory locality.

Random cell -> dof indices defeat memory locality; bandwidth-minimizing
node reordering (reverse Cuthill-McKee) or a space-filling curve at
preprocessing time tightens the index windows every gather touches. The
reference gets this implicitly from (Par)METIS contiguity (doc.tex:1575);
here, as in ``tpufem.mesh.reorder``, it is an explicit host-side pass
backed by the native library (``tpufem_torch.native``).
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.config import INDEX_DTYPE
from tpufem_torch.mesh.mesh import Mesh, MeshTags
from tpufem_torch.mesh.topology import build_entities


def _renumbered(mesh: Mesh, order: np.ndarray) -> Mesh:
    """``mesh`` with node ``order[new]`` as node ``new`` and cells sorted
    by their minimum new node index (ascending, stable), tags kept."""
    inv = np.empty(mesh.n_nodes, dtype=np.int64)
    inv[order] = np.arange(mesh.n_nodes)
    new_cells = inv[mesh.cells].astype(INDEX_DTYPE)
    cell_order = np.argsort(new_cells.min(axis=1), kind="stable")
    out = Mesh(
        x=mesh.x[order],
        cells=new_cells[cell_order],
        cell_type=mesh.cell_type,
        cell_tags=(
            mesh.cell_tags[cell_order] if mesh.cell_tags is not None else None
        ),
    )
    for dim, mt in mesh.entity_tags.items():
        ents = np.sort(inv[mt.entities], axis=1).astype(INDEX_DTYPE)
        out.entity_tags[dim] = MeshTags(
            dim=dim, entities=ents, values=mt.values.copy()
        )
    return out


def rcm_reorder(mesh: Mesh) -> Mesh:
    """Return a new Mesh with RCM-permuted nodes and cells sorted by
    their minimum node index (ascending), preserving all tags."""
    from tpufem_torch import native

    edges, _ = build_entities(mesh, 1)
    # vertex-vertex CSR adjacency
    n = mesh.n_nodes
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return _renumbered(mesh, native.rcm_ordering(indptr, dst))


def sfc_reorder(mesh: Mesh) -> Mesh:
    """Morton (Z-curve) node reordering + cell sorting.

    Contiguous dof ranges then correspond to compact geometric patches --
    what block Jacobi wants (RCM minimizes bandwidth but produces striped
    blocks).
    """
    from tpufem_torch import native

    return _renumbered(mesh, native.morton_order(mesh.x))


def bandwidth(mesh: Mesh) -> int:
    """Max |i - j| over element node pairs -- the locality metric RCM
    minimizes."""
    c = mesh.cells
    return int((c.max(axis=1) - c.min(axis=1)).max())
