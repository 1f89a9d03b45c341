"""Topology: entity (edge/facet) construction and CSR connectivity.

Equivalent of dolfinx ``create_entities`` / ``create_connectivity`` /
``connectivity->links`` (FEniCSx/mechanic2d/asym_elasto_damage_model.cc:
187-193, 372-376) and MFEM's ``GetEdgeVertexTable`` + ``Transpose``
(MFEM/...cc:1214-1216). All host-side NumPy, vectorized (no Python loops
over cells — the reference's full-Python variant pays 196 s for a loopy
build, doc.tex:638-641; ours is O(n log n) sorts).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from tpufem_torch.config import INDEX_DTYPE
from tpufem_torch.mesh.mesh import CELL_EDGES, CELL_INFO, Mesh


def _unique_entities(cells: np.ndarray, local: Tuple[Tuple[int, ...], ...]):
    """Build unique entity table from per-cell local vertex tuples.

    Returns (entities (ne, nv) sorted-vertex rows, cell_to_entity
    (n_cells, n_local)) — the cell→entity connectivity.
    """
    n_cells = cells.shape[0]
    n_local = len(local)
    nv = len(local[0])
    # (n_cells * n_local, nv) candidate entities, vertex-sorted per row
    cand = np.stack([cells[:, list(t)] for t in local], axis=1).reshape(-1, nv)
    cand = np.sort(cand, axis=1)
    from tpufem_torch import native

    entities, inverse = native.unique_entities(cand)
    cell_to_entity = inverse.reshape(n_cells, n_local).astype(INDEX_DTYPE)
    return entities.astype(INDEX_DTYPE), cell_to_entity


def build_entities(mesh: Mesh, dim: int):
    """Entities of dimension ``dim`` and cell→entity map (cached on mesh).

    dim == mesh.dim-1 gives facets; dim == 1 gives edges.
    """
    if dim in mesh._entities:
        return mesh._entities[dim]
    info = CELL_INFO[mesh.cell_type]
    if dim == mesh.dim:
        ents = np.sort(mesh.cells, axis=1).astype(INDEX_DTYPE)
        c2e = np.arange(mesh.n_cells, dtype=INDEX_DTYPE)[:, None]
    elif dim == 0:
        ents = np.arange(mesh.n_nodes, dtype=INDEX_DTYPE)[:, None]
        c2e = mesh.cells
    elif dim == mesh.dim - 1:
        ents, c2e = _unique_entities(mesh.cells, info["facets"])
    elif dim == 1:
        ents, c2e = _unique_entities(mesh.cells, CELL_EDGES[mesh.cell_type])
    else:
        raise ValueError(f"dim {dim} for {mesh.cell_type}")
    mesh._entities[dim] = (ents, c2e)
    return ents, c2e


def cell_edges(mesh: Mesh):
    """(edges (ne,2), cell_to_edge (n_cells, n_local_edges))."""
    return build_entities(mesh, 1)


def vertex_to_entity(n_vertices: int, entities: np.ndarray):
    """Transpose connectivity as CSR: vertex → incident entities.

    Returns (indptr (n_vertices+1,), indices) — equivalent of dolfinx
    ``create_connectivity(0, 1)`` + ``links`` (FEniCSx/...cc:192, 403) and
    MFEM ``Transpose(edge_vertex)`` (MFEM/...cc:1216).
    """
    flat_v = entities.ravel()
    order = np.argsort(flat_v, kind="stable")
    ent_ids = (order // entities.shape[1]).astype(INDEX_DTYPE)
    counts = np.bincount(flat_v, minlength=n_vertices)
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, ent_ids


def facet_to_cells(mesh: Mesh):
    """CSR facet → incident cells (1 or 2 per facet)."""
    facets, c2f = build_entities(mesh, mesh.dim - 1)
    n_f = facets.shape[0]
    flat = c2f.ravel()
    order = np.argsort(flat, kind="stable")
    cell_ids = (order // c2f.shape[1]).astype(INDEX_DTYPE)
    counts = np.bincount(flat, minlength=n_f)
    indptr = np.zeros(n_f + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, cell_ids


def boundary_facets(mesh: Mesh) -> np.ndarray:
    """Indices of facets incident to exactly one cell (exterior boundary).

    Equivalent of dolfinx ``exterior_facet_indices``.
    """
    facets, c2f = build_entities(mesh, mesh.dim - 1)
    counts = np.bincount(c2f.ravel(), minlength=facets.shape[0])
    return np.nonzero(counts == 1)[0].astype(INDEX_DTYPE)


def locate_entities_boundary(
    mesh: Mesh, dim: int, marker: Callable[[np.ndarray], np.ndarray]
) -> np.ndarray:
    """Boundary entities of dimension ``dim`` whose *every* vertex satisfies
    ``marker(x)`` (x is (n_points, gdim); marker returns bool (n_points,)).

    Mirrors ``dolfinx::mesh::locate_entities_boundary`` as used for the
    Dirichlet edges (FEniCSx/...cc:627-664: x=0 and x=1 vertex predicates).
    """
    bf = boundary_facets(mesh)
    facets, _ = build_entities(mesh, mesh.dim - 1)
    on_boundary_v = np.zeros(mesh.n_nodes, dtype=bool)
    on_boundary_v[facets[bf].ravel()] = True

    vmask = marker(mesh.x)
    vmask = np.asarray(vmask, dtype=bool) & on_boundary_v

    if dim == 0:
        return np.nonzero(vmask)[0].astype(INDEX_DTYPE)
    ents, _ = build_entities(mesh, dim)
    ent_ok = vmask[ents].all(axis=1)
    if dim == mesh.dim - 1:
        # restrict to exterior facets
        keep = np.zeros(ents.shape[0], dtype=bool)
        keep[bf] = True
        ent_ok &= keep
    return np.nonzero(ent_ok)[0].astype(INDEX_DTYPE)


def match_tagged_entities(mesh: Mesh, dim: int) -> np.ndarray:
    """Map each tagged entity (mesh.entity_tags[dim], vertex-sorted rows)
    to its index in the computed entity table of that dimension.

    Returns (n_tagged,) entity indices; -1 where a tagged entity is not
    present in the mesh (should not happen on conforming input).
    """
    tags = mesh.entity_tags[dim]
    ents, _ = build_entities(mesh, dim)
    # row-wise match via structured views (rows are vertex-sorted already)
    def as_void(a):
        a = np.ascontiguousarray(a, dtype=INDEX_DTYPE)
        return a.view([("", INDEX_DTYPE)] * a.shape[1]).ravel()

    ev = as_void(ents)
    tv = as_void(tags.entities)
    order = np.argsort(ev)
    pos = np.searchsorted(ev, tv, sorter=order)
    pos = np.clip(pos, 0, len(ev) - 1)
    found = ev[order[pos]] == tv
    out = np.where(found, order[pos], -1).astype(INDEX_DTYPE)
    return out
