"""FunctionSpace: element + mesh → dofmap and dof coordinates."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tpufem_torch.config import INDEX_DTYPE
from tpufem_torch.elements.lagrange import Element, element as make_element
from tpufem_torch.mesh.mesh import Mesh
from tpufem_torch.mesh.topology import build_entities


@dataclasses.dataclass
class FunctionSpace:
    """Scalar or blocked (vector) Lagrange space.

    ``dofmap``: (n_cells, ndof_cell) int32 *scalar* dof indices (node-level);
    vector dofs are ``node_dof * bs + component`` (byVDIM ordering,
    MFEM/...cc:1108). ``n_scalar_dofs`` counts node-level dofs; total
    unknowns = n_scalar_dofs * bs.
    """

    mesh: Mesh
    element: Element
    bs: int = 1
    dofmap: np.ndarray = None
    n_scalar_dofs: int = 0
    dof_coords: np.ndarray = None  # (n_scalar_dofs, gdim)

    @staticmethod
    def create(mesh: Mesh, degree: int, bs: int = 1) -> "FunctionSpace":
        el = make_element(mesh.cell_type, degree)
        dofmap, ndofs, coords = _build_dofmap(mesh, el)
        return FunctionSpace(
            mesh=mesh, element=el, bs=bs, dofmap=dofmap,
            n_scalar_dofs=ndofs, dof_coords=coords,
        )

    @property
    def n_dofs(self) -> int:
        return self.n_scalar_dofs * self.bs

    def vector_dofmap(self) -> np.ndarray:
        """Expanded (n_cells, ndof_cell*bs) dofmap with byVDIM blocking."""
        if self.bs == 1:
            return self.dofmap
        # stay in INDEX_DTYPE: the int64 broadcast + astype costs a full
        # extra pass over ~nc*ndof*bs entries at multi-M cells
        dm = self.dofmap[:, :, None].astype(INDEX_DTYPE, copy=False) * \
            INDEX_DTYPE(self.bs) + np.arange(self.bs, dtype=INDEX_DTYPE)
        return np.ascontiguousarray(
            dm.reshape(self.dofmap.shape[0], -1)
        )


def _build_dofmap(mesh: Mesh, el: Element):
    """Assign global scalar dofs per entity class of the element layout."""
    if el.degree == 0:
        dofmap = np.arange(mesh.n_cells, dtype=INDEX_DTYPE)[:, None]
        # centroid coordinates
        from tpufem_torch.utils.hostops import cell_centroids

        coords = cell_centroids(mesh.x, mesh.cells)
        return dofmap, mesh.n_cells, coords

    n_vertex = mesh.n_nodes
    vertex_block = mesh.cells  # (nc, nv) — dof i == vertex i for P1
    if el.degree == 1:
        return vertex_block.astype(INDEX_DTYPE), n_vertex, mesh.x.copy()

    if el.degree == 2:
        edges, c2e = build_entities(mesh, 1)
        edge_block = (n_vertex + c2e).astype(INDEX_DTYPE)
        blocks = [vertex_block, edge_block]
        mid = 0.5 * (mesh.x[edges[:, 0]] + mesh.x[edges[:, 1]])
        coords = [mesh.x, mid]
        ndofs = n_vertex + edges.shape[0]
        # face dofs (3D tensor cells, e.g. Q2 hex face centers); facet
        # block order matches CELL_INFO facets via build_entities
        n_face_dofs = sum(
            1 for d, _ in el.entity_dofs if d == 2 and mesh.dim == 3
        )
        if n_face_dofs:
            faces, c2f = build_entities(mesh, 2)
            blocks.append((ndofs + c2f).astype(INDEX_DTYPE))
            coords.append(mesh.x[faces].mean(axis=1))
            ndofs += faces.shape[0]
        # interior (cell) dofs, e.g. Q2's center node
        n_cell_dofs = sum(1 for d, _ in el.entity_dofs if d == mesh.dim)
        if n_cell_dofs:
            cell_block = (
                ndofs
                + np.arange(mesh.n_cells * n_cell_dofs).reshape(
                    mesh.n_cells, n_cell_dofs
                )
            ).astype(INDEX_DTYPE)
            blocks.append(cell_block)
            from tpufem_torch.utils.hostops import cell_centroids

            coords.append(cell_centroids(mesh.x, mesh.cells))
            ndofs += mesh.n_cells * n_cell_dofs
        dofmap = np.concatenate(blocks, axis=1).astype(INDEX_DTYPE)
        return dofmap, ndofs, np.concatenate(coords, axis=0)

    raise NotImplementedError(f"degree {el.degree}")
