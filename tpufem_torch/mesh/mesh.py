"""Mesh container: geometry + cells + entity tags as SoA NumPy arrays.

Equivalent of dolfinx::mesh::Mesh + MeshTags
(``FEniCSx/mechanic2d/asym_elasto_damage_model.cc:152-164`` reads mesh,
cell tags and facet tags) and mfem::Mesh with attributes
(``MFEM/mechanic2d/asym_elasto_damage_model.cc:1017-1034``).

Design: a Mesh is immutable host data. Device code never sees the Mesh
object — spaces/assemblers extract the int32/float arrays they need and
ship them once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from tpufem_torch.config import INDEX_DTYPE


class CellType:
    interval = "interval"
    triangle = "triangle"
    quad = "quad"
    tetra = "tetra"
    hexahedron = "hexahedron"
    point = "point"


# cell type -> (topological dim, n vertices, facet type, facets-as-local-vertex-tuples)
CELL_INFO: Dict[str, dict] = {
    CellType.point: dict(dim=0, nv=1, facet=None, facets=()),
    CellType.interval: dict(dim=1, nv=2, facet=CellType.point, facets=((0,), (1,))),
    CellType.triangle: dict(
        dim=2,
        nv=3,
        facet=CellType.interval,
        # local edges; ordering matches the reference-element tabulation in
        # tpufem_torch.elements (edge k is opposite vertex k, dolfinx convention)
        facets=((1, 2), (0, 2), (0, 1)),
    ),
    CellType.quad: dict(
        dim=2,
        nv=4,
        facet=CellType.interval,
        # vertices ordered (x fastest): 0=(0,0) 1=(1,0) 2=(0,1) 3=(1,1)
        facets=((0, 1), (0, 2), (1, 3), (2, 3)),
    ),
    CellType.tetra: dict(
        dim=3,
        nv=4,
        facet=CellType.triangle,
        facets=((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)),
    ),
    CellType.hexahedron: dict(
        dim=3,
        nv=8,
        facet=CellType.quad,
        # vertices (x fastest, then y, then z)
        facets=(
            (0, 1, 2, 3),  # z=0
            (4, 5, 6, 7),  # z=1
            (0, 1, 4, 5),  # y=0
            (2, 3, 6, 7),  # y=1
            (0, 2, 4, 6),  # x=0
            (1, 3, 5, 7),  # x=1
        ),
    ),
}

# edges (1-entities) per cell type, for dim>=2 (used by P2 dof layout and
# damage smoothing's vertex-edge adjacency)
CELL_EDGES: Dict[str, Tuple[Tuple[int, int], ...]] = {
    CellType.triangle: ((1, 2), (0, 2), (0, 1)),
    CellType.quad: ((0, 1), (0, 2), (1, 3), (2, 3)),
    CellType.tetra: ((2, 3), (1, 3), (1, 2), (0, 3), (0, 2), (0, 1)),
    CellType.hexahedron: (
        (0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ),
}


@dataclasses.dataclass
class MeshTags:
    """Tagged mesh entities of one dimension.

    ``entities``: (n, nv_entity) vertex indices of each tagged entity
    (sorted per row for dim>0 so they can be matched against computed
    entity tables); ``values``: (n,) int32 tags. Equivalent of
    dolfinx::mesh::MeshTags (read at FEniCSx/...cc:159-162).
    """

    dim: int
    entities: np.ndarray
    values: np.ndarray

    def find(self, tag: int) -> np.ndarray:
        """Rows whose value == tag (cf. meshtags.find, FEniCSx/...cc:365)."""
        return np.nonzero(self.values == tag)[0]


@dataclasses.dataclass
class Mesh:
    """Unstructured conforming mesh of a single cell type."""

    x: np.ndarray  # (n_nodes, gdim) float64 node coordinates
    cells: np.ndarray  # (n_cells, nv) int32 cell→vertex
    cell_type: str
    cell_tags: Optional[np.ndarray] = None  # (n_cells,) int32 physical tag
    # tags on lower-dimensional entities, keyed by dim
    entity_tags: Dict[int, MeshTags] = dataclasses.field(default_factory=dict)
    # cache of computed entity tables {dim: (entities (ne,nv), cell_to_entity)}
    _entities: Dict[int, Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default_factory=dict, repr=False
    )

    def __post_init__(self):
        self.x = np.ascontiguousarray(self.x, dtype=np.float64)
        self.cells = np.ascontiguousarray(self.cells, dtype=INDEX_DTYPE)
        if self.cell_tags is not None:
            self.cell_tags = np.ascontiguousarray(self.cell_tags, dtype=INDEX_DTYPE)

    @property
    def dim(self) -> int:
        return CELL_INFO[self.cell_type]["dim"]

    @property
    def gdim(self) -> int:
        return self.x.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Mesh({self.cell_type}, {self.n_nodes} nodes, "
            f"{self.n_cells} cells, gdim={self.gdim})"
        )
