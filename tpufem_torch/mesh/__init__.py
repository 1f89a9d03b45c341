"""Host-side mesh layer: generation and topology (one-time NumPy
preprocessing producing static int32 SoA arrays)."""

from tpufem_torch.mesh.mesh import Mesh, CellType, CELL_INFO
from tpufem_torch.mesh.generate import unit_square, rectangle, box
from tpufem_torch.mesh.topology import (
    build_entities,
    cell_edges,
    vertex_to_entity,
    boundary_facets,
    locate_entities_boundary,
)

__all__ = [
    "Mesh", "CellType", "CELL_INFO", "unit_square", "rectangle", "box",
    "build_entities", "cell_edges", "vertex_to_entity", "boundary_facets",
    "locate_entities_boundary",
]
