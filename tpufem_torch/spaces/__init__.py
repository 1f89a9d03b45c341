"""Function spaces, dofmaps, Dirichlet BCs. A dofmap is a static
(n_cells, ndof_cell) int32 array; vector fields use block size ``bs``
with byVDIM interleaving (dof = node * bs + component)."""

from tpufem_torch.spaces.space import FunctionSpace
from tpufem_torch.spaces.function import Function
from tpufem_torch.spaces.bc import (
    DirichletBC, locate_dofs_topological, locate_dofs_geometrical,
)

__all__ = [
    "FunctionSpace", "Function", "DirichletBC", "locate_dofs_topological",
    "locate_dofs_geometrical",
]
