"""Structured-lattice fast path: gather-free assembly on a right-diagonal
P1 lattice (2D) and a Q1 hex lattice (3D), their geometric multigrid, the
chunked Newton-Krylov solver ``make_grid_solver``, and the lattice kernels
K6 / K7 (2D asym-damage residual and tangent action) and K8 (3D linear
elasticity stencil). Every dof movement is a shifted slice and every
accumulation a slice-add."""

from tpufem_torch.structured.grid2d import StructuredGrid2D
from tpufem_torch.structured.grid3d import StructuredGrid3D
from tpufem_torch.structured.kernels2d import (make_residual_kernel,
                                               make_tangent_kernel)
from tpufem_torch.structured.kernels3d import make_linear_matvec
from tpufem_torch.structured.solve import GridSolveResult, make_grid_solver

__all__ = ["StructuredGrid2D", "StructuredGrid3D", "GridSolveResult",
           "make_grid_solver", "make_residual_kernel", "make_tangent_kernel",
           "make_linear_matvec"]
