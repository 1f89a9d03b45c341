"""Structured-lattice fast path: gather-free assembly on a right-diagonal
P1 lattice and its geometric multigrid (the coarse solve of the lane
engine's two-level preconditioner). Every dof movement is a shifted
slice and every accumulation a slice-add."""

from tpufem_torch.structured.grid2d import StructuredGrid2D

__all__ = ["StructuredGrid2D"]
