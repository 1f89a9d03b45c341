"""Nonlinear solvers (Newton-Krylov): the callback-driven
``NewtonSolver``, the flat solver ``make_newton_solver`` (assembled ELL or
matrix-free) and the chunked, checkpointed ``make_chunked_solver``."""

from tpufem_torch.nls.newton import (NewtonResult, NewtonSolver,
                                     NonConvergenceError)
from tpufem_torch.nls.newton_chunked import (ChunkedResult,
                                             make_chunked_solver)
from tpufem_torch.nls.newton_jit import JitSolveResult, make_newton_solver

__all__ = ["NewtonSolver", "NewtonResult", "NonConvergenceError",
           "make_newton_solver", "JitSolveResult", "make_chunked_solver",
           "ChunkedResult"]
