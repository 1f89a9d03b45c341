"""Nonlinear solvers (Newton-Krylov)."""

from tpufem_torch.nls.newton import (NewtonResult, NewtonSolver,
                                     NonConvergenceError)

__all__ = ["NewtonSolver", "NewtonResult", "NonConvergenceError"]
