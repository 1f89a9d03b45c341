"""Linear algebra of the port: preconditioned CG with the reference's
stopping rule, the Jacobi and Chebyshev preconditioners, the Chebyshev
smoother of the multilevel preconditioners, and the power iteration that
sets the Chebyshev interval of both. The rest of
``tpufem.la`` (AMG, block Jacobi) is queued in ROADMAP.md (Q1 item
6.4b)."""

from tpufem_torch.la.cg import CGResult, cg
from tpufem_torch.la.precond import (chebyshev_iterate,
                                     chebyshev_preconditioner,
                                     estimate_lambda_max,
                                     jacobi_preconditioner, power_lambda_max)

__all__ = ["cg", "CGResult", "jacobi_preconditioner", "chebyshev_iterate",
           "chebyshev_preconditioner", "estimate_lambda_max",
           "power_lambda_max"]
