"""Linear algebra of the port: preconditioned CG with the reference's
stopping rule, the Jacobi preconditioner, and the Chebyshev smoother of
the multilevel preconditioners (with the power iteration for its
interval). The rest of ``tpufem.la`` (the Chebyshev preconditioner, AMG,
block Jacobi) is queued in ROADMAP.md."""

from tpufem_torch.la.cg import CGResult, cg
from tpufem_torch.la.precond import (chebyshev_iterate, jacobi_preconditioner,
                                     power_lambda_max)

__all__ = ["cg", "CGResult", "jacobi_preconditioner", "chebyshev_iterate",
           "power_lambda_max"]
