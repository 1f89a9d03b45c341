"""Linear algebra of the port. Only the Chebyshev smoother of the
multilevel preconditioners (and the power iteration for its interval) is
ported so far; the rest of ``tpufem.la``
(the CG loops, Jacobi / Chebyshev preconditioners, AMG, block Jacobi) is
queued in ROADMAP.md."""

from tpufem_torch.la.precond import chebyshev_iterate, power_lambda_max

__all__ = ["chebyshev_iterate", "power_lambda_max"]
