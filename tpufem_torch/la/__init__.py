"""Linear algebra of the port: preconditioned CG with the reference's
stopping rule, the Jacobi and Chebyshev preconditioners, the Chebyshev
smoother of the multilevel preconditioners, the power iteration that
sets the Chebyshev interval of both, block Jacobi (``block_jacobi``) and
smoothed-aggregation AMG with the rigid-body near-nullspace (``amg``)."""

from tpufem_torch.la.amg import (AMGHierarchy, AMGOptions,
                                 amg_preconditioner, build_hierarchy,
                                 ell_to_scipy, rigid_body_modes, vcycle)
from tpufem_torch.la.block_jacobi import BlockJacobiPlan
from tpufem_torch.la.cg import CGResult, cg
from tpufem_torch.la.precond import (chebyshev_iterate,
                                     chebyshev_preconditioner,
                                     estimate_lambda_max,
                                     jacobi_preconditioner, power_lambda_max)

__all__ = ["cg", "CGResult", "jacobi_preconditioner", "chebyshev_iterate",
           "chebyshev_preconditioner", "estimate_lambda_max",
           "power_lambda_max", "BlockJacobiPlan", "AMGOptions",
           "AMGHierarchy", "build_hierarchy", "ell_to_scipy",
           "rigid_body_modes", "vcycle", "amg_preconditioner"]
