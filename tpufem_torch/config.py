"""Global configuration: dtype/device policy and solver settings.

There is no process-wide precision switch: every entry point takes an
explicit ``dtype`` (default ``torch.float32``, the fast path; the tests
and the accuracy oracle use ``torch.float64``) and an explicit
``device`` (default CUDA). ``resolve_device`` raises when the requested
device is CUDA and there is none -- nothing carries on on the CPU because
it found no GPU; the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Index dtype for dofmaps / connectivity. int32 everywhere (meshes below
# 2B entities), matching dolfinx's local int32 indices.
INDEX_DTYPE = np.int32

DEFAULT_DTYPE = torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpufem_torch runs on a CUDA device and none is available; "
                "pass device='cpu' explicitly to run on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class SolverConfig:
    """Krylov + Newton settings.

    Defaults mirror the reference:
    - CG rtol 1e-12, maxit 2000  (FEniCSx/...cc:718 ``KSPSetTolerances``)
    - Newton rtol 1e-7, atol 5e-8, max_it 10 (FEniCSx/...cc:709-713);
      convergence is judged against the initial residual r0 (the MFEM
      convention, doc.tex:2065-2068). The lane solver reports
      ``converged`` in its statistics and never raises on its own.
    """

    cg_rtol: float = 1.0e-12
    cg_atol: float = 0.0
    cg_maxit: int = 2000
    newton_rtol: float = 1.0e-7
    newton_atol: float = 5.0e-8
    newton_maxit: int = 10
    # the lane solver's preconditioner: 'jacobi' or 'twolevel' (the
    # lattice-coarse two-level cycle, lane/twolevel.py); the structured
    # solver (structured/solve.py): 'mg' (geometric multigrid V-cycle) or
    # anything else for point Jacobi. Other names of the reference (amg,
    # chebyshev, ...) raise NotImplementedError in the lane solver
    preconditioner: str = "jacobi"
    # geometric MG (structured path, preconditioner='mg'): Chebyshev degree
    # of the V(mg_degree, mg_degree) cycle's smoother
    mg_degree: int = 3
    verbose: bool = False
