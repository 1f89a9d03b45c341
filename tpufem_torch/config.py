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
import os
from typing import Optional

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
      ``convergence`` 'r0' (MFEM: the first step's right-hand side sets
      the scale) or 'du0' (dolfinx: the residual after the first update
      does), doc.tex:2065-2068 -- read by ``nls.NewtonSolver``; the lane
      solver judges against r0.
    - ``error_on_nonconvergence``: ``nls.NewtonSolver`` raises
      ``NonConvergenceError`` when Newton does not converge. The lane
      solver reports ``converged`` in its statistics and never raises.
    """

    cg_rtol: float = 1.0e-12
    cg_atol: float = 0.0
    cg_maxit: int = 2000
    newton_rtol: float = 1.0e-7
    newton_atol: float = 5.0e-8
    newton_maxit: int = 10
    convergence: str = "r0"  # 'r0' | 'du0'
    # the lane solver's preconditioner: 'jacobi' or 'twolevel' (the
    # lattice-coarse two-level cycle, lane/twolevel.py); the structured
    # solver (structured/solve.py): 'mg' (geometric multigrid V-cycle) or
    # anything else for point Jacobi; mechanic2d (the flat Assembler):
    # 'jacobi'. Other names of the reference (amg, chebyshev, ...) raise
    # NotImplementedError in the lane solver and in mechanic2d
    preconditioner: str = "jacobi"
    # geometric MG (structured path, preconditioner='mg'): Chebyshev degree
    # of the V(mg_degree, mg_degree) cycle's smoother
    mg_degree: int = 3
    error_on_nonconvergence: bool = True
    verbose: bool = False


@dataclasses.dataclass
class Mechanic2DConfig:
    """The reference workload's compile-time macro matrix as a dataclass.

    Mirrors FEniCSx/mechanic2d/asym_elasto_damage_model.cc:1-26 defaults:
    MAX_REFINE=0, MAX_DAM=1., USE_VOLUME, USE_TRAC, random E field.
    """

    max_refine: int = 0
    max_dam: float = 1.0
    use_volume: bool = True
    use_trac: bool = True  # +0.01 imposed displacement (else -0.01)
    use_ecst: bool = False  # constant E=1e6 (auto-disabled under use_trac)
    mesh_path: Optional[str] = None  # default: bundled square.msh
    degree: int = 1  # displacement-space degree (BASELINE config 2: P2/Q2)
    output_dir: Optional[str] = None  # write VTU/XDMF fields when set
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)

    def __post_init__(self):
        if self.use_trac:
            # Reference: #ifdef USE_TRAC -> #undef USE_ECST (driver :20-24)
            self.use_ecst = False


def data_path(name: str) -> str:
    """Path to a bundled data file (``tpufem_torch/data/``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "data", name)
