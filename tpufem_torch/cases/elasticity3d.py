"""3D linear elasticity on a hex mesh, matrix-free Chebyshev-CG.

BASELINE.json config 3: "3D linear elasticity on hex mesh, matrix-free
Chebyshev-preconditioned CG (no explicit sparse matrix)"; the counterpart
of ``tpufem.cases.elasticity3d``. A pulled bar: a unit ``box`` of hexes
(2x2x2 Gauss points) or tets (one point), P1 with bs = 3, fixed at x = 0
and pulled by ``imposed`` in x at x = 1. The CG operator is the element
action on the element matrices, taken once (the problem is linear: one
Newton step); no sparse matrix exists unless ``matrix_free=False``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpufem_torch.assemble import Assembler
from tpufem_torch.config import DEFAULT_DTYPE, SolverConfig, resolve_device
from tpufem_torch.forms import EnergyFunctional, linear_elastic_psi
from tpufem_torch.forms.form import Term
from tpufem_torch.mesh import box
from tpufem_torch.mesh.mesh import CellType
from tpufem_torch.nls.newton_jit import make_newton_solver
from tpufem_torch.spaces import DirichletBC, FunctionSpace
from tpufem_torch.spaces.bc import locate_dofs_geometrical



@dataclasses.dataclass
class Elasticity3DConfig:
    n: int = 16  # elements per side
    E: float = 1.0e6
    nu: float = 0.3
    imposed: float = 0.01  # x-displacement on x=1 face
    cell_type: str = CellType.hexahedron
    matrix_free: bool = True
    solver: SolverConfig = dataclasses.field(
        default_factory=lambda: SolverConfig(
            preconditioner="chebyshev", cg_rtol=1e-10
        )
    )


def setup(cfg: Elasticity3DConfig, *, device=None,
          dtype: torch.dtype = DEFAULT_DTYPE):
    """(assembler, space, mesh) of the pulled bar on ``device`` (default
    CUDA) in ``dtype``."""
    dev = resolve_device(device)
    mesh = box(cfg.n, cfg.n, cfg.n, cell_type=cfg.cell_type)
    V = FunctionSpace.create(mesh, 1, bs=3)
    qdeg = 2 if cfg.cell_type == CellType.hexahedron else 1
    stiff = Term(
        integrand=lambda qp: linear_elastic_psi(qp.eps, cfg.E, cfg.nu),
        degree=qdeg,
    )
    F = EnergyFunctional(V, [stiff], device=dev, dtype=dtype)
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [
        DirichletBC(V, left, [0.0, 0.0, 0.0]),
        DirichletBC(V, right, [cfg.imposed, 0.0, 0.0]),
    ]
    return Assembler(F, bcs), V, mesh


def run(cfg: Optional[Elasticity3DConfig] = None, *, device=None,
        dtype: torch.dtype = DEFAULT_DTYPE):
    """Solve the pulled bar; returns (JitSolveResult, space, mesh).

    ``device`` defaults to CUDA and ``dtype`` to float32. The reference
    runs float64: ``cg_rtol`` 1e-10 is out of float32's reach, and a
    float32 solve stops at ``cg_maxit`` (2 000) instead."""
    cfg = cfg or Elasticity3DConfig()
    asm, V, mesh = setup(cfg, device=device, dtype=dtype)
    solve = make_newton_solver(asm, cfg.solver,
                               use_matrix=not cfg.matrix_free)
    res = solve(torch.zeros(V.n_dofs, dtype=dtype, device=asm.device), {})
    return res, V, mesh
