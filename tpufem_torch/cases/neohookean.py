"""Neo-Hookean hyperelasticity with AD consistent tangents, Newton-Krylov.

BASELINE.json config 4: "Neo-Hookean hyperelasticity with consistent
tangents (replaces admfem dual numbers), Newton-Krylov"; the counterpart
of ``tpufem.cases.neohookean``. The tangent the reference computes with
nested dual numbers (MFEM/mechanic2d/autodiff/admfem.hpp:672-699) is
``torch.func.hessian`` of the same scalar potential here, assembled into
the ELL matrix once per Newton step (Jacobi-CG on its product).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpufem_torch.assemble import Assembler
from tpufem_torch.config import DEFAULT_DTYPE, SolverConfig, resolve_device
from tpufem_torch.forms import EnergyFunctional, neo_hookean_psi
from tpufem_torch.forms.form import Term
from tpufem_torch.mesh import box, unit_square
from tpufem_torch.mesh.mesh import CellType
from tpufem_torch.nls.newton_jit import make_newton_solver
from tpufem_torch.spaces import DirichletBC, FunctionSpace
from tpufem_torch.spaces.bc import locate_dofs_geometrical



@dataclasses.dataclass
class NeoHookeanConfig:
    n: int = 8
    dim: int = 3
    E: float = 1.0e6
    nu: float = 0.3
    stretch: float = 0.2  # finite-strain imposed displacement
    solver: SolverConfig = dataclasses.field(
        default_factory=lambda: SolverConfig(
            cg_rtol=1e-10, newton_maxit=20, newton_rtol=1e-9
        )
    )


def setup(cfg: NeoHookeanConfig, *, device=None,
          dtype: torch.dtype = DEFAULT_DTYPE):
    """(assembler, space, mesh): a unit cube of hexes (``dim`` 3) or a
    unit square of triangles (``dim`` 2), fixed at x = 0 and pulled by
    ``stretch`` in x at x = 1."""
    dev = resolve_device(device)
    if cfg.dim == 3:
        mesh = box(cfg.n, cfg.n, cfg.n, cell_type=CellType.hexahedron)
        bs, qdeg = 3, 2
    else:
        mesh = unit_square(cfg.n)
        bs, qdeg = 2, 2
    V = FunctionSpace.create(mesh, 1, bs=bs)
    stiff = Term(
        integrand=lambda qp: neo_hookean_psi(qp.grad_u, cfg.E, cfg.nu),
        degree=qdeg,
    )
    F = EnergyFunctional(V, [stiff], device=dev, dtype=dtype)
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    fixed = [0.0] * bs
    pulled = [cfg.stretch] + [0.0] * (bs - 1)
    bcs = [DirichletBC(V, left, fixed), DirichletBC(V, right, pulled)]
    return Assembler(F, bcs), V, mesh


def run(cfg: Optional[NeoHookeanConfig] = None, *, device=None,
        dtype: torch.dtype = DEFAULT_DTYPE):
    """Newton on the assembled ELL Jacobian; returns (JitSolveResult,
    space, mesh). ``device`` defaults to CUDA and ``dtype`` to float32
    (the reference runs float64; ``cg_rtol`` 1e-10 is out of float32's
    reach)."""
    cfg = cfg or NeoHookeanConfig()
    asm, V, mesh = setup(cfg, device=device, dtype=dtype)
    solve = make_newton_solver(asm, cfg.solver, use_matrix=True)
    res = solve(torch.zeros(V.n_dofs, dtype=dtype, device=asm.device), {})
    return res, V, mesh
