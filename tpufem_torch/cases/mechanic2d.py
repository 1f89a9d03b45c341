"""mechanic2d -- the reference study's full workload on the GPU.

2D plane-strain asymmetric elasto-damage elasticity on a (polycrystal)
mesh: mesh read + refine, damage construction + smoothing, per-grain
Young's modulus from physical tags (glibc srand(6575) sequence,
bit-identical to the C++/Python references), volumetric load, Dirichlet
BCs, Newton-Krylov solve (Jacobi-preconditioned CG on the flat
``Assembler``), DG0 strain/stress/energy postprocessing, the VTU / XDMF
output phase and the 16-phase profiling table.

Mirrors, phase by phase, ``FEniCSx/mechanic2d/asym_elasto_damage_model.cc``
(main at :105-1220) and ``MFEM/mechanic2d/asym_elasto_damage_model.cc``
(main at :956-1800); physics definitions from ``asym_ufl.py``. The
per-grain modulus, the load and the DG0 postprocess are shared with the
polycrystal case.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from torch.func import grad, vmap

from tpufem_torch.assemble.assembler import Assembler, _map_cell_slabs
from tpufem_torch.cases import damage as damage_mod
from tpufem_torch.config import (DEFAULT_DTYPE, Mechanic2DConfig, data_path,
                                 resolve_device)
from tpufem_torch.elements.geometry import inv as small_inv
from tpufem_torch.elements.quadrature import quadrature
from tpufem_torch.forms import EnergyFunctional, asym_damage_psi
from tpufem_torch.forms.form import Coefficient, Term
from tpufem_torch.la import jacobi_preconditioner
from tpufem_torch.mesh import read_gmsh, refine_uniform
from tpufem_torch.nls import NewtonSolver
from tpufem_torch.perf import PhaseTimers
from tpufem_torch.spaces import DirichletBC, FunctionSpace
from tpufem_torch.spaces.bc import locate_dofs_geometrical
from tpufem_torch.utils import GlibcRand

NU = 0.3  # Poisson ratio (FEniCSx/...cc:254)
EPS_GEOM = 1.0e-9  # coordinate predicate tolerance


def young_modulus_range(use_ecst: bool = False) -> np.ndarray:
    """200 semi-random E values in [5e6, 1e8] keyed by physical tag,
    glibc srand(6575) -- bit-identical to FEniCSx/...cc:532-542."""
    rng = GlibcRand(6575)
    a = (1.0e8 - 5.0e6) / 199.0
    vals = np.array([a * (rng.rand() % 200) + 5.0e6 for _ in range(200)])
    if use_ecst:
        vals[:] = 1.0e6
    return vals


def volumetric_load(x: np.ndarray) -> np.ndarray:
    """f = ((1600 (y-.5)^2 - 500)*(-100000 (x-.5)^3), 0)
    (doc.tex:226-232; FEniCSx/...cc:563-585)."""
    r = x[:, 0] - 0.5
    y = x[:, 1] - 0.5
    fx = (1600.0 * y * y - 500.0) * (-100000.0 * r * r * r)
    return np.stack([fx, np.zeros_like(fx)], axis=1)


@dataclasses.dataclass
class Mechanic2DResult:
    mesh: object
    V: FunctionSpace
    u: torch.Tensor
    d: torch.Tensor
    E_cell: torch.Tensor
    strain: np.ndarray  # (nc, 3) [e11, e12, e22] at centroid
    stress: np.ndarray  # (nc, 3)
    energy: np.ndarray  # (nc,)
    newton_iterations: int
    krylov_iters: list
    residual_norms: list
    timers: PhaseTimers


def setup(cfg: Optional[Mechanic2DConfig] = None, mesh=None, timers=None,
          *, device=None, dtype: torch.dtype = DEFAULT_DTYPE):
    """Build the problem (mesh -> assembler + coefficient arrays).

    Returns (assembler, coeffs dict, V, mesh, aux dict). Split from
    ``run`` so benchmarks can time phases separately. ``device`` defaults
    to CUDA and ``dtype`` to float32; every tensor of the problem has
    them.
    """
    cfg = cfg or Mechanic2DConfig()
    dev = resolve_device(device)
    tm = timers or PhaseTimers(device=dev)

    with tm.phase("2.1 Read mesh"):
        if mesh is None:
            mesh = read_gmsh(cfg.mesh_path or data_path("square.msh"))
    with tm.phase("2.2 Refine mesh"):
        for _ in range(cfg.max_refine):
            mesh = refine_uniform(mesh)

    with tm.phase("3.1 Define space"):
        # displacement space degree from config (1 = reference; 2 = the
        # P2/Q2 variant of BASELINE config 2); damage stays P1 on mesh
        # nodes (the smoothing algorithm is node-based)
        V = FunctionSpace.create(mesh, cfg.degree, bs=2)
        DS = FunctionSpace.create(mesh, 1, bs=1)  # damage (P1 scalar)
        ES = FunctionSpace.create(mesh, 0, bs=1)  # Young modulus (DG0)

    with tm.phase("3.2 Define damage"):
        tag_list = (
            damage_mod.SQUARE_DAMAGED_EDGE_TAGS
            if 1 in mesh.entity_tags and mesh.n_nodes < 1000
            else damage_mod.NEPER_DAMAGED_EDGE_TAGS
        )
        d0 = damage_mod.initial_damage(mesh, tag_list, cfg.max_dam)
        d = damage_mod.smooth_damage(
            mesh, d0, iterations=8 * (cfg.max_refine + 1), dtype=dtype,
            device=dev,
        )

    with tm.phase("4.1 Material constant"):
        E_range = young_modulus_range(cfg.use_ecst)
        tags = (
            mesh.cell_tags
            if mesh.cell_tags is not None
            else np.zeros(mesh.n_cells, dtype=np.int64)
        )
        E_cell = torch.as_tensor(E_range[tags % 200], dtype=dtype,
                                 device=dev)

    with tm.phase("5.2 Neumann setting"):
        if cfg.use_volume:
            fvals = volumetric_load(V.dof_coords)
            f_vec = torch.as_tensor(fvals.reshape(-1), dtype=dtype,
                                    device=dev)
        else:
            f_vec = torch.zeros(V.n_dofs, dtype=dtype, device=dev)

    with tm.phase("5.1 Dirichlet setting"):
        left = locate_dofs_geometrical(
            V, lambda x: np.abs(x[:, 0]) < EPS_GEOM
        )
        right = locate_dofs_geometrical(
            V, lambda x: np.abs(x[:, 0] - 1.0) < EPS_GEOM
        )
        imp = 0.01 if cfg.use_trac else -0.01  # USE_TRAC (driver :642-646)
        bcs = [
            DirichletBC(V, left, [0.0, 0.0]),
            DirichletBC(V, right, [imp, 0.0]),
        ]

    with tm.phase("7.1 Nonlinear form creation"):
        # stiffness at quadrature degree 1, load at default (degree 2) --
        # the reference's Measure metadata split (asym_ufl.py:78-81)
        qdeg_stiff = 1 if cfg.degree == 1 else 2 * cfg.degree
        stiffness = Term(
            integrand=lambda qp: asym_damage_psi(
                qp.eps, qp.coeff("d"), qp.coeff("E"), NU
            ),
            degree=qdeg_stiff,
        )
        load = Term(
            integrand=lambda qp: -torch.dot(qp.coeff("f"), qp.u),
            degree=cfg.degree + 1,
        )
        functional = EnergyFunctional(
            V,
            [stiffness, load],
            [Coefficient("d", DS), Coefficient("E", ES), Coefficient("f", V)],
            device=dev, dtype=dtype,
        )
        asm = Assembler(functional, bcs)

    coeffs = {"d": d, "E": E_cell, "f": f_vec}
    aux = dict(cfg=cfg, DS=DS, ES=ES, timers=tm)
    return asm, coeffs, V, mesh, aux


def postprocess(asm: Assembler, u: torch.Tensor, coeffs,
                batch: Optional[int] = None):
    """Centroid strain/stress/energy per cell as reduced vectors
    [t11, t12, t22] -- the reference's three DG0 expressions
    (asym_ufl.py:86-97, interpolated at FEniCSx/...cc:909-941).

    ``batch``: evaluate in cell slabs of this size so the kernel's
    temporaries stay bounded at multi-million-cell meshes (same contract
    as Assembler.residual's ``batch``). Returns NumPy arrays
    (nc, 3), (nc, 3), (nc,)."""
    func = asm.functional
    V = func.space
    u_cells = func.gather(u)
    c_cells = func.gather_coeffs(coeffs)

    qpts, _ = quadrature(V.mesh.cell_type, 1)  # centroid for P1 triangles
    dN_ref = torch.as_tensor(V.element.tabulate_grad(qpts)[0],
                             dtype=u.dtype, device=u.device)  # (ndof, dim)
    dNg_ref = torch.as_tensor(func.geom_element.tabulate_grad(qpts)[0],
                              dtype=u.dtype, device=u.device)

    def per_cell(u_e, x_e, d_e, E_e):
        J = x_e.T @ dNg_ref
        dN = dN_ref @ small_inv(J)
        grad_u = u_e.reshape(-1, 2).T @ dN
        eps = 0.5 * (grad_u + grad_u.T)
        d_c = torch.mean(d_e)  # P1 value at centroid = mean of vertices
        sig = grad(lambda e: asym_damage_psi(e, d_c, E_e[0], NU))(eps)
        sig = 0.5 * (sig + sig.T)
        energy = torch.sum(eps * sig)
        return (
            torch.stack([eps[0, 0], eps[0, 1], eps[1, 1]]),
            torch.stack([sig[0, 0], sig[0, 1], sig[1, 1]]),
            energy,
        )

    kernel = vmap(per_cell, in_dims=(-1, -1, -1, -1), out_dims=(-1, -1, -1))
    args = (u_cells, func.x_cells.to(u.dtype), c_cells["d"], c_cells["E"])
    if batch and u_cells.shape[-1] > batch:
        strain, stress, energy = _map_cell_slabs(
            lambda a: kernel(*a), args, batch
        )
    else:
        strain, stress, energy = kernel(*args)
    return (strain.T.cpu().numpy(), stress.T.cpu().numpy(),
            energy.cpu().numpy())


def run(cfg: Optional[Mechanic2DConfig] = None, mesh=None, *, device=None,
        dtype: torch.dtype = DEFAULT_DTYPE) -> Mechanic2DResult:
    """The whole workload, phase by phase (``Mechanic2DResult.timers``).

    Newton with CG preconditioned by Jacobi, as the reference runs it
    whatever its config names (tpufem/cases/mechanic2d.py:249): here
    ``cfg.solver.preconditioner`` must be ``"jacobi"``, and any other
    name raises ``ValueError``. The CG operator is the
    constrained tangent linearized once per Newton step from the element
    matrices that also give the Jacobi diagonal (the reference applies a
    jvp of the residual at every CG iteration; the two agree to
    rounding). ``device`` defaults to CUDA and ``dtype`` to float32 (the
    reference study runs float64: ``cg_rtol`` 1e-12 is out of float32's
    reach).
    """
    cfg = cfg or Mechanic2DConfig()
    dev = resolve_device(device)
    tm = PhaseTimers(device=dev)
    with tm.phase("1 Initialize"):
        pc = cfg.solver.preconditioner
        if pc != "jacobi":
            raise ValueError(
                f"preconditioner={pc!r}: mechanic2d runs 'jacobi' (the "
                "reference's run uses Jacobi whatever its config names, "
                "without a word: tpufem/cases/mechanic2d.py:249)"
            )

    asm, coeffs, V, mesh, aux = setup(cfg, mesh=mesh, timers=tm, device=dev,
                                      dtype=dtype)

    with tm.phase("7.2 Solver creation"):
        solver = NewtonSolver(cfg.solver)
        lin = {}

        def element_matrices(w):
            # one linearization per Newton step, shared by the operator
            # and the Jacobi diagonal (NewtonSolver asks for both at w)
            if lin.get("u") is not w:
                lin.clear()
                lin.update(u=w, em=asm.linearize(w, coeffs))
            return lin["em"]

    with tm.phase("7.3 NonLinear resolution"):
        res = solver.solve(
            torch.zeros(V.n_dofs, dtype=dtype, device=dev),
            rhs=lambda w: asm.lifted_rhs(w, coeffs),
            operator=lambda w: asm.constrained_action(
                w, coeffs, element_matrices(w)),
            precond=lambda w: jacobi_preconditioner(
                asm.diagonal(w, coeffs, element_matrices(w))),
        )
        u = res.u
        lin.clear()

    with tm.phase("8.1 strain/stress computation"):
        strain, stress, energy = postprocess(asm, u, coeffs)

    with tm.phase("8 Outputs"):
        if cfg.output_dir is not None:
            # the reference's output phase: displacement + damage as
            # point fields, E/strain/stress/energy as cell fields
            # (FEniCSx/...cc:946-1032 writes XDMF/VTX per space)
            from tpufem_torch.io import write_vtu, write_xdmf

            os.makedirs(cfg.output_dir, exist_ok=True)
            point_data = {"u": u.cpu().numpy().reshape(-1, 2),
                          "d": coeffs["d"].cpu().numpy()}
            cell_data = {
                "E": coeffs["E"].cpu().numpy(),
                "strain": strain,
                "stress": stress,
                "energy": energy,
            }
            write_vtu(
                os.path.join(cfg.output_dir, "mechanic2d.vtu"),
                mesh, point_data=point_data, cell_data=cell_data,
            )
            write_xdmf(
                os.path.join(cfg.output_dir, "mechanic2d.xdmf"),
                mesh, point_data=point_data, cell_data=cell_data,
            )

    tm.finish()
    return Mechanic2DResult(
        mesh=mesh, V=V, u=u, d=coeffs["d"], E_cell=coeffs["E"],
        strain=strain, stress=stress, energy=energy,
        newton_iterations=res.iterations, krylov_iters=res.krylov_iters,
        residual_norms=res.residual_norms, timers=tm,
    )
