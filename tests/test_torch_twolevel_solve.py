"""The slice as a whole: the two-level preconditioned Newton-Krylov solve
of tpufem_torch against tpufem's ``make_solver(preconditioner="twolevel")``
(CPU, float64, one shared load vector, the JAX engine's Pallas kernels in
interpret mode).

The fixture is a unit square (n = 8, wg_own = 8, a damaged band, an
8 x 8 coarse lattice) rather than the polycrystal of
test_torch_twolevel.py: the reference jit-compiles its whole CG chunk
with the two-level cycle and every interpret-mode kernel inside, and the
polycrystal plan's 70-pass copy kernel alone takes about 90 s to compile
on the CPU. The reference's fine smoother data (its Jacobi diagonal and
the lambda_max of its own AD tangent) are compared here too; one
application of the cycle is compared in test_torch_twolevel.py.

Tolerances: Jacobi diagonal rel <= 1e-12, lambda_max rel <= 1e-10
(12 power iterations; the port's fine operator is the stored Hessian or
the hand-written fused kernel, the reference's the AD element JVP);
solves: same Newton count, CG counts within +-2 per Newton step (the exit
test compares a rounded residual with a tolerance), u rel <= 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.lane.twolevel as j_tl
import tpufem_torch.lane.twolevel as t_tl
from tpufem.config import SolverConfig as JSolverConfig
from tpufem_torch.config import SolverConfig as TSolverConfig
from tpufem_torch.lane import kernels as tk
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
N, WG_OWN, NC = 8, 8, 8
F64 = dict(device="cpu", dtype=torch.float64)
SOLVER = dict(cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=500,
              newton_maxit=20)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _problem(pkg):
    if pkg == "jax":
        from tpufem.forms import EnergyFunctional, asym_damage_psi
        from tpufem.forms.form import Coefficient, Term
        from tpufem.mesh import unit_square
        from tpufem.spaces import DirichletBC, FunctionSpace
        from tpufem.spaces.bc import locate_dofs_geometrical
        kw = {}
    else:
        from tpufem_torch.forms import EnergyFunctional, asym_damage_psi
        from tpufem_torch.forms.form import Coefficient, Term
        from tpufem_torch.mesh import unit_square
        from tpufem_torch.spaces import DirichletBC, FunctionSpace
        from tpufem_torch.spaces.bc import locate_dofs_geometrical
        kw = F64
    mesh = unit_square(N)
    V = FunctionSpace.create(mesh, 1, bs=2)
    DS = FunctionSpace.create(mesh, 1, bs=1)
    t = Term(lambda qp: asym_damage_psi(qp.eps, qp.coeff("d"), E, NU), 1)
    F = EnergyFunctional(V, [t], [Coefficient("d", DS)], **kw)
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [DirichletBC(V, left, [0.0, 0.0]),
           DirichletBC(V, right, [0.01, 0.0])]
    x = DS.dof_coords
    d = np.zeros(DS.n_dofs)
    d[np.abs(x[:, 1] - 0.5) < 0.1] = 0.6
    d[(np.abs(x[:, 1] - 0.5) < 0.05) & (x[:, 0] < 0.3)] = 1.0
    return F, bcs, V, d


@pytest.fixture(scope="module")
def case():
    """Both packages' two-level solves with one load vector (the
    reference's staged engine; the port's staged and fused engines) and
    their smoother data at the lifted zero state."""
    from tpufem.lane import LaneEngine as JLaneEngine
    from tpufem_torch.lane import LaneEngine as TLaneEngine

    Fj, bj, Vj, d = _problem("jax")
    Ft, bt, Vt, _ = _problem("torch")
    rng = np.random.default_rng(2)
    load = 1e3 * rng.standard_normal(Vt.n_dofs)  # shared, numpy

    ej = JLaneEngine(Fj, bj, wg_own=WG_OWN, interpret=True)
    ccj = ej.prepare_coeffs({"d": jnp.asarray(d)})
    solve = ej.make_solver(
        JSolverConfig(preconditioner="twolevel", **SOLVER), cg_chunk=20,
        fine_coeffs={"d": d}, twolevel_nc=NC,
        const_residual=jnp.asarray(ej.plan.to_lane(load, 2)))
    uj, sj = solve(jnp.zeros_like(ej.bc_lane), ccj)
    _, dataj = j_tl.build_twolevel(ej, ej.bc_lane, ccj, {"d": d}, nc=NC)
    ref = dict(u=ej.from_lane(uj), stats=sj, inv_d=np.asarray(dataj.inv_d),
               lmax=float(dataj.lmax))

    es = TLaneEngine(Ft, bt, wg_own=WG_OWN, **F64)
    ef = TLaneEngine(Ft, bt, plan=es.plan, fused=True, **F64)
    st_t, geo_t = t_tl.build_twolevel_geo(es, {"d": d}, nc=NC)
    got = {}
    for name, eng in (("staged", es), ("fused", ef)):
        cc = eng.prepare_coeffs({"d": d})
        tk.reset_launch_counts()
        solve = eng.make_solver(
            TSolverConfig(preconditioner="twolevel", **SOLVER), cg_chunk=20,
            fine_coeffs={"d": d}, twolevel_nc=NC,
            const_residual=eng.to_lane(load))
        u, st = solve(torch.zeros_like(eng.bc_lane), cc)
        data = t_tl.refresh_twolevel(eng, st_t, geo_t, eng.bc_lane, cc)
        got[name] = dict(u=eng.from_lane(u), stats=st,
                         launches=tk.launch_counts(),
                         smoother=(data.inv_d.numpy(), data.lmax))
    return ref, got


@pytest.mark.parametrize("engine", ["staged", "fused"])
def test_smoother_data_matches_reference(case, engine):
    ref, got = case
    inv_d, lmax = got[engine]["smoother"]
    assert _rel(inv_d, ref["inv_d"]) <= 1e-12
    assert abs(lmax - ref["lmax"]) <= 1e-10 * ref["lmax"]


@pytest.mark.parametrize("engine", ["staged", "fused"])
def test_twolevel_solve_matches_reference(case, engine):
    ref, got = case
    sj, st = ref["stats"], got[engine]["stats"]
    assert sj["converged"] and st["converged"]
    assert st["newton_iters"] == sj["newton_iters"]
    assert len(st["cg_iters"]) == len(sj["cg_iters"])
    assert all(abs(a - b) <= 2 for a, b in zip(st["cg_iters"],
                                               sj["cg_iters"]))
    assert _rel(got[engine]["u"], ref["u"]) <= 1e-9
    assert st["twolevel_setup_seconds"] > 0.0
    # CPU tensors: every wrapper ran its plain version
    assert all(v == 0 for v in got[engine]["launches"].values())
