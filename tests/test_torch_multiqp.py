"""The lane engine's multi-quadrature-point path (``lane.multiqp``) against
tpufem (CPU, float64, the same numpy inputs through both): P2 triangles
and tetrahedra, Q1 / Q2 quadrilaterals and hexahedra, and P1 under a
degree-2 rule, on the integrand of tests/test_lane.py's multi-qp test (it
reads the gradient, the value, a P1 coefficient and ``qp.x``); the fold of
two same-degree terms; one residual in lane layout against the reference's
staged engine (Pallas in interpret mode) on one shared plan; a Jacobi
Newton-CG solve against the reference's, the two-level and mixed solves
against it (and, ``slow``, against the reference's); and the functionals
and options the path does not take, which raise.

Tolerances: rel <= 1e-11 against the reference's flat ``Assembler`` (the
sums over quadrature points and cells run in other orders: batched matrix
products here, unrolled sums there), 1e-12 against its lane engine on the
same plan; solves: the same Newton count, CG within 1 a step, u rel <=
1e-9. The 3D diagonals are held against the port's own ``Assembler``,
which the other test files hold against the reference: the reference's 3D
Hessian compiles for about a minute on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.forms as j_forms
import tpufem.forms.form as j_form
import tpufem.mesh as j_mesh
import tpufem.spaces as j_spaces
import tpufem.spaces.bc as j_bc
import tpufem_torch.forms as t_forms
import tpufem_torch.forms.form as t_form
import tpufem_torch.mesh as t_mesh
import tpufem_torch.spaces as t_spaces
import tpufem_torch.spaces.bc as t_bc
from tpufem.assemble import Assembler as JAssembler
from tpufem.config import SolverConfig as JSolverConfig
from tpufem.lane import LaneEngine as JLaneEngine
from tpufem_torch.assemble import Assembler as TAssembler
from tpufem_torch.config import SolverConfig as TSolverConfig
from tpufem_torch.lane import LaneEngine as TLaneEngine
from tpufem_torch.utils.convert import (lane_plan_fields,
                                        lane_plan_from_numpy, to_torch)
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
F64 = dict(device="cpu", dtype=torch.float64)
SOLVER = dict(cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=3000,
              newton_maxit=20, preconditioner="jacobi")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pkg(pkg):
    if pkg == "jax":
        return j_mesh, j_spaces, j_bc, j_forms, j_form, {}
    return t_mesh, t_spaces, t_bc, t_forms, t_form, F64


# kind: (mesh, element degree, quadrature degree), tests/test_lane.py:472's
# six kinds and the Q2 hexahedra of :761
KINDS = {
    "p2_tri": (lambda m: m.unit_square(5), 2, 2),
    "q1_quad": (lambda m: m.unit_square(6, cell_type="quad"), 1, 2),
    "q2_quad": (lambda m: m.unit_square(4, cell_type="quad"), 2, 3),
    "p1_tri_d2": (lambda m: m.unit_square(6), 1, 2),
    "p2_tet": (lambda m: m.box(2, 2, 2, cell_type="tetra"), 2, 2),
    "q1_hex": (lambda m: m.box(3, 3, 3), 1, 2),
    "q2_hex": (lambda m: m.box(2, 2, 2), 2, 3),
}


def _kind_problem(pkg, kind):
    mesh_m, sp, bc, forms, form, kw = _pkg(pkg)
    make_mesh, deg, qdeg = KINDS[kind]
    mesh = make_mesh(mesh_m)
    dim = mesh.x.shape[1]
    V = sp.FunctionSpace.create(mesh, deg, bs=dim)
    DS = sp.FunctionSpace.create(mesh, 1, bs=1)
    d = np.cos(3.0 * DS.dof_coords[:, 0]) * DS.dof_coords[:, 1]
    t = form.Term(
        lambda qp: (1.0 + 0.5 * qp.coeff("d"))
        * forms.linear_elastic_psi(qp.eps, E, NU)
        - 1e3 * qp.u[0] * qp.x[dim - 1],
        qdeg,
    )
    F = form.EnergyFunctional(V, [t], [form.Coefficient("d", DS)], **kw)
    left = bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    return F, [sp.DirichletBC(V, left, [0.0] * dim)], V, d


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_multiqp_engine_matches_reference_assembler(kind):
    """Residual and tangent action (lane -> flat) against the reference's
    flat Assembler; the diagonal on free dofs against the reference's in
    2D and the port's Assembler in 3D; every copy slot consistent."""
    Fj, bj, Vj, d = _kind_problem("jax", kind)
    Ft, bt, _, _ = _kind_problem("torch", kind)
    eng = TLaneEngine(Ft, bt, wg_own=8, **F64)
    assert eng._mq is not None and eng._mq.nq > 1
    rng = np.random.default_rng(3)
    u = rng.normal(size=Vj.n_dofs) * 1e-3
    v = rng.normal(size=Vj.n_dofs)
    cc = eng.prepare_coeffs({"d": d})
    ul = eng.to_lane(u)
    r = eng.residual(ul, cc)
    jv = eng.tangent_action(ul, cc, eng.to_lane(v))
    aj = JAssembler(Fj, bj)
    cj = {"d": jnp.asarray(d)}
    assert _rel(eng.from_lane(r), aj.residual(jnp.asarray(u), cj)) <= 1e-11
    assert _rel(eng.from_lane(jv), aj.tangent_action(
        jnp.asarray(u), cj, jnp.asarray(v))) <= 1e-11
    free = eng.from_lane(eng.free_lane) > 0
    dg = eng.from_lane(eng.diagonal(ul, cc))
    if Vj.mesh.x.shape[1] == 2:
        ref = np.asarray(aj.diagonal(jnp.asarray(u), cj))
    else:
        ref = TAssembler(Ft, bt).diagonal(
            to_torch(u, **F64), {"d": to_torch(d, **F64)}).numpy()
    assert _rel(dg[free], ref[free]) <= 1e-11
    for out in (r, jv):
        assert torch.equal(eng.refresh_copies(out), out)


def _fold_problem(pkg):
    """tests/test_lane.py:579: two degree-1 terms on P1 triangles."""
    mesh_m, sp, bc, forms, form, kw = _pkg(pkg)
    mesh = mesh_m.unit_square(6)
    V = sp.FunctionSpace.create(mesh, 1, bs=2)
    DS = sp.FunctionSpace.create(mesh, 1, bs=1)
    d = 0.2 + 0.1 * DS.dof_coords[:, 0]
    terms = [
        form.Term(lambda qp: (1.0 + qp.coeff("d"))
                  * forms.linear_elastic_psi(qp.eps, E, NU), 1),
        form.Term(lambda qp: -1e3 * qp.u[1] * qp.x[0], 1),
    ]
    F = form.EnergyFunctional(V, terms, [form.Coefficient("d", DS)], **kw)
    left = bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    return F, [sp.DirichletBC(V, left, [0.0, 0.0])], V, d


def test_two_terms_fold_into_one_integrand():
    """A P1 functional with two terms takes the multi-qp path (the P1
    path keeps its single-term rule): residual, tangent action and energy
    against the reference's Assembler."""
    Fj, bj, Vj, d = _fold_problem("jax")
    Ft, bt, _, _ = _fold_problem("torch")
    eng = TLaneEngine(Ft, bt, wg_own=8, **F64)
    assert eng._mq is not None and eng._mq.nq == 1
    rng = np.random.default_rng(6)
    u = rng.normal(size=Vj.n_dofs) * 1e-3
    v = rng.normal(size=Vj.n_dofs)
    cc = eng.prepare_coeffs({"d": d})
    ul = eng.to_lane(u)
    aj = JAssembler(Fj, bj)
    cj = {"d": jnp.asarray(d)}
    uj = jnp.asarray(u)
    assert _rel(eng.from_lane(eng.residual(ul, cc)),
                aj.residual(uj, cj)) <= 1e-11
    assert _rel(eng.from_lane(eng.tangent_action(ul, cc, eng.to_lane(v))),
                aj.tangent_action(uj, cj, jnp.asarray(v))) <= 1e-11
    e_ref = float(aj.energy(uj, cj))
    e = float(eng.cell_energies(ul, cc).sum())
    assert abs(e - e_ref) <= 1e-11 * abs(e_ref)


def _damage_p2(pkg):
    """The damage law on P2 triangles, unit_square(6): a damaged band,
    the left edge clamped, the right one pulled."""
    mesh_m, sp, bc, forms, form, kw = _pkg(pkg)
    mesh = mesh_m.unit_square(6)
    V = sp.FunctionSpace.create(mesh, 2, bs=2)
    DS = sp.FunctionSpace.create(mesh, 1, bs=1)
    d = np.zeros(DS.n_dofs)
    d[(DS.dof_coords[:, 1] > 0.3) & (DS.dof_coords[:, 1] < 0.7)] = 0.8
    t = form.Term(
        lambda qp: forms.asym_damage_psi(qp.eps, qp.coeff("d"), E, NU), 2)
    F = form.EnergyFunctional(V, [t], [form.Coefficient("d", DS)], **kw)
    left = bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = bc.locate_dofs_geometrical(
        V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    return F, [sp.DirichletBC(V, left, [0.0, 0.0]),
               sp.DirichletBC(V, right, [0.01, 0.0])], V, d


@pytest.fixture(scope="module")
def damage_p2():
    Fj, bj, Vj, d = _damage_p2("jax")
    Ft, bt, _, _ = _damage_p2("torch")
    ej = JLaneEngine(Fj, bj, wg_own=8, interpret=True)
    et = TLaneEngine(Ft, bt, **F64, plan=lane_plan_from_numpy(
        lane_plan_fields(ej.plan)))
    return dict(ej=ej, et=et, d=d, n=Vj.n_dofs)


def test_residual_in_lane_layout_matches_reference_engine(damage_p2):
    """On the reference's plan the lane layouts are one: the port's staged
    residual (K1 -> multi-qp physics -> K2 -> K3, plain versions) against
    the reference's (its Pallas kernels in interpret mode), every slot."""
    ej, et = damage_p2["ej"], damage_p2["et"]
    u = 1e-3 * np.random.default_rng(9).standard_normal(damage_p2["n"])
    ref = np.asarray(ej.residual(jnp.asarray(ej.to_lane(u)),
                                 ej.prepare_coeffs({"d": damage_p2["d"]})))
    got = et.residual(et.to_lane(u), et.prepare_coeffs({"d": damage_p2["d"]}))
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.fixture(scope="module")
def jacobi_p2(damage_p2):
    """The port's float64 Jacobi solve of the P2 damage problem."""
    et = damage_p2["et"]
    ut, st = et.make_solver(TSolverConfig(**SOLVER), cg_chunk=50)(
        torch.zeros_like(et.bc_lane), et.prepare_coeffs({"d": damage_p2["d"]}))
    assert st["converged"]
    return et.from_lane(ut), st


def test_jacobi_solve_matches_reference_solve(damage_p2, jacobi_p2):
    """``make_solver`` with Jacobi on the multi-qp engine against the
    reference's on the same plan: the same Newton count, CG within 1 a
    step, u rel <= 1e-9."""
    ej = damage_p2["ej"]
    uj, sj = ej.make_solver(JSolverConfig(**SOLVER), cg_chunk=200)(
        jnp.zeros_like(ej.bc_lane), ej.prepare_coeffs({"d": damage_p2["d"]}))
    ut, st = jacobi_p2
    assert sj["converged"]
    assert st["newton_iters"] == sj["newton_iters"] > 1
    assert len(st["cg_iters"]) == len(sj["cg_iters"])
    assert all(abs(a - b) <= 1
               for a, b in zip(st["cg_iters"], sj["cg_iters"]))
    assert _rel(ut, ej.from_lane(uj)) <= 1e-9


MIXED = dict(cg_rtol=1e-8, newton_rtol=1e-10, cg_maxit=4000, newton_maxit=30)


def _twolevel_p2(et, d):
    cfg = TSolverConfig(**dict(SOLVER, preconditioner="twolevel"))
    u, st = et.make_solver(cfg, cg_chunk=20, fine_coeffs={"d": d})(
        torch.zeros_like(et.bc_lane), et.prepare_coeffs({"d": d}))
    return et.from_lane(u), st


def _mixed_p2(d):
    Ft, bt, Vt, _ = _damage_p2("torch")
    e32 = TLaneEngine(Ft, bt, wg_own=8, device="cpu", dtype=torch.float32)
    u, st = e32.make_mixed_solver(TSolverConfig(**MIXED), cg_chunk=200)(
        torch.zeros(Vt.n_dofs, dtype=torch.float64), {"d": d},
        e32.prepare_coeffs({"d": d}))
    return u.numpy(), st


def test_twolevel_and_mixed_solves_reach_the_jacobi_root(damage_p2,
                                                         jacobi_p2):
    """The two-level and the mixed (float64 Newton, float32 Jacobi CG)
    solvers take a multi-qp engine unchanged and land on the Jacobi
    solve's root, u rel <= 1e-9."""
    u_j = jacobi_p2[0]
    u_t, st_t = _twolevel_p2(damage_p2["et"], damage_p2["d"])
    assert st_t["converged"] and _rel(u_t, u_j) <= 1e-9
    assert sum(st_t["cg_iters"]) < sum(jacobi_p2[1]["cg_iters"]) / 3
    u_m, st_m = _mixed_p2(damage_p2["d"])
    assert st_m["converged"] and _rel(u_m, u_j) <= 1e-9


@pytest.mark.slow
def test_twolevel_and_mixed_solves_match_reference(damage_p2):
    """Against the reference's ``make_solver("twolevel")`` (the same Newton
    count, CG within 1 a step, u rel <= 1e-9) and ``make_mixed_solver``
    (Jacobi; Newton within 1, as tests/test_torch_mixed.py allows, u rel <=
    1e-9) on the P2 damage problem. Slow: the reference compiles its
    two-level solve for about 100 s and its mixed one for about 40 s in
    interpret mode on the CPU."""
    ej, d = damage_p2["ej"], damage_p2["d"]
    uj, sj = ej.make_solver(
        JSolverConfig(**dict(SOLVER, preconditioner="twolevel")),
        cg_chunk=20, fine_coeffs={"d": d})(
        jnp.zeros_like(ej.bc_lane), ej.prepare_coeffs({"d": d}))
    ut, st = _twolevel_p2(damage_p2["et"], d)
    assert sj["converged"] and st["converged"]
    assert st["newton_iters"] == sj["newton_iters"]
    assert all(abs(a - b) <= 1
               for a, b in zip(st["cg_iters"], sj["cg_iters"]))
    assert _rel(ut, ej.from_lane(uj)) <= 1e-9
    Fj, bj, Vj, _ = _damage_p2("jax")
    e32 = JLaneEngine(Fj, bj, wg_own=8, interpret=True,
                      store_dtype=np.float32)
    cj = {"d": jnp.asarray(d)}
    um, sm = e32.make_mixed_solver(
        JSolverConfig(error_on_nonconvergence=False, **MIXED),
        cg_chunk=200)(jnp.zeros(Vj.n_dofs, dtype=jnp.float64), cj,
                      e32.prepare_coeffs(cj))
    ut, st = _mixed_p2(d)
    assert sm["converged"] and st["converged"]
    assert abs(st["newton_iters"] - sm["newton_iters"]) <= 1
    assert _rel(ut, np.asarray(um)) <= 1e-9


def test_native_planner_takes_cells_of_27_nodes(monkeypatch):
    """The lane planner's native cell balancing on Q2 hexahedra (27 nodes
    a cell; its residency table once held 16 entries on the stack) gives
    the plan of the NumPy rounds, field by field."""
    import dataclasses

    import tpufem_torch.native as t_native
    from tpufem_torch.lane.plan import LanePlan, build_lane_plan

    if not t_native.available():
        pytest.skip("no C++ compiler: native host library unavailable")
    V = t_spaces.FunctionSpace.create(t_mesh.box(3, 3, 3), 2, bs=3)
    args = (V.dof_coords, np.asarray(V.dofmap))
    native = build_lane_plan(*args, wg_own=8)
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_build_failed", True)
    fallback = build_lane_plan(*args, wg_own=8)
    for f in dataclasses.fields(LanePlan):
        a, b = getattr(native, f.name), getattr(fallback, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b, equal_nan=True), f.name
        elif f.name in ("owner_passes", "refresh_passes"):
            assert len(a) == len(b), f.name
            for pa, pb in zip(a, b):
                assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
        else:
            assert a == b, f.name


def test_what_the_multiqp_path_does_not_take_raises(damage_p2):
    """fused=True on a multi-qp engine once raised here; it now runs the
    generated multi-point kernel's route (``lane_fused_gen_mq``, plain
    version on the CPU) on the same plan: residual and tangent action
    equal the staged engine's, rel <= 1e-12. (Terms of two quadrature
    degrees and terms that need coefficient gradients, once raised here,
    take the generic path: test_torch_generic.py's
    ``test_generic_path_matches_reference`` and
    ``test_generic_takes_what_multiqp_does_not``; fused=True there
    raises.)"""
    et = damage_p2["et"]
    ef = TLaneEngine(et.functional, et.bcs, plan=et.plan, fused=True, **F64)
    assert ef.path == "multiqp" and ef.fused_gen(torch.float64).MULTIQP
    rng = np.random.default_rng(10)
    n = damage_p2["n"]
    u = ef.to_lane(1e-3 * rng.standard_normal(n))
    v = ef.to_lane(rng.standard_normal(n))
    cf = ef.prepare_coeffs({"d": damage_p2["d"]})
    cs = et.prepare_coeffs({"d": damage_p2["d"]})
    assert _rel(ef.residual(u, cf).numpy(), et.residual(u, cs).numpy()) \
        <= 1e-12
    assert _rel(ef.tangent_action(u, cf, v).numpy(),
                et.tangent_action(u, cs, v).numpy()) <= 1e-12
