"""The lane engine's generic element path (``lane.generic``) against tpufem
(CPU, float64, the same numpy inputs through both; the reference's Pallas
kernels in interpret mode): tests/test_lane.py:148 (two cell terms of two
quadrature degrees, one reading ``qp.x``) against the reference's flat
Assembler and its lane engine on one plan; tests/test_lane.py:171's six
element kinds at their smallest meshes; the functionals the multi-qp path
does not take (terms of two degrees, coefficient gradients, no cell term);
the reference study's own functional (``mechanic2d.setup`` at r = 0); and
the solves: ``make_solver`` (Jacobi, two-level) and ``make_mixed_solver``
(Jacobi, two-level, AMG).

Tolerances: assembled quantities rel <= 1e-12 (1e-11 for the six kinds, the
reference test's bound); diagonals on free dofs (the flat Assembler puts 1
on constrained ones); solves: the same Newton count, CG within 1 a step, u
rel <= 1e-9 (every solve against the port's float64 Jacobi root; against
the reference's solves, Jacobi and two-level make_solver in tier 1, the
mixed ones ``slow``)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.forms as j_forms
import tpufem.forms.form as j_form
import tpufem.mesh as j_mesh
import tpufem.mesh.topology as j_topo
import tpufem.spaces as j_spaces
import tpufem.spaces.bc as j_bc
import tpufem_torch.forms as t_forms
import tpufem_torch.forms.form as t_form
import tpufem_torch.mesh as t_mesh
import tpufem_torch.mesh.topology as t_topo
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


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pkg(pkg):
    if pkg == "jax":
        return types.SimpleNamespace(
            mesh=j_mesh, sp=j_spaces, bc=j_bc, forms=j_forms, form=j_form,
            topo=j_topo, dot=jnp.dot, kw={})
    return types.SimpleNamespace(
        mesh=t_mesh, sp=t_spaces, bc=t_bc, forms=t_forms, form=t_form,
        topo=t_topo, dot=torch.dot, kw=F64)


def _clamped_left(P, V, dim):
    left = P.bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    return [P.sp.DirichletBC(V, left, [0.0] * dim)]


def _two_degrees(pkg, n=12):
    """tests/test_lane.py:148: elasticity at degree 1 and a volumetric
    load reading qp.x at degree 2, x = 0 clamped."""
    P = _pkg(pkg)
    V = P.sp.FunctionSpace.create(P.mesh.unit_square(n), 1, bs=2)
    t1 = P.form.Term(lambda qp: P.forms.linear_elastic_psi(qp.eps, E, NU), 1)
    t2 = P.form.Term(lambda qp: -1e3 * qp.u[0] * qp.x[1], 2)
    F = P.form.EnergyFunctional(V, [t1, t2], **P.kw)
    return F, _clamped_left(P, V, 2), V


def _parity(eng, aj, u, v, coeffs_np, coeffs_j, tol, diag_ref=None):
    """Residual, tangent (one-off, from ``linearize``, from the gathered
    cells) and the diagonal on free dofs, lane -> flat, against the
    reference's Assembler ``aj`` (the diagonal against ``diag_ref`` where
    given)."""
    cc = eng.prepare_coeffs(coeffs_np)
    ul, vl = eng.to_lane(u), eng.to_lane(v)
    uj, vj = jnp.asarray(u), jnp.asarray(v)
    free = eng.from_lane(eng.free_lane) > 0
    jv_ref = np.asarray(aj.tangent_action(uj, coeffs_j, vj))
    r = eng.residual(ul, cc)
    jvs = (eng.tangent_action(ul, cc, vl),
           eng.make_tangent(ul, cc, eng.linearize(ul, cc))(vl),
           eng.tangent_from_cells(eng._gather_cells(ul), cc, vl))
    assert _rel(eng.from_lane(r), aj.residual(uj, coeffs_j)) <= tol
    for jv in jvs:
        assert _rel(eng.from_lane(jv), jv_ref) <= tol
    d = eng.from_lane(eng.diagonal(ul, cc))
    if diag_ref is None:
        diag_ref = np.asarray(aj.diagonal(uj, coeffs_j))
    assert _rel(d[free], diag_ref[free]) <= tol
    for out in (r,) + jvs:
        assert torch.equal(eng.refresh_copies(out), out)


# -- tests/test_lane.py:148 -----------------------------------------------------


@pytest.fixture(scope="module")
def gen():
    """The :148 problem in both packages, a state and a direction, and the
    reference's float64 generic engine, which the tests below share."""
    Fj, bj, V = _two_degrees("jax")
    Ft, bt, _ = _two_degrees("torch")
    rng = np.random.default_rng(1)
    return dict(Fj=Fj, bj=bj, Ft=Ft, bt=bt, V=V,
                u=rng.normal(size=V.n_dofs) * 1e-3,
                v=rng.normal(size=V.n_dofs),
                ej=JLaneEngine(Fj, bj, wg_own=8, interpret=True))


def test_generic_path_matches_reference(gen):
    """The generic engine against the reference's flat Assembler (the
    diagonal against the port's, held against the reference's in
    test_torch_engine.py), and its residual in lane layout against the
    reference's generic engine on the same plan."""
    ej = gen["ej"]
    assert ej._fast_fn is None  # the reference's generic path
    eng = TLaneEngine(gen["Ft"], gen["bt"], wg_own=8, plan=lane_plan_from_numpy(
        lane_plan_fields(ej.plan)), **F64)
    assert eng.path == "generic" and eng.x_lane.shape == (3, 2,
                                                          eng.plan.G *
                                                          eng.plan.kc * 128)
    diag = TAssembler(gen["Ft"], gen["bt"]).diagonal(
        to_torch(gen["u"], **F64), {}).numpy()
    _parity(eng, JAssembler(gen["Fj"], gen["bj"]), gen["u"], gen["v"], {},
            {}, 1e-12, diag)
    ulj = jnp.asarray(ej.to_lane(gen["u"]))
    assert _rel(eng.residual(eng.to_lane(gen["u"]), {}).numpy(),
                ej.residual(ulj, ej.prepare_coeffs({}))) <= 1e-12


def test_generic_slabs_and_energy(gen):
    """Cell slabs of any size give the same element data bit for bit; the
    lane cell energies sum to the flat Assembler's energy."""
    eng = TLaneEngine(gen["Ft"], gen["bt"], wg_own=8, **F64)
    ul = eng.to_lane(gen["u"])
    uc = eng._gather_cells(ul)
    x = eng.x_lane
    whole = (eng._gen.residual(uc, {}, x), eng._gen.linearize(uc, {}, x))
    eng._gen.batch = 100  # a last slab shorter than the others
    assert eng.plan.G * eng.plan.kc * 128 % 100 != 0
    sl = (eng._gen.residual(uc, {}, x), eng._gen.linearize(uc, {}, x))
    for a, b in zip(whole, sl):
        assert torch.equal(a, b)
    e = float(eng.cell_energies(ul, {}).sum())
    e_ref = float(TAssembler(gen["Ft"], gen["bt"]).energy(
        to_torch(gen["u"], **F64), {}))
    assert e == pytest.approx(e_ref, rel=1e-12)


def test_fused_on_the_generic_path_raises(gen):
    """The reference runs such an engine staged without a word
    (tpufem/lane/engine.py:163); the port refuses."""
    with pytest.raises(NotImplementedError,
                       match="K4, kernel source generated from the "
                             "elementwise energy"):
        TLaneEngine(gen["Ft"], gen["bt"], wg_own=8, fused=True, **F64)


# -- tests/test_lane.py:171: six element kinds ----------------------------------

COVER = {
    "p2_tri": (lambda m: m.unit_square(3), 2, 2),
    "q1_quad": (lambda m: m.unit_square(3, cell_type="quad"), 1, 2),
    "q2_quad": (lambda m: m.unit_square(2, cell_type="quad"), 2, 3),
    "p1_tet": (lambda m: m.box(2, 2, 2, cell_type="tetra"), 1, 1),
    "p1_tet_d2": (lambda m: m.box(2, 2, 2, cell_type="tetra"), 1, 2),
    "q1_hex": (lambda m: m.box(2, 2, 2), 1, 2),
}
# the reference's 3D residual and jvp of two terms compile for 11-27 s on
# the CPU (p1_tet 11 s, p1_tet_d2 21 s, q1_hex 27 s, one worker): slow, so
# that the file stays near its time budget
COVER_SLOW = ("p1_tet", "p1_tet_d2", "q1_hex")


def _cover(pkg, kind):
    P = _pkg(pkg)
    make, deg, qdeg = COVER[kind]
    mesh = make(P.mesh)
    dim = mesh.x.shape[1]
    V = P.sp.FunctionSpace.create(mesh, deg, bs=dim)
    DS = P.sp.FunctionSpace.create(mesh, 1, bs=1)
    d = np.cos(3.0 * DS.dof_coords[:, 0]) * DS.dof_coords[:, 1]
    terms = [
        P.form.Term(lambda qp: (1.0 + 0.5 * qp.coeff("d"))
                    * P.forms.linear_elastic_psi(qp.eps, E, NU), qdeg),
        P.form.Term(lambda qp: -1e3 * qp.u[0] * qp.x[dim - 1], qdeg + 1),
    ]
    F = P.form.EnergyFunctional(V, terms, [P.form.Coefficient("d", DS)],
                                **P.kw)
    return F, _clamped_left(P, V, dim), V, d


@pytest.mark.parametrize("kind", [
    pytest.param(k, marks=pytest.mark.slow) if k in COVER_SLOW else k
    for k in COVER])
def test_lane_element_coverage(kind):
    """Residual and tangent against the reference's Assembler; the
    diagonal on free dofs against the port's (the reference's Hessian of
    two terms compiles slowly), itself held against the reference's in
    test_torch_engine.py / test_torch_multiqp.py."""
    Fj, bj, V, d = _cover("jax", kind)
    Ft, bt, _, _ = _cover("torch", kind)
    eng = TLaneEngine(Ft, bt, wg_own=8, **F64)
    assert eng.path == "generic"
    rng = np.random.default_rng(2)
    u = rng.normal(size=V.n_dofs) * 1e-3
    v = rng.normal(size=V.n_dofs)
    cc = eng.prepare_coeffs({"d": d})
    ul = eng.to_lane(u)
    aj = JAssembler(Fj, bj)
    cj = {"d": jnp.asarray(d)}
    assert _rel(eng.from_lane(eng.residual(ul, cc)),
                aj.residual(jnp.asarray(u), cj)) <= 1e-11
    assert _rel(eng.from_lane(eng.tangent_action(ul, cc, eng.to_lane(v))),
                aj.tangent_action(jnp.asarray(u), cj, jnp.asarray(v))) \
        <= 1e-11
    free = eng.from_lane(eng.free_lane) > 0
    ref = TAssembler(Ft, bt).diagonal(to_torch(u, **F64),
                                      {"d": to_torch(d, **F64)}).numpy()
    assert _rel(eng.from_lane(eng.diagonal(ul, cc))[free], ref[free]) \
        <= 1e-11


# -- what the multi-qp path does not take -----------------------------------------


def _not_multiqp(pkg, what):
    """P1 triangles on unit_square(4), x = 0 clamped: a term reading a
    coefficient gradient, or facet terms only (tests/test_facets.py:57's
    pressure, no cell term)."""
    P = _pkg(pkg)
    mesh = P.mesh.unit_square(4)
    V = P.sp.FunctionSpace.create(mesh, 1, bs=2)
    DS = P.sp.FunctionSpace.create(mesh, 1, bs=1)
    d = 0.3 + 0.2 * DS.dof_coords[:, 0] * DS.dof_coords[:, 1]
    coeffs, facet_terms = [], []
    if what == "coeff_grads":
        coeffs = [P.form.Coefficient("d", DS)]
        terms = [P.form.Term(
            lambda qp: (1.0 + qp.coeff("d"))
            * P.forms.linear_elastic_psi(qp.eps, E, NU)
            + 1e4 * qp.coeff_grad("d")[0, 0] * qp.u[0]
            + 1e4 * qp.coeff_grad("d")[0, 1] * qp.u[1] ** 2, 1,
            needs_coeff_grads=("d",))]
    else:
        terms = []
        allb = P.topo.locate_entities_boundary(
            mesh, 1, lambda x: np.ones(len(x), bool))
        facet_terms = [P.form.FacetTerm(
            lambda f: 5e2 * P.dot(f.normal, f.u) + 1e5 * P.dot(f.u, f.u),
            2, facets=allb)]
    F = P.form.EnergyFunctional(V, terms, coeffs, facet_terms=facet_terms,
                                **P.kw)
    return F, _clamped_left(P, V, 2), V, ({"d": d} if coeffs else {})


@pytest.mark.parametrize("what", ["coeff_grads", "no_cell_term"])
def test_generic_takes_what_multiqp_does_not(what):
    """Functionals that raised before the generic path take it and match
    the reference's Assembler: coefficient gradients (a case of
    test_torch_multiqp.py's raise test), no cell term. Its other case,
    terms of two quadrature degrees, is tests/test_lane.py:148's
    functional above."""
    Fj, bj, V, c = _not_multiqp("jax", what)
    Ft, bt, _, _ = _not_multiqp("torch", what)
    eng = TLaneEngine(Ft, bt, wg_own=8, **F64)
    assert eng.path == "generic"
    rng = np.random.default_rng(9)
    _parity(eng, JAssembler(Fj, bj), rng.normal(size=V.n_dofs) * 1e-3,
            rng.normal(size=V.n_dofs), c,
            {k: jnp.asarray(v) for k, v in c.items()}, 1e-12)


# -- the reference study's functional ---------------------------------------------


def test_mechanic2d_functional_on_the_lane_engine():
    """mechanic2d.setup at r = 0 (asym damage at degree 1, the volumetric
    load at degree 2; d P1, E DG0, f in the displacement space): the
    generic engine against the port's flat Assembler, which is held
    against the reference's in test_torch_mechanic2d.py, and its residual
    against the reference's Assembler."""
    from tpufem.cases import mechanic2d as j_mech
    from tpufem.config import Mechanic2DConfig as JConfig
    from tpufem_torch.cases import mechanic2d as t_mech
    from tpufem_torch.config import Mechanic2DConfig as TConfig

    asm, coeffs, V, _, _ = t_mech.setup(TConfig(max_refine=0), **F64)
    eng = TLaneEngine(asm.functional, asm.bcs, **F64)
    assert eng.path == "generic"
    rng = np.random.default_rng(3)
    u = rng.normal(size=V.n_dofs) * 1e-3
    v = rng.normal(size=V.n_dofs)
    cc = eng.prepare_coeffs(coeffs)
    ul = eng.to_lane(u)
    ut, vt = to_torch(u, **F64), to_torch(v, **F64)
    r = eng.from_lane(eng.residual(ul, cc))
    assert _rel(r, asm.residual(ut, coeffs).numpy()) <= 1e-12
    lin = eng.linearize(ul, cc)
    jv = eng.from_lane(eng.make_tangent(ul, cc, lin)(eng.to_lane(v)))
    assert _rel(jv, asm.tangent_action(ut, coeffs, vt).numpy()) <= 1e-12
    free = asm.free_mask(torch.float64).numpy() > 0
    d = eng.from_lane(eng.diagonal(ul, cc, lin))
    assert _rel(d[free], asm.diagonal(ut, coeffs).numpy()[free]) <= 1e-12
    aj, cj, _, _, _ = j_mech.setup(JConfig(max_refine=0))
    assert _rel(r, aj.residual(jnp.asarray(u), cj)) <= 1e-12


# -- solves ------------------------------------------------------------------------

LANE_CFG = dict(cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=3000,
                newton_maxit=20)
MIXED_CFG = dict(cg_rtol=1e-8, newton_rtol=1e-10, cg_maxit=4000,
                 newton_maxit=30, amg_coarse_size=32)
CHUNK = {"jacobi": 200, "twolevel": 20, "amg": 200}


def _port_lane_solve(F, bcs, V, pc, n_cells=None, **kw):
    eng = TLaneEngine(F, bcs, wg_own=8, **F64)
    if pc == "twolevel":
        kw.update(fine_coeffs={}, twolevel_nc=n_cells)
    u, st = eng.make_solver(TSolverConfig(preconditioner=pc, **LANE_CFG),
                            cg_chunk=CHUNK[pc], **kw)(
        eng.to_lane(np.zeros(V.n_dofs)), eng.prepare_coeffs({}))
    return eng.from_lane(u), st


@pytest.fixture(scope="module")
def gold(gen):
    """The float64 Jacobi lane solve of the :148 problem."""
    u, st = _port_lane_solve(gen["Ft"], gen["bt"], gen["V"], "jacobi")
    assert st["converged"]
    return u, st


def test_generic_solve_matches_reference(gen, gold):
    """make_solver (Jacobi) on the generic engine against the reference's
    on its generic engine: the same Newton count, CG within 1 a step, u
    rel <= 1e-9."""
    ej = gen["ej"]
    uj, sj = ej.make_solver(JSolverConfig(**LANE_CFG), cg_chunk=200)(
        jnp.asarray(ej.to_lane(np.zeros(gen["V"].n_dofs))),
        ej.prepare_coeffs({}))
    ut, st = gold
    assert st["newton_iters"] == int(sj["newton_iters"])
    assert all(abs(a - int(b)) <= 1
               for a, b in zip(st["cg_iters"], sj["cg_iters"]))
    assert _rel(ut, ej.from_lane(uj)) <= 1e-9


def _port_solve(gen, solver, pc):
    if solver == "make_solver":
        return _port_lane_solve(gen["Ft"], gen["bt"], gen["V"], pc)
    eng = TLaneEngine(gen["Ft"], gen["bt"], wg_own=8, dtype=torch.float32,
                      device="cpu")
    u, st = eng.make_mixed_solver(
        TSolverConfig(preconditioner=pc, **MIXED_CFG), cg_chunk=CHUNK[pc])(
        torch.zeros(gen["V"].n_dofs, dtype=torch.float64), {},
        eng.prepare_coeffs({}))
    return u.numpy(), st


SOLVES = [("make_solver", "twolevel"), ("make_mixed_solver", "jacobi"),
          ("make_mixed_solver", "twolevel"), ("make_mixed_solver", "amg")]


@pytest.mark.parametrize("solver,pc", SOLVES)
def test_generic_solves_reach_the_root(gen, gold, solver, pc):
    """Every lane solver and preconditioner runs the generic engine
    unchanged: converged, on the float64 Jacobi root to rel <= 1e-9."""
    u, st = _port_solve(gen, solver, pc)
    assert st["converged"]
    assert _rel(u, gold[0]) <= 1e-9


@pytest.mark.parametrize("solver,pc", [
    case if case == ("make_solver", "twolevel")
    else pytest.param(*case, marks=pytest.mark.slow) for case in SOLVES])
def test_generic_solves_match_reference(gen, solver, pc):
    """The same solves against the reference's: the same Newton count, CG
    within 1 a step, u rel <= 1e-9. The reference's interpret-mode solves
    compile for 15-40 s each on the CPU, whatever the mesh, so the
    two-level make_solver runs in tier 1 and the mixed ones are slow
    (test_torch_facets.py holds a mixed solve against the reference in
    tier 1)."""
    V = gen["V"]
    if solver == "make_solver":
        ej = gen["ej"]
        uj, sj = ej.make_solver(
            JSolverConfig(preconditioner=pc, **LANE_CFG), cg_chunk=CHUNK[pc],
            fine_coeffs={})(jnp.asarray(ej.to_lane(np.zeros(V.n_dofs))),
                            ej.prepare_coeffs({}))
        uj = ej.from_lane(uj)
    else:
        ej = JLaneEngine(gen["Fj"], gen["bj"], wg_own=8, interpret=True,
                         store_dtype=np.float32)
        uj, sj = ej.make_mixed_solver(
            JSolverConfig(preconditioner=pc, error_on_nonconvergence=False,
                          **MIXED_CFG), cg_chunk=CHUNK[pc])(
            jnp.zeros(V.n_dofs), {}, ej.prepare_coeffs({}))
    ut, st = _port_solve(gen, solver, pc)
    assert st["newton_iters"] == int(sj["newton_iters"])
    assert all(abs(a - int(b)) <= 1
               for a, b in zip(st["cg_iters"], sj["cg_iters"]))
    assert _rel(ut, np.asarray(uj)) <= 1e-9
