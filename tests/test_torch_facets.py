"""Facet (ds-measure, traction) terms of tpufem_torch against tpufem (CPU,
float64, the same numpy inputs through both; the reference's Pallas
kernels in interpret mode, the port's wrappers on their plain versions):
the facet tables of ``EnergyFunctional`` exactly; the flat ``Assembler``'s
energy, residual, tangent action, diagonal, assembled matrix and element
action; the lane engine's facet tables exactly and its residual, tangent
and diagonal on the P1 staged, P1 fused and multi-quadrature-point paths;
and the solves of tests/test_facets.py and tests/test_lane.py:617 / :662
on the flat Newton solvers, ``make_solver`` (Jacobi, two-level) and
``make_mixed_solver`` (Jacobi, two-level, AMG).

Tolerances: assembled quantities rel <= 1e-12 (sums in other orders); the
assembled matrix against the jvp tangent 1e-11 (tests/test_facets.py's
bound); solves against the reference's: the same Newton count, CG within
1 a step, u rel <= 1e-9; against the plane-strain analytic solution, max
error <= 1e-10 (tests/test_facets.py: 1e-12 for the flat solve, 1e-10 for
the lane one)."""

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
T = 1000.0  # the traction of tests/test_facets.py
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


def _right(P, mesh):
    return P.topo.locate_entities_boundary(
        mesh, mesh.dim - 1, lambda x: np.abs(x[:, 0] - 1) < 1e-12)


def _uniaxial(pkg, n=8):
    """tests/test_facets.py:81: plane strain, traction T on x = 1, u_x = 0
    on x = 0, u_y = 0 on y = 0."""
    P = _pkg(pkg)
    mesh = P.mesh.unit_square(n)
    V = P.sp.FunctionSpace.create(mesh, 1, bs=2)
    stiff = P.form.Term(
        lambda qp: P.forms.linear_elastic_psi(qp.eps, E, NU), 1)
    trac = P.form.FacetTerm(lambda f: -T * f.u[0], 2,
                            facets=_right(P, mesh))
    F = P.form.EnergyFunctional(V, [stiff], facet_terms=[trac], **P.kw)
    left_x = P.bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    bot_y = P.bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 1]) < 1e-12)
    bcs = [P.sp.DirichletBC(V, left_x, 0.0, components=[0]),
           P.sp.DirichletBC(V, bot_y, 0.0, components=[1])]
    return F, bcs, V


def _analytic_error(V, u):
    uu = np.asarray(u).reshape(-1, 2)
    exx = T * (1 - NU ** 2) / E
    eyy = -NU * (1 + NU) * T / E
    x = V.dof_coords
    return max(np.abs(uu[:, 0] - exx * x[:, 0]).max(),
               np.abs(uu[:, 1] - eyy * x[:, 1]).max())


def _nonlinear(pkg, n=5, mesh=None, deg=1):
    """tests/test_facets.py:146: a facet energy quadratic and cubic in u
    (a state-dependent facet Hessian), x = 0 clamped."""
    P = _pkg(pkg)
    mesh = P.mesh.unit_square(n) if mesh is None else mesh(P.mesh)
    dim = mesh.x.shape[1]
    V = P.sp.FunctionSpace.create(mesh, deg, bs=dim)
    stiff = P.form.Term(
        lambda qp: P.forms.linear_elastic_psi(qp.eps, E, NU),
        1 if deg == 1 and mesh.cell_type in ("triangle", "tetra") else 2)
    ft = P.form.FacetTerm(
        lambda f: -1e3 * f.u[0] + 2e2 * P.dot(f.u, f.u)
        + 50.0 * f.u[0] ** 2 * f.u[1] + 2.0 * P.dot(f.normal, f.u),
        2, facets=_right(P, mesh))
    F = P.form.EnergyFunctional(V, [stiff], facet_terms=[ft], **P.kw)
    left = P.bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    return F, [P.sp.DirichletBC(V, left, [0.0] * dim)], V


# -- forms: the facet tables ---------------------------------------------------

TABLE_KINDS = {
    "p1_tri_right": (lambda m: m.unit_square(4), 1, "right"),
    "p1_tri_all": (lambda m: m.unit_square(3), 1, "all"),
    "q1_quad_right": (lambda m: m.unit_square(3, cell_type="quad"), 1,
                      "right"),
    "p1_tet_all": (lambda m: m.box(2, 2, 2, cell_type="tetra"), 1, "all"),
    "p2_tet_right": (lambda m: m.box(2, 2, 2, cell_type="tetra"), 2,
                     "right"),
    "q2_hex_all": (lambda m: m.box(2, 1, 2), 2, "all"),
}


def _tables(pkg, kind):
    P = _pkg(pkg)
    make, deg, where = TABLE_KINDS[kind]
    mesh = make(P.mesh)
    dim = mesh.x.shape[1]
    V = P.sp.FunctionSpace.create(mesh, deg, bs=dim)
    if where == "right":
        facets = _right(P, mesh)
    else:
        facets = P.topo.locate_entities_boundary(
            mesh, mesh.dim - 1, lambda x: np.ones(len(x), bool))
    terms = [P.form.FacetTerm(lambda f: -T * f.u[0], 2, facets=facets),
             P.form.FacetTerm(lambda f: P.dot(f.normal, f.u), 3,
                              facets=facets[::2])]
    return P.form.EnergyFunctional(V, [], facet_terms=terms, **P.kw)


@pytest.mark.parametrize("kind", sorted(TABLE_KINDS))
def test_facet_tables_match_reference(kind):
    """Facet dofmap, coordinates and normals (float64 host arithmetic on
    both sides) and every tabulation: exactly the reference's."""
    Fj, Ft = _tables("jax", kind), _tables("torch", kind)
    fj, ft = Fj.facet_energy_fns(), Ft.facet_energy_fns()
    assert len(fj) == len(ft) == 2
    for (_, *aj), (_, *at) in zip(fj, ft):
        for a, b in zip(aj, at):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for sj, st in zip(Fj._facet_static, Ft._facet_static):
        for key in ("qw", "N_u", "N_geom", "dN_geom"):
            np.testing.assert_array_equal(st[key], sj[key])


def test_facet_terms_on_2d_degree2_spaces_raise_as_in_reference():
    """The reference's 2D degree-2 facet needs a degree-2 interval
    element, which neither package has: both raise the same error."""
    for P in (_pkg("jax"), _pkg("torch")):
        mesh = P.mesh.unit_square(3)
        V = P.sp.FunctionSpace.create(mesh, 2, bs=2)
        ft = P.form.FacetTerm(lambda f: -T * f.u[0], 2,
                              facets=_right(P, mesh))
        with pytest.raises(NotImplementedError, match="interval degree 2"):
            P.form.EnergyFunctional(V, [], facet_terms=[ft], **P.kw)


@pytest.mark.parametrize("cell", ["tetra", "hexahedron"])
def test_3d_degree2_facet_load_is_the_reference_rule(cell):
    """On a 3D degree-2 space the facet reads its vertex dofs with the
    degree-1 facet basis, as the reference does: the total load of a
    traction T on the face x = 1 is T x area, all of it on vertex dofs,
    and the residual equals the reference's."""
    out = []
    for pkg in ("jax", "torch"):
        P = _pkg(pkg)
        mesh = P.mesh.box(2, 2, 2, cell_type=cell)
        V = P.sp.FunctionSpace.create(mesh, 2, bs=3)
        ft = P.form.FacetTerm(lambda f: -T * f.u[0], 2,
                              facets=_right(P, mesh))
        F = P.form.EnergyFunctional(V, [], facet_terms=[ft], **P.kw)
        asm = (JAssembler if pkg == "jax" else TAssembler)(F)
        z = jnp.zeros(V.n_dofs) if pkg == "jax" else torch.zeros(
            V.n_dofs, dtype=torch.float64)
        out.append(np.asarray(asm.residual(z, {})).reshape(-1, 3))
    rj, rt = out
    assert _rel(rt, rj) <= 1e-12
    assert rt[:, 0].sum() == pytest.approx(-T, rel=1e-12)
    assert np.count_nonzero(rt[mesh.n_nodes:]) == 0  # no edge / face dof


# -- the flat Assembler ----------------------------------------------------------


@pytest.fixture(scope="module")
def flat_nl():
    Fj, bj, V = _nonlinear("jax", 6)
    Ft, bt, _ = _nonlinear("torch", 6)
    rng = np.random.default_rng(4)
    u = rng.normal(size=V.n_dofs) * 1e-3
    v = rng.normal(size=V.n_dofs)
    aj, at = JAssembler(Fj, bj), TAssembler(Ft, bt)
    uj, vj = jnp.asarray(u), jnp.asarray(v)
    ut, vt = to_torch(u, **F64), to_torch(v, **F64)
    ref = dict(
        energy=float(aj.energy(uj, {})),
        r=np.asarray(aj.residual(uj, {})),
        jv=np.asarray(aj.tangent_action(uj, {}, vj)),
        diag=np.asarray(aj.diagonal(uj, {})),
        matvec=np.asarray(aj.matrix(uj, {}).matvec(vj)),
    )
    lin = at.linearize(ut, {})
    got = dict(
        energy=float(at.energy(ut, {})),
        r=at.residual(ut, {}).numpy(),
        jv=at.tangent_action(ut, {}, vt).numpy(),
        diag=at.diagonal(ut, {}).numpy(),
        matvec=at.matrix(ut, {}).matvec(vt).numpy(),
        element_action=at.element_action(lin, vt).numpy(),
        diag_lin=at.diagonal(ut, {}, lin).numpy(),
    )
    return dict(ref=ref, got=got, at=at, ut=ut, V=V, lin=lin, u=u, v=v,
                Fj=Fj, bj=bj, Ft=Ft, bt=bt)


@pytest.mark.parametrize("what", ["r", "jv", "diag", "matvec",
                                  "element_action", "diag_lin"])
def test_assembler_facet_parity(flat_nl, what):
    """Residual, jvp tangent, diagonal, assembled matrix and the element
    action of ``linearize`` (cells and facets) against the reference's."""
    ref = flat_nl["ref"]
    key = {"element_action": "jv", "diag_lin": "diag"}.get(what, what)
    assert _rel(flat_nl["got"][what], ref[key]) <= 1e-12


def test_assembler_facet_energy(flat_nl):
    got, ref = flat_nl["got"]["energy"], flat_nl["ref"]["energy"]
    assert abs(got - ref) <= 1e-12 * abs(ref)


def test_assembled_matrix_includes_facet_hessian():
    """tests/test_facets.py:146: for a nonlinear facet energy the
    assembled matrix agrees with the (exact) jvp tangent_action, and the
    diagonal with the matrix's."""
    Ft, bt, V = _nonlinear("torch")
    asm = TAssembler(Ft, bt)
    rng = np.random.default_rng(4)
    u = to_torch(rng.normal(size=V.n_dofs) * 1e-3, **F64)
    A = asm.matrix(u, {})
    free = asm.free_mask(torch.float64).numpy()
    for _ in range(3):
        v = to_torch(rng.normal(size=V.n_dofs) * free, **F64)
        av_ref = asm.tangent_action(u, {}, v).numpy() * free
        av = A.matvec(v).numpy() * free
        assert np.abs(av - av_ref).max() < 1e-11 * np.abs(av_ref).max()
    d = asm.diagonal(u, {}).numpy()
    for i in rng.choice(np.nonzero(free)[0], size=12, replace=False):
        ei = torch.zeros(V.n_dofs, dtype=torch.float64)
        ei[i] = 1.0
        dA = float(A.matvec(ei)[i])
        assert abs(d[i] - dA) < 1e-11 * max(abs(dA), 1.0)


def test_cell_element_matrices_alone_are_refused_with_facet_terms(flat_nl):
    """What ``element_matrices`` returns is the cell part only: with facet
    terms, ``element_action`` / ``constrained_action`` / ``diagonal``
    refuse it rather than drop the facet tangent."""
    at, ut = flat_nl["at"], flat_nl["ut"]
    em = at.element_matrices(ut, {})
    with pytest.raises(ValueError, match="facet terms"):
        at.element_action(em, ut)
    with pytest.raises(ValueError, match="facet terms"):
        at.constrained_action(ut, {}, em)(ut)
    with pytest.raises(ValueError, match="facet terms"):
        at.diagonal(ut, {}, em)
    assert torch.equal(flat_nl["lin"].cells, em)


def test_pressure_normal_consistency():
    """tests/test_facets.py:57: pressure on the whole boundary; the
    residual at u = 0 sums to zero per component and the energy of u = x
    is 2p; both equal the reference's."""
    p = 500.0
    out = {}
    for pkg in ("jax", "torch"):
        P = _pkg(pkg)
        mesh = P.mesh.unit_square(6)
        V = P.sp.FunctionSpace.create(mesh, 1, bs=2)
        allb = P.topo.locate_entities_boundary(
            mesh, 1, lambda x: np.ones(len(x), bool))
        term = P.form.FacetTerm(lambda f: p * P.dot(f.normal, f.u), 2,
                                facets=allb)
        F = P.form.EnergyFunctional(V, [], facet_terms=[term], **P.kw)
        ux = V.dof_coords.reshape(-1)
        if pkg == "jax":
            asm = JAssembler(F, [])
            out[pkg] = (np.asarray(asm.residual(jnp.zeros(V.n_dofs), {})),
                        float(asm.energy(jnp.asarray(ux), {})))
        else:
            asm = TAssembler(F, [])
            out[pkg] = (asm.residual(torch.zeros(V.n_dofs,
                                                 dtype=torch.float64),
                                     {}).numpy(),
                        float(asm.energy(to_torch(ux, **F64), {})))
    r, en = out["torch"]
    assert np.abs(r.reshape(-1, 2).sum(axis=0)).max() < 1e-10
    assert np.isclose(en, 2.0 * p, rtol=1e-12)
    assert _rel(r, out["jax"][0]) <= 1e-12
    assert en == pytest.approx(out["jax"][1], rel=1e-12)


def test_uniaxial_traction_plane_strain():
    """tests/test_facets.py:25: the flat Assembler under NewtonSolver,
    the operator and the Jacobi diagonal from one ``linearize`` a step,
    lands on the analytic solution (the counts against the reference's
    are held by the lane solve below)."""
    from tpufem_torch.la import jacobi_preconditioner
    from tpufem_torch.nls import NewtonSolver

    Ft, bt, V = _uniaxial("torch")
    at = TAssembler(Ft, bt)
    lin = {}

    def em(w):
        if lin.get("u") is not w:
            lin.update(u=w, em=at.linearize(w, {}))
        return lin["em"]

    rt = NewtonSolver(TSolverConfig()).solve(
        torch.zeros(V.n_dofs, dtype=torch.float64),
        rhs=lambda w: at.lifted_rhs(w, {}),
        operator=lambda w: at.constrained_action(w, {}, em(w)),
        precond=lambda w: jacobi_preconditioner(at.diagonal(w, {}, em(w))))
    assert rt.converged
    assert _analytic_error(V, rt.u.numpy()) < 1e-12


@pytest.mark.parametrize("how", ["ell", "matrix_free", "chunked"])
def test_flat_newton_solvers_carry_facets(how):
    """make_newton_solver (assembled ELL and the element action of
    ``linearize``) and make_chunked_solver on the uniaxial problem: the
    analytic solution."""
    from tpufem_torch.nls.newton_chunked import make_chunked_solver
    from tpufem_torch.nls.newton_jit import make_newton_solver

    Ft, bt, V = _uniaxial("torch")
    asm = TAssembler(Ft, bt)
    cfg = TSolverConfig(cg_rtol=1e-13, cg_maxit=2000)
    u0 = torch.zeros(V.n_dofs, dtype=torch.float64)
    if how == "chunked":
        res = make_chunked_solver(asm, cfg)(u0, {})
    else:
        res = make_newton_solver(asm, cfg, use_matrix=how == "ell")(u0, {})
    assert res.converged
    assert _analytic_error(V, res.u.numpy()) < 1e-10


# -- the lane engine -----------------------------------------------------------


@pytest.fixture(scope="module")
def lane_nl(flat_nl):
    """The reference's engine on the nonlinear facet problem and the
    port's staged and fused engines on its plan; the reference's lane
    residual (its interpret-mode kernels compile for seconds each), and
    its flat results of ``flat_nl`` at the same state."""
    s = flat_nl
    ej = JLaneEngine(s["Fj"], s["bj"], wg_own=8, interpret=True)
    plan = lane_plan_from_numpy(lane_plan_fields(ej.plan))
    ulj = jnp.asarray(ej.to_lane(s["u"]))
    ref = dict(r=np.asarray(ej.residual(ulj, ej.prepare_coeffs({}))))
    free = np.asarray(JAssembler(s["Fj"], s["bj"]).free_mask(jnp.float64))
    flat = dict(r=s["ref"]["r"], jv=s["ref"]["jv"],
                diag=s["ref"]["diag"] * free)
    engines = {name: TLaneEngine(s["Ft"], s["bt"], plan=plan, fused=fused,
                                 **F64)
               for name, fused in (("staged", False), ("fused", True))}
    return dict(ej=ej, ref=ref, flat=flat, free=free, engines=engines,
                u=s["u"], v=s["v"])


def test_lane_facet_tables_match_reference(lane_nl):
    """upos / spos / ssrc / ucpos: exactly the reference's, on its plan."""
    ej = lane_nl["ej"]
    for eng in lane_nl["engines"].values():
        assert len(eng.facet_arrays) == len(ej.facet_arrays) == 1
        for a, b in zip(ej.facet_arrays, eng.facet_arrays):
            for key in ("upos", "spos", "ssrc", "ucpos"):
                np.testing.assert_array_equal(b[key].numpy(),
                                              np.asarray(a[key]))
        assert len(eng._facet_plan.targets) < len(
            eng.facet_arrays[0]["spos"])  # slots repeat: a sum, not a store


@pytest.mark.parametrize("engine", ["staged", "fused"])
@pytest.mark.parametrize("what", ["r", "jv", "jv_lin", "jv_cells", "diag"])
def test_lane_facet_parity(lane_nl, engine, what):
    """Residual, tangent action (one-off, from ``linearize``, from the
    gathered cells) and diagonal, lane -> flat against the reference's
    Assembler (the diagonal on free dofs), and the residual in lane
    layout against the reference's engine on the same plan."""
    eng = lane_nl["engines"][engine]
    cc = eng.prepare_coeffs({})
    ul, vl = eng.to_lane(lane_nl["u"]), eng.to_lane(lane_nl["v"])
    if what == "r":
        out = eng.residual(ul, cc)
    elif what == "jv":
        out = eng.tangent_action(ul, cc, vl)
    elif what == "jv_lin":
        out = eng.make_tangent(ul, cc, eng.linearize(ul, cc))(vl)
    elif what == "jv_cells":
        out = eng.tangent_from_cells(eng._gather_cells(ul), cc, vl)
    else:
        out = eng.diagonal(ul, cc)
    key = what if what in ("r", "diag") else "jv"
    flat = eng.from_lane(out) * (lane_nl["free"] if key == "diag" else 1.0)
    assert _rel(flat, lane_nl["flat"][key]) <= 1e-12
    if key in lane_nl["ref"]:
        assert _rel(out.numpy(), lane_nl["ref"][key]) <= 1e-12
    assert torch.equal(eng.refresh_copies(out), out)


MQ_KINDS = {
    "q1_quad": (lambda m: m.unit_square(5, cell_type="quad"), 1),
    "p2_tet": (lambda m: m.box(2, 2, 2, cell_type="tetra"), 2),
}


@pytest.mark.parametrize("kind", [
    "q1_quad", pytest.param("p2_tet", marks=pytest.mark.slow)])
def test_multiqp_facet_parity(kind):
    """Facet terms on the multi-quadrature-point path: residual and
    tangent against the reference's Assembler, the diagonal on free dofs
    against the port's (the reference's 3D Hessian compiles for about a
    minute on the CPU). ``p2_tet`` is slow: the reference's 3D residual
    and jvp compile for about 12 s."""
    make, deg = MQ_KINDS[kind]
    Fj, bj, V = _nonlinear("jax", mesh=make, deg=deg)
    Ft, bt, _ = _nonlinear("torch", mesh=make, deg=deg)
    eng = TLaneEngine(Ft, bt, wg_own=8, **F64)
    assert eng.path == "multiqp"
    rng = np.random.default_rng(5)
    u = rng.normal(size=V.n_dofs) * 1e-3
    v = rng.normal(size=V.n_dofs)
    cc = eng.prepare_coeffs({})
    ul = eng.to_lane(u)
    aj = JAssembler(Fj, bj)
    assert _rel(eng.from_lane(eng.residual(ul, cc)),
                aj.residual(jnp.asarray(u), {})) <= 1e-12
    assert _rel(eng.from_lane(eng.tangent_action(ul, cc, eng.to_lane(v))),
                aj.tangent_action(jnp.asarray(u), {}, jnp.asarray(v))) \
        <= 1e-12
    free = eng.from_lane(eng.free_lane) > 0
    ref = TAssembler(Ft, bt).diagonal(to_torch(u, **F64), {}).numpy()
    assert _rel(eng.from_lane(eng.diagonal(ul, cc))[free], ref[free]) \
        <= 1e-12


def test_facet_state_needs_ucpos_or_u_lane(lane_nl):
    """The reference's NotImplementedError where neither the gathered
    cells (with a ucpos table) nor the lane state is at hand."""
    eng = lane_nl["engines"]["staged"]
    arrs = eng.facet_arrays[0]
    ucpos = arrs.pop("ucpos")
    try:
        with pytest.raises(NotImplementedError, match="ucpos"):
            eng.facet_hessians(u_cells=eng._gather_cells(eng.bc_lane))
    finally:
        arrs["ucpos"] = ucpos


# -- solves ----------------------------------------------------------------------

LANE_CFG = dict(cg_rtol=1e-13, cg_maxit=2000)


def test_lane_facet_solve_matches_flat():
    """tests/test_lane.py:662: the facet-loaded Jacobi solve on the lane
    engine lands on the analytic solution, with the reference's counts."""
    Fj, bj, V = _uniaxial("jax", 6)
    ej = JLaneEngine(Fj, bj, interpret=True)
    uj, sj = ej.make_solver(JSolverConfig(**LANE_CFG))(
        jnp.asarray(ej.to_lane(np.zeros(V.n_dofs))), ej.prepare_coeffs({}))
    Ft, bt, _ = _uniaxial("torch", 6)
    eng = TLaneEngine(Ft, bt, plan=lane_plan_from_numpy(
        lane_plan_fields(ej.plan)), **F64)
    ut, st = eng.make_solver(TSolverConfig(**LANE_CFG))(
        eng.to_lane(np.zeros(V.n_dofs)), eng.prepare_coeffs({}))
    assert st["converged"]
    ut = eng.from_lane(ut)
    assert _analytic_error(V, ut) < 1e-10
    assert st["newton_iters"] == int(sj["newton_iters"])
    assert abs(st["total_cg_iters"] - int(sj["total_cg_iters"])) \
        <= st["newton_iters"]
    assert _rel(ut, ej.from_lane(uj)) <= 1e-9


def test_newton_quadratic_convergence_nonlinear_facet():
    """tests/test_facets.py:191: the lane engine's Newton on a nonlinear
    facet energy converges in <= 5 steps to 1e-12 (its linearization
    carries the facet Hessian), onto the flat Newton's root."""
    from tpufem_torch.nls.newton_jit import make_newton_solver

    P = _pkg("torch")
    mesh = P.mesh.unit_square(6)
    V = P.sp.FunctionSpace.create(mesh, 1, bs=2)
    stiff = P.form.Term(lambda qp: t_forms.linear_elastic_psi(qp.eps, E, NU),
                        1)
    ft = P.form.FacetTerm(lambda f: -2e3 * f.u[0] + 1e5 * f.u[0] ** 2
                          * f.u[0], 3, facets=_right(P, mesh))
    F = P.form.EnergyFunctional(V, [stiff], facet_terms=[ft], **F64)
    left = P.bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    bcs = [P.sp.DirichletBC(V, left, [0.0, 0.0])]
    cfg = TSolverConfig(newton_rtol=1e-12, cg_rtol=1e-14, cg_maxit=3000,
                        newton_maxit=12)
    eng = TLaneEngine(F, bcs, **F64)
    u, st = eng.make_solver(cfg)(eng.to_lane(np.zeros(V.n_dofs)),
                                 eng.prepare_coeffs({}))
    assert st["converged"] and st["newton_iters"] <= 5, st
    flat = make_newton_solver(TAssembler(F, bcs), cfg)(
        torch.zeros(V.n_dofs, dtype=torch.float64), {})
    assert flat.converged
    assert _rel(eng.from_lane(u), flat.u.numpy()) <= 1e-9


MIXED_CFG = dict(cg_rtol=1e-8, newton_rtol=1e-10, cg_maxit=4000,
                 newton_maxit=30, amg_coarse_size=32)
CHUNK = {"jacobi": 200, "twolevel": 20, "amg": 200}


def _port_solve(solver, pc, n=8, mixed_cfg=MIXED_CFG):
    Ft, bt, V = _uniaxial("torch", n)
    if solver == "make_solver":
        eng = TLaneEngine(Ft, bt, wg_own=8, **F64)
        cc = eng.prepare_coeffs({})
        kw = dict(fine_coeffs={}) if pc == "twolevel" else {}
        u, st = eng.make_solver(TSolverConfig(preconditioner=pc, **LANE_CFG),
                                cg_chunk=CHUNK[pc], **kw)(
            eng.to_lane(np.zeros(V.n_dofs)), cc)
        return eng.from_lane(u), st, V
    eng = TLaneEngine(Ft, bt, wg_own=8, dtype=torch.float32, device="cpu")
    u, st = eng.make_mixed_solver(
        TSolverConfig(preconditioner=pc, **mixed_cfg), cg_chunk=CHUNK[pc])(
        torch.zeros(V.n_dofs, dtype=torch.float64), {},
        eng.prepare_coeffs({}))
    return u.numpy(), st, V


def _ref_solve(solver, pc, n=8, mixed_cfg=MIXED_CFG):
    """The reference's solve of ``_port_solve``'s problem."""
    Fj, bj, V = _uniaxial("jax", n)
    if solver == "make_solver":
        ej = JLaneEngine(Fj, bj, wg_own=8, interpret=True)
        kw = dict(fine_coeffs={}) if pc == "twolevel" else {}
        uj, sj = ej.make_solver(JSolverConfig(preconditioner=pc, **LANE_CFG),
                                cg_chunk=CHUNK[pc], **kw)(
            jnp.asarray(ej.to_lane(np.zeros(V.n_dofs))),
            ej.prepare_coeffs({}))
        return ej.from_lane(uj), sj
    ej = JLaneEngine(Fj, bj, wg_own=8, interpret=True, store_dtype=np.float32)
    uj, sj = ej.make_mixed_solver(
        JSolverConfig(preconditioner=pc, error_on_nonconvergence=False,
                      **mixed_cfg), cg_chunk=CHUNK[pc])(
        jnp.zeros(V.n_dofs), {}, ej.prepare_coeffs({}))
    return np.asarray(uj), sj


SOLVES = [("make_solver", "twolevel"), ("make_mixed_solver", "jacobi"),
          ("make_mixed_solver", "twolevel"), ("make_mixed_solver", "amg")]


@pytest.mark.parametrize("solver,pc", SOLVES)
def test_facet_solves_reach_the_analytic_solution(solver, pc):
    """Each lane solver and preconditioner carries the traction: the
    two-level cycle's coarse lattice rediscretizes the first cell term
    only (the reference's rule; the facet Hessian of a traction is 0),
    the mixed solver's float64 residuals and AMG matrix come from the flat
    Assembler, facets included."""
    u, st, V = _port_solve(solver, pc)
    assert st["converged"]
    assert _analytic_error(V, u) < 1e-10


@pytest.mark.parametrize("solver,pc", [
    case if case == ("make_mixed_solver", "amg")
    else pytest.param(*case, marks=pytest.mark.slow) for case in SOLVES])
def test_facet_solves_match_reference(solver, pc):
    """The same solves against the reference's: the same Newton count, CG
    within 1 a step, u rel <= 1e-9. The reference's interpret-mode solves
    compile for 15-40 s each on the CPU, whatever the mesh, so the mixed
    AMG solve (its float64 outer residuals and AMG matrix from the flat
    Assembler, facet slots included) runs in tier 1 and the others are
    slow (test_torch_generic.py holds the two-level make_solver against
    the reference in tier 1).

    The mixed Jacobi solve's second step is held to the Newton count and
    u alone. Its right-hand side is the float64 residual that the first
    step's float32 inner CG leaves on this linear problem, so it is made
    of that CG's rounding, and its CG count moves with the rounding. The
    first step agrees within 1 everywhere, the second does not, and the
    gap does not close at looser tolerances (reference / port, CPU: n = 8
    at cg_rtol 1e-8 86, 83 / 85, 81; 1e-7 80, 79 / 79, 75; 1e-6 75, 72 /
    75, 68; n = 10 at 1e-8 110, 106 / 110, 104; 1e-6 96, 91 / 96, 90).
    (test_mixed_jacobi_first_step_matches_reference holds those cases.
    The cause: the reference's engine takes the generic element path for
    any functional with facet terms, the port's the P1 path;
    test_mixed_jacobi_on_the_reference_path_matches_every_step holds
    every step within 1 on the generic path.)
    The port's own mixed Jacobi solve of this problem at n = 32 moves the
    same way between the card and the CPU: 367, 339 against 367, 340
    (chip_smoke.py, facets_generic (c))."""
    uj, sj = _ref_solve(solver, pc)
    ut, st, _ = _port_solve(solver, pc)
    assert st["newton_iters"] == int(sj["newton_iters"])
    held = 1 if (solver, pc) == ("make_mixed_solver", "jacobi") else None
    assert all(abs(a - int(b)) <= 1
               for a, b in zip(st["cg_iters"][:held], sj["cg_iters"][:held]))
    assert _rel(ut, np.asarray(uj)) <= 1e-9


@pytest.mark.slow
@pytest.mark.parametrize("n,cg_rtol", [(8, 1e-7), (8, 1e-6), (10, 1e-8),
                                       (10, 1e-6)])
def test_mixed_jacobi_first_step_matches_reference(n, cg_rtol):
    """The mixed Jacobi solve at other inner tolerances and a second mesh
    (12-16 s of reference compile each): the same Newton count, the first
    step's CG within 1, u rel <= 1e-9; the second step's counts, which
    move with the first step's rounding, are printed (-s) and not held."""
    cfg = dict(MIXED_CFG, cg_rtol=cg_rtol)
    uj, sj = _ref_solve("make_mixed_solver", "jacobi", n, cfg)
    ut, st, _ = _port_solve("make_mixed_solver", "jacobi", n, cfg)
    print(f"n = {n}, cg_rtol = {cg_rtol}: reference CG "
          f"{[int(c) for c in sj['cg_iters']]}, port {list(st['cg_iters'])}")
    assert st["newton_iters"] == int(sj["newton_iters"])
    assert abs(st["cg_iters"][0] - int(sj["cg_iters"][0])) <= 1
    assert _rel(ut, uj) <= 1e-9


@pytest.mark.slow
@pytest.mark.parametrize("n", [8, 10])
def test_mixed_jacobi_on_the_reference_path_matches_every_step(n,
                                                               monkeypatch):
    """Why the mixed Jacobi traction solve's second step misses: the
    reference's engine takes the generic element path for any functional
    with facet terms (its _try_specialize_p1 refuses them,
    tpufem/lane/engine.py:493), the port's the P1 path; the float32 CG
    operators round differently. Put on the generic path too, the port's
    solve is within 1 CG of the reference's in every step (n = 8: 86, 83
    against 86, 83; n = 10: 110, 105 against 110, 106). None of the facet
    add's order, the facet Hessian re-taken per application or the
    reference's dot moves the second step (ROADMAP.md, "Recorded
    differences")."""
    uj, sj = _ref_solve("make_mixed_solver", "jacobi", n)
    monkeypatch.setattr(TLaneEngine, "_try_specialize_p1", lambda self: False)
    ut, st, _ = _port_solve("make_mixed_solver", "jacobi", n)
    assert st["newton_iters"] == int(sj["newton_iters"])
    assert all(abs(a - int(b)) <= 1
               for a, b in zip(st["cg_iters"], sj["cg_iters"]))
    assert _rel(ut, np.asarray(uj)) <= 1e-9
