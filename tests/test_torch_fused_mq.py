"""The fused kernel's generated multi-quadrature-point route (K4-gen-mq:
``lane/fused_gen.py:GenPhysicsMQ``, ``kernels.lane_fused_gen_mq``,
``csrc/lane_fused_gen_mq.cuh``) against tpufem (CPU, float64, the same
numpy inputs through both).

The reference traces its multi-point element function into its Pallas
kernel (``tpufem/lane/engine.py:1247-1329``); the port traces the point
graphs ahead of time, sums them over the points in the plain version and
in the kernel template. Here:

1. the emitted unit: the template's per-cell computation and the
   physics' C (host spelling), compiled by ``g++ -O2 -ffp-contract=off``
   into a throwaway host library, held against the plain version exactly
   (integrands without sqrt / log, whose CPU kernels PyTorch rounds
   otherwise than the C library);
2. ``fused_geom`` exactly the reference's (and the coefficient block);
3. the plain version against the reference's Pallas ``lane_fused_elem``
   in interpret mode with the reference's own ``_elem_grad_block`` /
   ``_elem_jvp_block``, rel <= 1e-12 (P2 triangles; Q2 hexahedra are
   ``slow``: the reference's interpret-mode Q2 kernel compiles for over
   two minutes on the CPU);
4. engines, fused against staged, the reference's flat ``Assembler`` and
   (P2) the reference's fused engine: residual and tangent rel <= 1e-12;
5. a fused Jacobi solve against the reference's, the two-level and mixed
   solvers on a fused engine onto its root;
6. ``fused_gen_mq_geometry``: the block layouts and the raise.

Meshes are unit_square(<= 5) and box(2) with ``wg_own`` 8."""

import ctypes
import os
import shutil
import subprocess

import jax
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
from tpufem.lane import kernels as jk
from tpufem_torch.config import SolverConfig as TSolverConfig
from tpufem_torch.elements.lagrange import element
from tpufem_torch.elements.quadrature import quadrature
from tpufem_torch.lane import LaneEngine as TLaneEngine
from tpufem_torch.lane import _build
from tpufem_torch.lane import fused_gen as fg
from tpufem_torch.lane import kernels as tk
from tpufem_torch.mesh.mesh import CellType
from tpufem_torch.utils.convert import lane_plan_fields, lane_plan_from_numpy
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
F64 = dict(device="cpu", dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pkg(pkg):
    if pkg == "jax":
        return j_mesh, j_spaces, j_bc, j_forms, j_form, j_topo, jnp.dot, {}
    return (t_mesh, t_spaces, t_bc, t_forms, t_form, t_topo, torch.dot,
            F64)


def _elastic_d(forms):
    """tests/test_lane.py:541's integrand: (1 + d) * linear elasticity."""
    return lambda qp: (1.0 + qp.coeff("d")) * forms.linear_elastic_psi(
        qp.eps, E, NU)


def _elastic_d_x(forms, dim):
    """An x-using one: (1 + d/2) * linear elasticity and a load in x."""
    return lambda qp: (1.0 + 0.5 * qp.coeff("d")) * forms.linear_elastic_psi(
        qp.eps, E, NU) - 1e3 * qp.u[0] * qp.x[dim - 1]


# name: (mesh, element degree, terms (integrand maker, quadrature degree),
# facet traction on x = 1)
CASES = {
    "p2_tri": (lambda m: m.unit_square(5), 2,
               [(lambda f, dim: _elastic_d(f), 2)], False),
    "p2_tet": (lambda m: m.box(2, 2, 2, cell_type="tetra"), 2,
               [(lambda f, dim: _elastic_d(f), 2)], False),
    "q1_quad": (lambda m: m.unit_square(5, cell_type="quad"), 1,
                [(_elastic_d_x, 2)], False),
    "q2_hex": (lambda m: m.box(2, 2, 2), 2,
               [(lambda f, dim: _elastic_d(f), 3)], False),
    # tests/test_lane.py:579: two degree-1 terms, one x-using
    "p1_fold": (lambda m: m.unit_square(5), 1,
                [(lambda f, dim: _elastic_d(f), 1),
                 (lambda f, dim: lambda qp: -1e3 * qp.u[1] * qp.x[0], 1)],
                False),
    "p1_deg2": (lambda m: m.unit_square(5), 1,
                [(lambda f, dim: _elastic_d(f), 2)], False),
    "p2_x": (lambda m: m.unit_square(5), 2, [(_elastic_d_x, 2)], False),
    # a 2D degree-2 facet has no rule in either package: P2 tetrahedra
    "p2_tet_facet": (lambda m: m.box(2, 2, 2, cell_type="tetra"), 2,
                     [(lambda f, dim: _elastic_d(f), 2)], True),
}


def _problem(pkg, case):
    mesh_m, sp, bc, forms, form, topo, dot, kw = _pkg(pkg)
    make_mesh, deg, terms, facet = CASES[case]
    mesh = make_mesh(mesh_m)
    dim = mesh.x.shape[1]
    V = sp.FunctionSpace.create(mesh, deg, bs=dim)
    DS = sp.FunctionSpace.create(mesh, 1, bs=1)
    d = 0.3 + 0.2 * np.sin(4 * DS.dof_coords[:, 0]) * DS.dof_coords[:, 1]
    fts = []
    if facet:
        right = topo.locate_entities_boundary(
            mesh, mesh.dim - 1, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
        fts = [form.FacetTerm(
            lambda f: -1e3 * f.u[0] + 2e2 * dot(f.u, f.u), 2,
            facets=right)]
    F = form.EnergyFunctional(
        V, [form.Term(mk(forms, dim), q) for mk, q in terms],
        [form.Coefficient("d", DS)], facet_terms=fts, **kw)
    left = bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    return F, [sp.DirichletBC(V, left, [0.0] * dim)], V, {"d": d}


# -- 1. the emitted unit on the host -----------------------------------------------


def _host_lib(tmp_path, name, source):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")  # the tests' hosts have one
    src = tmp_path / f"{name}.cpp"
    src.write_text(source)
    so = tmp_path / f"{name}.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", "-I", _build.CSRC_DIR, "-o", str(so),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def _host_unit(ph):
    """The template's per-cell computation (``gen_mq_cell``) with the
    physics' host C, over cells-minor arrays: ``cells(ns, u (ns, nd, n),
    geom (dg, n), cd (dc, n), n, ev (nd, n))``."""
    return f"""#include <cmath>
#define GEN_HD inline
#define GEN_TABLE static const
#include "lane_fused_gen_mq.cuh"
{ph.c_struct("host")}
typedef GenPhys::GT GT;
extern "C" void cells(int ns, const GT* u, const GT* geom, const GT* cd,
                      long n, GT* ev) {{
  for (long m = 0; m < n; ++m) {{
    if (ns == 1)
      gen_mq_cell<GT, GenPhys, 1>(u + m, n, geom + m, n, cd + m, n, ev + m, n);
    else
      gen_mq_cell<GT, GenPhys, 2>(u + m, n, geom + m, n, cd + m, n, ev + m, n);
  }}
}}
"""


def _tables(cell, deg, qdeg, coeff_deg=1):
    qpts, _ = quadrature(cell, qdeg)
    return (np.asarray(element(cell, deg).tabulate(qpts)),
            np.asarray(element(cell, coeff_deg).tabulate(qpts)))


def _emit_case(case):
    """(physics, integrand) of the host-unit cases: P2 triangles with a
    nodal coefficient and x, Q1 quadrilaterals, and made-up tables with
    zero and unit weights (a point where some basis values vanish)."""
    if case == "p2_coeff":
        Nf, Nc = _tables(CellType.triangle, 2, 2)
        return dict(bs=2, gd=2, nv=6, Nf=Nf, Nc={"k": Nc},
                    meta=(("k", 3, 1),), psi=lambda qp: qp.coeff("k")
                    * t_forms.linear_elastic_psi(qp.eps, E, NU)
                    - 1e3 * qp.u[1] * qp.x[0])
    if case == "q1_quad":
        Nf, _ = _tables(CellType.quad, 1, 2)
        return dict(bs=2, gd=2, nv=4, Nf=Nf, Nc={}, meta=(),
                    psi=lambda qp: t_forms.linear_elastic_psi(qp.eps, E, NU)
                    + 3.0 * qp.u[0] * qp.u[1] * qp.x[1])
    Nf = np.array([[0.0, 1.0, 0.0], [0.25, 0.0, 0.75], [0.0, 0.0, 0.0],
                   [1.0, 0.5, -0.5]])
    Nc = np.array([[1.0, 0.0], [0.0, 0.0], [0.5, 0.5], [0.0, 2.0]])
    return dict(bs=1, gd=2, nv=3, Nf=Nf, Nc={"k": Nc, "c0": None},
                meta=(("k", 2, 1), ("c0", 1, 1)),
                psi=lambda qp: 0.5 * qp.coeff("k") * (
                    qp.grad_u[0, 0] ** 2 + qp.grad_u[0, 1] ** 2)
                + qp.coeff("c0") * qp.u * qp.u * qp.u - qp.u * qp.x[1])


@pytest.mark.parametrize("case", ["p2_coeff", "q1_quad", "zero_unit_weights"])
def test_emitted_unit_equals_the_plain_version(tmp_path, case):
    c = _emit_case(case)
    ph = fg.GenPhysicsMQ(c["psi"], bs=c["bs"], gd=c["gd"], nv=c["nv"],
                         coeff_meta=c["meta"], dtype=torch.float64,
                         Nf=c["Nf"], Nc=c["Nc"])
    assert ph.nq == len(c["Nf"]) and ph.x_rows
    assert ph.dg == ph.nq * ph.nv * ph.gd + ph.nq + ph.nq * ph.gd
    lib = _host_lib(tmp_path, case, _host_unit(ph))
    vp = ctypes.c_void_p
    lib.cells.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_long, vp]
    n, nd = 1500, ph.nv * ph.bs
    rng = np.random.default_rng(41)
    u = rng.standard_normal((2, nd, n))
    geom = rng.standard_normal((ph.dg, n))
    cd = rng.uniform(0.5, 2.0, (max(ph.n_coeff_rows, 1), n))
    for ns in (1, 2):
        ev = np.zeros((nd, n))
        us = np.ascontiguousarray(u[:ns])
        lib.cells(ns, us.ctypes.data, geom.ctypes.data, cd.ctypes.data, n,
                  ev.ctypes.data)
        want = ph.elem_vectors(
            [torch.from_numpy(u[s]) for s in range(ns)],
            (torch.from_numpy(geom), torch.from_numpy(cd))).numpy()
        assert np.isfinite(want).all()
        assert np.array_equal(ev, want), (ns, np.abs(ev - want).max())


def test_zero_weights_are_skipped():
    """A point where every basis value vanishes gives a zero value
    variable, and a zero weight adds nothing even to a non-finite dof: the
    plain version skips, point by point, what the kernel skips."""
    c = _emit_case("zero_unit_weights")
    ph = fg.GenPhysicsMQ(c["psi"], bs=1, gd=2, nv=3, coeff_meta=c["meta"],
                         dtype=torch.float64, Nf=c["Nf"], Nc=c["Nc"])
    u = torch.tensor([float("inf"), 2.0, 3.0])
    dN = [[torch.ones(4)] * 2] * 3
    vals = ph.reduced(u, dN)[2].tolist()  # the value variable, points 0-3
    assert vals[0] == 2.0 and vals[2] == 0.0  # 1 * u[1] (inf skipped); none
    assert vals[1] == vals[3] == float("inf")
    cd = torch.tensor([float("nan"), 5.0, 7.0])
    k, c0 = ph.coeff_inputs(cd)
    assert k.tolist()[1] == 0.0 and k.tolist()[3] == 10.0  # nan skipped
    assert c0.tolist() == [7.0] * 4  # P0: its one value at every point


# -- 2. the cell data: fused_geom exactly the reference's --------------------------


@pytest.mark.parametrize("case", ["p2_tri", "p2_x", "q2_hex"])
def test_fused_geom_equals_reference(case):
    """dN rows (q*nv+v)*gd+d, the nq weights, then the nq*gd point rows
    where the integrand reads x: the reference's rows value for value on
    its plan, and its coefficient block."""
    Fj, bj, Vj, co = _problem("jax", case)
    Ft, bt, _, _ = _problem("torch", case)
    ej = JLaneEngine(Fj, bj, wg_own=8, interpret=True, fused=True)
    assert ej._fused and ej._mq is not None  # no quiet fallback there
    plan = lane_plan_from_numpy(lane_plan_fields(ej.plan))
    ef = TLaneEngine(Ft, bt, plan=plan, fused=True, **F64)
    ph = ef.fused_gen(torch.float64)
    assert ef.path == "multiqp" and ph.MULTIQP
    assert ph.x_rows == (case == "p2_x") == (not ej._fused_no_xq)
    assert np.array_equal(ef.fused_geom.numpy(), np.asarray(ej.fused_geom))
    assert ef.fused_geom.shape[1] == ph.dg
    assert np.array_equal(ef.prepare_coeffs(co)["_cd"].numpy(),
                          np.asarray(ej.prepare_coeffs(co)["_cd"]))


# -- 3. the plain version against the Pallas original ------------------------------


def _pallas_ref(case):
    """The reference's fused engine (interpret mode) on ``case``, the
    port's on its plan, random lane states and the reference kernel's
    results in both modes (int32 indices)."""
    Fj, bj, Vj, co = _problem("jax", case)
    Ft, bt, _, _ = _problem("torch", case)
    ej = JLaneEngine(Fj, bj, wg_own=8, interpret=True, fused=True)
    assert ej._fused and ej._mq is not None
    plan = lane_plan_from_numpy(lane_plan_fields(ej.plan))
    ef = TLaneEngine(Ft, bt, plan=plan, fused=True, **F64)
    ccj, ccf = ej.prepare_coeffs(co), ef.prepare_coeffs(co)
    p = ej.plan
    rng = np.random.default_rng(23)
    u = 1e-3 * rng.standard_normal((Vj.bs, p.R, 128))
    v = rng.standard_normal((Vj.bs, p.R, 128))
    idx = jnp.asarray(np.asarray(p.gather_idx).astype(np.int32))
    cds_j = ej._fused_cds(ccj, jnp.float64)
    kern = {}
    for mode, states, fn in (("grad", (u,), ej._elem_grad_block),
                             ("jvp", (u, v), ej._elem_jvp_block)):
        kern[mode] = np.asarray(jk.lane_fused_elem(
            tuple(jnp.asarray(s) for s in states), ej.gather_starts, idx,
            cds_j, fn, wr=p.wg, nv=p.nv, k_block=ej._fused_kb,
            interpret=True))
    return dict(ej=ej, ef=ef, ccj=ccj, ccf=ccf, co=co, u=u, v=v, kern=kern,
                Vj=Vj)


@pytest.fixture(scope="module")
def ref_p2():
    return _pallas_ref("p2_tri")


def _check_plain_against_pallas(s, mode):
    ef = s["ef"]
    p = ef.plan
    states = (s["u"],) if mode == "grad" else (s["u"], s["v"])
    tk.reset_launch_counts()
    got = tk.lane_fused_gen(
        tuple(torch.from_numpy(x) for x in states), ef.gather_starts,
        ef.gather_idx.to(torch.int32), ef._fused_cds(s["ccf"], torch.float64),
        ef.fused_gen(torch.float64), wr=p.wg, nv=p.nv)
    want = s["kern"][mode]
    assert got.shape == want.shape == (p.G, ef.bs, p.wg, 128)
    assert got.permute(1, 0, 2, 3).is_contiguous()
    assert _rel(got.numpy(), want) <= 1e-12
    # CPU tensors: the plain version, no kernel launched
    assert tk.lane_fused_gen_mq.launches == tk.lane_fused_gen.launches == 0


@pytest.mark.parametrize("mode", ["grad", "jvp"])
def test_plain_matches_pallas_p2(ref_p2, mode):
    _check_plain_against_pallas(ref_p2, mode)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["grad", "jvp"])
def test_plain_matches_pallas_q2_hex(mode):
    """Slow: the reference's Q2 interpret-mode kernel compiles for over
    two minutes on the CPU."""
    _check_plain_against_pallas(_pallas_ref("q2_hex"), mode)


# -- 4. engines: fused == staged == the reference's flat Assembler -----------------


class _PerCase(dict):
    """Built on first use, case by case: a worker that runs some of the
    cases builds only those."""

    def __init__(self, make):
        super().__init__()
        self.make = make

    def __missing__(self, case):
        self[case] = self.make(case)
        return self[case]


@pytest.fixture(scope="module")
def engines():
    return _PerCase(_engines)


def _engines(case):
    """Fused and staged engines of ``case`` on one plan and the
    reference's flat Assembler: residuals and tangent actions (flat)."""
    rng = np.random.default_rng(31)
    Fj, bj, Vj, co = _problem("jax", case)
    Ft, bt, _, _ = _problem("torch", case)
    ef = TLaneEngine(Ft, bt, wg_own=8, fused=True, **F64)
    es = TLaneEngine(Ft, bt, plan=ef.plan, **F64)
    n = Vj.n_dofs
    u, v = 1e-3 * rng.standard_normal(n), rng.standard_normal(n)
    cf, cs = ef.prepare_coeffs(co), es.prepare_coeffs(co)
    ul, vl = ef.to_lane(u), ef.to_lane(v)
    aj = JAssembler(Fj, bj)
    cj = {k: jnp.asarray(x) for k, x in co.items()}
    # the reference's tangent action is the jvp of its residual
    # (tpufem/assemble/assembler.py:263): one jvp gives both, as its two
    # calls would, and walks the eager residual once
    rj, jvj = jax.jvp(lambda w: aj.residual(w, cj), (jnp.asarray(u),),
                      (jnp.asarray(v),))
    return dict(
        ef=ef,
        r=(ef.from_lane(ef.residual(ul, cf)),
           es.from_lane(es.residual(ul, cs)), np.asarray(rj)),
        jv=(ef.from_lane(ef.tangent_action(ul, cf, vl)),
            es.from_lane(es.tangent_action(ul, cs, vl)), np.asarray(jvj)))


@pytest.mark.parametrize("what", ["r", "jv"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_engine_parity(engines, case, what):
    e = engines[case]
    ef = e["ef"]
    assert ef.path == "multiqp" and ef._fused and ef.fused_law is None
    assert ef.fused_gen(torch.float64).nq == ef._mq.nq
    fused, staged, flat = e[what]
    assert _rel(fused, staged) <= 1e-12
    assert _rel(fused, flat) <= 1e-12
    assert bool(ef.functional.facet_terms) == (case == "p2_tet_facet")


@pytest.mark.parametrize("what", ["r", "jv"])
def test_fused_engine_matches_reference_fused_engine(ref_p2, what):
    """On the reference's plan, lane slot for lane slot: the port's fused
    engine (K4-gen-mq, K3, plain versions) against the reference's (its
    Pallas kernels in interpret mode)."""
    s = ref_p2
    ej, ef = s["ej"], s["ef"]
    n = s["Vj"].n_dofs
    rng = np.random.default_rng(43)
    u, v = 1e-3 * rng.standard_normal(n), rng.standard_normal(n)
    uj, vj = jnp.asarray(ej.to_lane(u)), jnp.asarray(ej.to_lane(v))
    ul, vl = ef.to_lane(u), ef.to_lane(v)
    if what == "r":
        got, want = ef.residual(ul, s["ccf"]), ej.residual(uj, s["ccj"])
    else:
        got = ef.tangent_action(ul, s["ccf"], vl)
        want = ej.tangent_action(uj, s["ccj"], vj)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-12


def test_generic_path_still_raises():
    """Cell terms of two quadrature degrees take the generic path, which
    the fused kernel does not take: NotImplementedError naming K4's
    generated route (the reference runs it staged without a word)."""
    mesh = t_mesh.unit_square(3)
    V = t_spaces.FunctionSpace.create(mesh, 2, bs=2)
    F = t_form.EnergyFunctional(V, [
        t_form.Term(lambda qp: t_forms.linear_elastic_psi(qp.eps, E, NU), 2),
        t_form.Term(lambda qp: -qp.u[0], 1)], **F64)
    with pytest.raises(NotImplementedError, match="generic element path"):
        TLaneEngine(F, [], wg_own=8, fused=True, **F64)


# -- 5. solves --------------------------------------------------------------------


SOLVER = dict(cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=3000,
              newton_maxit=20, preconditioner="jacobi")
MIXED = dict(cg_rtol=1e-8, newton_rtol=1e-10, cg_maxit=4000, newton_maxit=30)


def _damage_p2(pkg):
    """The damage law on P2 triangles, unit_square(4): a damaged band,
    the left edge clamped, the right one pulled."""
    mesh_m, sp, bc, forms, form, _, _, kw = _pkg(pkg)
    mesh = mesh_m.unit_square(4)
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
def damage():
    Fj, bj, Vj, d = _damage_p2("jax")
    Ft, bt, _, _ = _damage_p2("torch")
    ej = JLaneEngine(Fj, bj, wg_own=8, interpret=True)
    plan = lane_plan_from_numpy(lane_plan_fields(ej.plan))
    ef = TLaneEngine(Ft, bt, plan=plan, fused=True, **F64)
    uf, sf = ef.make_solver(TSolverConfig(**SOLVER), cg_chunk=50)(
        torch.zeros_like(ef.bc_lane), ef.prepare_coeffs({"d": d}))
    assert sf["converged"]
    return dict(ej=ej, ef=ef, d=d, u=ef.from_lane(uf), st=sf)


def test_fused_jacobi_solve_matches_reference_solve(damage):
    """The fused engine's Jacobi solve against the reference's on the same
    plan: the same Newton count, CG within 1 a step, u rel <= 1e-9."""
    ej, d = damage["ej"], damage["d"]
    uj, sj = ej.make_solver(JSolverConfig(**SOLVER), cg_chunk=200)(
        jnp.zeros_like(ej.bc_lane), ej.prepare_coeffs({"d": d}))
    st = damage["st"]
    assert sj["converged"]
    assert st["newton_iters"] == sj["newton_iters"] > 1
    assert len(st["cg_iters"]) == len(sj["cg_iters"])
    assert all(abs(a - b) <= 1
               for a, b in zip(st["cg_iters"], sj["cg_iters"]))
    assert _rel(damage["u"], ej.from_lane(uj)) <= 1e-9


def test_fused_twolevel_and_mixed_solves_reach_the_jacobi_root(damage):
    """tests/test_torch_multiqp.py:258 on the fused engine: the two-level
    solver and the mixed one (float64 Newton, float32 fused Jacobi CG)
    take a fused multi-qp engine unchanged and land on the fused Jacobi
    solve's root (which the test above holds against the reference's),
    u rel <= 1e-9; the two-level solve in under a third of the Jacobi
    solve's CG iterations."""
    ef, d = damage["ef"], damage["d"]
    cfg = TSolverConfig(**dict(SOLVER, preconditioner="twolevel"))
    u, st = ef.make_solver(cfg, cg_chunk=20, fine_coeffs={"d": d})(
        torch.zeros_like(ef.bc_lane), ef.prepare_coeffs({"d": d}))
    assert st["converged"] and _rel(ef.from_lane(u), damage["u"]) <= 1e-9
    assert sum(st["cg_iters"]) < sum(damage["st"]["cg_iters"]) / 3
    e32 = TLaneEngine(ef.functional, ef.bcs, plan=ef.plan, fused=True,
                      device="cpu", dtype=torch.float32)
    assert e32.fused_gen(torch.float32).MULTIQP
    u, st = e32.make_mixed_solver(TSolverConfig(**MIXED), cg_chunk=200)(
        torch.zeros(ef.space.n_dofs, dtype=torch.float64), {"d": d},
        e32.prepare_coeffs({"d": d}))
    assert st["converged"] and _rel(u.numpy(), damage["u"]) <= 1e-9


# -- 6. the launch geometry --------------------------------------------------------


def test_fused_gen_mq_geometry_at_the_q2_hex_shapes():
    """benchmarks/q2hex_bench.py's box(40) plan (wr 176, 27 vertices, three
    components, no coefficient), float32: the gradient stages the window
    (16 lane columns x 4 cells, two blocks to an SM); the Hessian-vector
    product reads both windows from global memory, 32 columns x 4 cells,
    one block to an SM."""
    g1 = tk.fused_gen_mq_geometry(1, 176, 27, 3, 0, 4)
    assert (g1["lb"], g1["ky"], g1["win"]) == (16, 4, True)
    assert g1["smem"] == 112512 == tk.gen_mq_layout_bytes(
        16, 4, 1, True, 176, 27, 3, 0, 4)
    assert 2 * (g1["smem"] + tk.SMEM_RESERVED) <= tk.SMEM_PER_SM
    g2 = tk.fused_gen_mq_geometry(2, 176, 27, 3, 0, 4)
    assert (g2["lb"], g2["ky"], g2["win"], g2["threads"]) == (32, 4, False,
                                                               128)
    pad = tk._pad16
    assert g2["smem"] == (pad(3 * 176 * 32 * 4) + pad(2 * 81 * 128 * 4)
                          + pad(81 * 128 * 4) + pad(27 * 128 * 2)) == 198912
    assert g2["smem"] <= tk.SMEM_PER_BLOCK


@pytest.mark.parametrize("vb", [4, 8])
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("wr,nv,C,dc", [(40, 6, 2, 3), (96, 6, 2, 3),
                                        (176, 27, 3, 0), (60, 10, 3, 4),
                                        (300, 8, 3, 8)])
def test_fused_gen_mq_geometry_takes_the_first_layout_that_fits(vb, ns, wr,
                                                                nv, C, dc):
    g = tk.fused_gen_mq_geometry(ns, wr, nv, C, dc, vb)
    fits = []
    for lb, ky, win in tk.GEN_MQ_CONFIGS:
        smem = tk.gen_mq_layout_bytes(lb, ky, ns, win, wr, nv, C, dc, vb)
        room = (tk.SMEM_PER_SM // 2 - tk.SMEM_RESERVED if win
                else tk.SMEM_PER_BLOCK)
        if smem <= room:
            fits.append((lb, ky, win, smem))
    assert fits and (g["lb"], g["ky"], g["win"], g["smem"]) == fits[0]
    assert g["grid_y"] * g["lb"] == 128 and g["threads"] == g["lb"] * g["ky"]


def test_fused_gen_mq_geometry_raises():
    with pytest.raises(ValueError, match="wr"):
        tk.fused_gen_mq_geometry(1, 0, 27, 3, 0, 4)
    with pytest.raises(ValueError, match="states"):
        tk.fused_gen_mq_geometry(3, 40, 6, 2, 3, 4)
    with pytest.raises(ValueError, match="does not fit"):
        tk.fused_gen_mq_geometry(2, 4000, 27, 3, 0, 8)
    # the wrapper's routes: a P1 physics is refused by the multi-point one
    ph = fg.GenPhysics(lambda qp: qp.u * qp.u, bs=1, gd=2, nv=3,
                       coeff_meta=(), dtype=torch.float64)
    with pytest.raises(TypeError, match="multi-point"):
        tk.lane_fused_gen_mq((torch.zeros(1, 1, 128),), None, None, (),
                             ph, wr=1, nv=3)


def test_generated_unit_source_names_its_template():
    """The CUDA unit of a multi-point physics includes the multi-point
    template and instantiates its two entry points with the layouts of
    ``fused_gen_mq_geometry``; its tables are constant memory."""
    c = _emit_case("p2_coeff")
    ph = fg.GenPhysicsMQ(c["psi"], bs=2, gd=2, nv=6, coeff_meta=c["meta"],
                         dtype=torch.float32, Nf=c["Nf"], Nc=c["Nc"])
    src = tk.fused_gen_source(ph, torch.int8, 96)
    assert '#include "lane_fused_gen_mq.cuh"' in src
    geos = [tk.fused_gen_mq_geometry(ns, 96, 6, 2, 3, 4) for ns in (1, 2)]
    for ns, g in zip((1, 2), geos):
        assert (f"LANE_FUSED_GEN_MQ_ENTRY(GenPhys, int8_t, {ns}, {g['lb']}, "
                f"{g['ky']}, {str(g['win']).lower()})") in src
    assert "GEN_TABLE float GenPhys_nf[18]" in src
    assert os.path.exists(os.path.join(_build.CSRC_DIR,
                                       "lane_fused_gen_mq.cuh"))
