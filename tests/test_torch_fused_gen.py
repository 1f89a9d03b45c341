"""The fused kernel's generated route (K4-gen: ``lane/fused_gen.py``,
``lane_fused_gen``) against tpufem (CPU, float64, the same numpy inputs
through both).

The reference traces the AD graph of any elementwise integrand into its
Pallas kernel (``tpufem/lane/engine.py:1109-1245``); the port traces the
graphs ahead of time, runs them as ``GraphModule``s in the plain version
and emits them as C for the card. Here:

1. the emitter: the C of each graph, compiled by ``g++ -O2
   -ffp-contract=off`` into a throwaway host library, held against the
   graph node by node (every node's C value against PyTorch's operation on
   the C operands: equal, and within 4 ulp for sqrt, log and pow with a
   general exponent -- PyTorch's CPU sqrt is not correctly rounded: 0.7 %
   of float64 values differ by an ulp on an AVX-512 host) and whole (equal
   for graphs with none of those);
2. ``lane_fused_gen_plain`` against the reference's Pallas
   ``lane_fused_elem`` in interpret mode with the reference's own
   ``_elem_grad_block`` / ``_elem_jvp_block``, rel <= 1e-12;
3. ``fused_geom`` exactly the reference's, quadrature-point rows included;
4. engines: fused (generated) against staged, the flat ``Assembler`` and
   the reference's fused engine, residual and tangent rel <= 1e-12;
5. a fused (generated) solve against the reference's fused solve: the
   same Newton count, CG +-1 a step, u rel <= 1e-9;
6. ``fused_gen_geometry``: block layouts and raises.

Every mesh is unit_square(4) or box(2) with ``wg_own`` 8: the reference's
interpret-mode kernels compile in seconds there."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.fx as fx

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
from tpufem.config import SolverConfig as JSolverConfig
from tpufem.lane import LaneEngine as JLaneEngine
from tpufem.lane import kernels as jk
from tpufem_torch.assemble import Assembler as TAssembler
from tpufem_torch.config import SolverConfig as TSolverConfig
from tpufem_torch.lane import LaneEngine as TLaneEngine
from tpufem_torch.lane import fused_gen as fg
from tpufem_torch.lane import kernels as tk
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
        return j_mesh, j_spaces, j_bc, j_forms, j_form, {}
    return t_mesh, t_spaces, t_bc, t_forms, t_form, F64


# name: (2D triangles or 3D tetrahedra, components, integrand of the
# forms module, coefficient names (P1 scalars))
CASES = {
    # ADVICE.md item 1: an x-using single-term integrand
    "x_using": ("tri", 2, lambda f: lambda qp: f.linear_elastic_psi(
        qp.eps, E, NU) - 1e3 * qp.u[1] * qp.x[0], ()),
    # tests/test_lane.py:729
    "neo_hookean": ("tri", 2, lambda f: lambda qp: f.neo_hookean_psi(
        qp.grad_u, E, NU), ()),
    # tests/test_lane.py:293, no coefficients
    "elastic": ("tri", 2, lambda f: lambda qp: f.linear_elastic_psi(
        qp.eps, E, NU), ()),
    "tet_bs3": ("tet", 3, lambda f: lambda qp: f.linear_elastic_psi(
        qp.eps, E, NU), ()),
    "scalar": ("tri", 1, lambda f: lambda qp: 0.5 * qp.coeff("k") * (
        qp.grad_u[0, 0] * qp.grad_u[0, 0] + qp.grad_u[0, 1] * qp.grad_u[0, 1])
        - qp.u * qp.x[1], ("k",)),
}


def _problem(pkg, case):
    mesh_m, sp, bc, forms, form, kw = _pkg(pkg)
    kind, bs, integrand, cnames = CASES[case]
    mesh = (mesh_m.unit_square(4) if kind == "tri"
            else mesh_m.box(2, 2, 2, cell_type="tetra"))
    V = sp.FunctionSpace.create(mesh, 1, bs=bs)
    coeffs = [form.Coefficient(n, sp.FunctionSpace.create(mesh, 1))
              for n in cnames]
    F = form.EnergyFunctional(V, [form.Term(integrand(forms), 1)], coeffs,
                              **kw)
    left = bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = bc.locate_dofs_geometrical(
        V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    pull = [0.0] * bs
    pull[0] = 0.01
    bcs = [sp.DirichletBC(V, left, [0.0] * bs),
           sp.DirichletBC(V, right, pull)]
    return F, bcs, V


def _coeffs(case, V):
    rng = np.random.default_rng(17)
    return {n: rng.uniform(0.5, 2.0, V.mesh.n_nodes) for n in CASES[case][3]}


@pytest.fixture(scope="module")
def ref():
    """Per case: the reference's fused engine (interpret mode) and the
    port's fused engine on its plan, random lane states, and the
    reference kernel's results in both modes (int32 indices)."""
    out = {}
    rng = np.random.default_rng(23)
    for case in CASES:
        Fj, bj, Vj = _problem("jax", case)
        Ft, bt, Vt = _problem("torch", case)
        coeffs = _coeffs(case, Vj)
        ej = JLaneEngine(Fj, bj, wg_own=8, interpret=True, fused=True)
        assert ej._fused  # the reference did not fall back
        plan = lane_plan_from_numpy(lane_plan_fields(ej.plan))
        ef = TLaneEngine(Ft, bt, plan=plan, fused=True, **F64)
        ccj, ccf = ej.prepare_coeffs(coeffs), ef.prepare_coeffs(coeffs)
        p = ej.plan
        bs = Vt.bs
        u = 1e-3 * rng.standard_normal((bs, p.R, 128))
        v = rng.standard_normal((bs, p.R, 128))
        idx = jnp.asarray(np.asarray(p.gather_idx).astype(np.int32))
        cds_j = ej._fused_cds(ccj, jnp.float64)
        kern = {}
        for mode, states, fn in (("grad", (u,), ej._elem_grad_block),
                                 ("jvp", (u, v), ej._elem_jvp_block)):
            kern[mode] = np.asarray(jk.lane_fused_elem(
                tuple(jnp.asarray(s) for s in states), ej.gather_starts, idx,
                cds_j, fn, wr=p.wg, nv=p.nv, k_block=ej._fused_kb,
                interpret=True))
        out[case] = dict(ej=ej, ef=ef, ccj=ccj, ccf=ccf, coeffs=coeffs,
                         u=u, v=v, kern=kern, Ft=Ft, bt=bt, Vt=Vt, Fj=Fj,
                         bj=bj)
    return out


# -- 1. the emitter: C against the graph ------------------------------------------


def _host_lib(tmp_path, name, source):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")  # the tests' hosts have one
    src = tmp_path / f"{name}.cpp"
    src.write_text(source)
    so = tmp_path / f"{name}.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def _host_unit(ph):
    """The physics' C (host spelling) with two batched entry points over
    cells-minor arrays: ``gen_grad_batch(in (NIN, n), n, out (NR, n))``
    and ``gen_jvp_batch(in, din (NR, n), n, out)``."""
    return f"""#include <cmath>
#define GEN_HD inline
{ph.c_struct("host")}
typedef GenPhys::GT GT;
extern "C" void gen_grad_batch(const GT* in, long n, GT* out) {{
  for (long m = 0; m < n; ++m) {{
    GT a[GenPhys::NIN], g[GenPhys::NR];
    for (int i = 0; i < GenPhys::NIN; ++i) a[i] = in[i * n + m];
    GenPhys::grad(a, g);
    for (int i = 0; i < GenPhys::NR; ++i) out[i * n + m] = g[i];
  }}
}}
extern "C" void gen_jvp_batch(const GT* in, const GT* din, long n,
                              GT* out) {{
  for (long m = 0; m < n; ++m) {{
    GT a[GenPhys::NIN], da[GenPhys::NR], g[GenPhys::NR];
    for (int i = 0; i < GenPhys::NIN; ++i) a[i] = in[i * n + m];
    for (int i = 0; i < GenPhys::NR; ++i) da[i] = din[i * n + m];
    GenPhys::jvp(a, da, g);
    for (int i = 0; i < GenPhys::NR; ++i) out[i * n + m] = g[i];
  }}
}}
"""


def _op_table_psi(qp):
    """Every operation of the emitter's table: pow at 2, 3, -2, 0.5,
    -0.5, -1 and a general exponent, reciprocal, division by a number,
    log, clamp, where, comparisons, rsub."""
    g = qp.grad_u
    s = qp.u * qp.u
    return ((g[0, 0] ** 3 + (g[0, 1] * g[0, 1] + 1.0) ** -2
             + (s + 1.0) ** 0.5 + (s + 2.0) ** -0.5 + 1.0 / (qp.u + 3.0)
             + (s + 1.0) ** 1.5 + torch.log(s + 2.0) + (s + 1.0) ** -1) / 3.0
            + torch.clamp(g[0, 0], min=0.0) ** 2 + (1.0 - s) * qp.x[1]
            + torch.where(g[0, 1] > 0.1, g[0, 1] * qp.x[0], -g[0, 1]) / 0.52)


EMIT_CASES = {
    "polycrystal_loaded": (lambda qp: t_forms.asym_damage_psi(
        qp.eps, qp.coeff("d"), qp.coeff("E"), NU) - (
        1600.0 * (qp.x[1] - 0.5) ** 2 - 500.0) * (
        -1e5 * (qp.x[0] - 0.5) ** 3) * qp.u[0], 2, 2, 3,
        (("d", 3, 1), ("E", 1, 1))),
    "neo_hookean_3d": (lambda qp: t_forms.neo_hookean_psi(qp.grad_u, E, NU),
                       3, 3, 4, ()),
    "op_table": (_op_table_psi, 1, 2, 3, ()),
    "x_using": (CASES["x_using"][2](t_forms), 2, 2, 3, ()),
}
# operations PyTorch's CPU kernels round differently from the C library
_LIBM = {"aten.sqrt.default", "aten.log.default"}


def _ulp(a, b):
    return np.max(np.abs(a - b) / np.spacing(np.maximum(np.abs(a),
                                                        np.abs(b))))


@pytest.mark.parametrize("case", sorted(EMIT_CASES))
def test_emitted_c_matches_the_graph(tmp_path, case):
    integrand, bs, gd, nv, meta = EMIT_CASES[case]
    ph = fg.GenPhysics(integrand, bs=bs, gd=gd, nv=nv, coeff_meta=meta,
                       dtype=torch.float64)
    n = 2048
    rng = np.random.default_rng(29)
    X = rng.uniform(0.05, 1.0, (ph.n_in + ph.nR, n))
    X[ph.n_in:] = rng.standard_normal((ph.nR, n))
    uses_libm = False
    for which, gm, nin in (("grad", ph.grad_gm, ph.n_in),
                           ("jvp", ph.jvp_gm, ph.n_in + ph.nR)):
        lines = fg.emit(gm, [f"in[{i}]" for i in range(nin)], "out",
                        torch.float64, "host")
        body, k = [], 0
        for ln in lines:
            body.append(ln)
            if ln.startswith("const "):
                body.append(f"dump[{k}L * n + m] = (double)"
                            f"({ln.split()[2]});")
                k += 1
        lib = _host_lib(tmp_path, f"{case}_{which}", (
            "#include <cmath>\ntypedef double GT;\n"
            "extern \"C\" void f(const double* X, long n, double* dump) {\n"
            " for (long m = 0; m < n; ++m) {\n"
            f"  double in[{nin}], out[{ph.nR}];\n"
            f"  for (int i = 0; i < {nin}; ++i) in[i] = X[i * n + m];\n"
            + "\n".join("  " + b for b in body) + "\n  (void)out;\n }\n}\n"))
        dump = np.zeros((k, n))
        Xc = np.ascontiguousarray(X[:nin])
        lib.f.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        lib.f(Xc.ctypes.data, n, dump.ctypes.data)
        # node by node: PyTorch's operation on the C operands
        val, j, libm = {}, 0, False
        ph_nodes = [nd for nd in gm.graph.nodes if nd.op == "placeholder"]
        for i, nd in enumerate(ph_nodes):
            val[nd] = torch.from_numpy(Xc[i])
        for nd in gm.graph.nodes:
            if nd.op != "call_function":
                continue
            args = [val[a] if isinstance(a, fx.Node) else a for a in nd.args]
            raw = nd.target(*args, **nd.kwargs)
            want = raw.to(torch.float64).expand(n)
            got = dump[j]
            tgt = str(nd.target)
            general_pow = (tgt == "aten.pow.Tensor_Scalar"
                           and float(nd.args[1]) not in
                           (0.0, 1.0, 2.0, 3.0, -1.0, -2.0, 0.5, -0.5))
            if tgt in _LIBM or general_pow or (
                    tgt == "aten.pow.Tensor_Scalar"
                    and float(nd.args[1]) in (0.5, -0.5)):
                libm = True
                assert _ulp(got, want.numpy()) <= 4, (which, nd.name, tgt)
            else:
                assert np.array_equal(got, want.numpy()), (which, nd.name,
                                                           tgt)
            # carry on from the C value: each node is held alone
            val[nd] = torch.from_numpy(got.copy()).to(raw.dtype)
            j += 1
        assert j == k
        uses_libm |= libm
    if not uses_libm:  # the whole unit, equal
        hlib = _host_lib(tmp_path, f"{case}_whole", _host_unit(ph))
        vp, cl = ctypes.c_void_p, ctypes.c_long
        hlib.gen_grad_batch.argtypes = [vp, cl, vp]
        hlib.gen_jvp_batch.argtypes = [vp, vp, cl, vp]
        a0 = np.ascontiguousarray(X[:ph.n_in])
        din = np.ascontiguousarray(X[ph.n_in:])
        g, jv = np.zeros((ph.nR, n)), np.zeros((ph.nR, n))
        hlib.gen_grad_batch(a0.ctypes.data, n, g.ctypes.data)
        hlib.gen_jvp_batch(a0.ctypes.data, din.ctypes.data, n, jv.ctypes.data)
        xs = [torch.from_numpy(X[i]) for i in range(ph.n_in + ph.nR)]
        want_g = torch.stack([o.expand(n) for o in ph.grad_gm(*xs[:ph.n_in])])
        want_j = torch.stack([o.expand(n) for o in ph.jvp_gm(*xs)])
        assert np.array_equal(g, want_g.numpy())
        assert np.array_equal(jv, want_j.numpy())
    assert (ph.x_rows, ph.dg) == {
        "polycrystal_loaded": (True, 9), "neo_hookean_3d": (False, 13),
        "op_table": (True, 9), "x_using": (True, 9)}[case]


def test_emitter_refuses_what_it_has_no_c_for():
    """An operation outside the table raises, naming it and the ROADMAP
    item; so does a float64 value in a float32 graph."""
    with pytest.raises(NotImplementedError, match="aten.exp.*ROADMAP"):
        fg.GenPhysics(lambda qp: torch.exp(qp.u), bs=1, gd=2, nv=3,
                      coeff_meta=(), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="float64.*ROADMAP"):
        fg.GenPhysics(lambda qp: qp.u.to(torch.float64) * qp.u, bs=1, gd=2,
                      nv=3, coeff_meta=(), dtype=torch.float32)


def test_cuda_reciprocal_is_the_float64_one_rounded():
    """A division by a number on the card is a product with the
    reciprocal taken in float64 and rounded to the working type (H100,
    torch 2.11: ``t / 0.52`` in float32); the CUDA emitter spells that and
    the host emitter the division."""
    ph = fg.GenPhysics(lambda qp: qp.u * qp.u / 0.52, bs=1, gd=2, nv=3,
                       coeff_meta=(), dtype=torch.float32)
    cuda = "\n".join(fg.emit(ph.grad_gm, [f"in[{i}]" for i in range(ph.n_in)],
                             "out", torch.float32, "cuda"))
    host = "\n".join(fg.emit(ph.grad_gm, [f"in[{i}]" for i in range(ph.n_in)],
                             "out", torch.float32, "host"))
    rcp = float(np.float32(1.0 / 0.52))
    assert rcp != float(np.float32(1.0) / np.float32(0.52))
    assert f"* ({rcp.hex()}f)" in cuda and "/ (" in host


# -- 2. the plain version against the Pallas original -------------------------------


@pytest.mark.parametrize("mode", ["grad", "jvp"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_gen_plain_matches_pallas(ref, case, mode):
    s = ref[case]
    ef = s["ef"]
    p = ef.plan
    states = (s["u"],) if mode == "grad" else (s["u"], s["v"])
    got = tk.lane_fused_gen(
        tuple(torch.from_numpy(x) for x in states), ef.gather_starts,
        ef.gather_idx.to(torch.int32), ef._fused_cds(s["ccf"], torch.float64),
        ef.fused_gen(torch.float64), wr=p.wg, nv=p.nv)
    want = s["kern"][mode]
    assert got.shape == want.shape == (p.G, ef.bs, p.wg, 128)
    assert got.permute(1, 0, 2, 3).is_contiguous()
    assert _rel(got.numpy(), want) <= 1e-12
    assert tk.lane_fused_gen.launches == 0  # CPU tensors: no kernel launch


# -- 3. the cell data ------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_geom_equals_reference(ref, case):
    """dN rows v*gd+d, the weight, then the gd quadrature-point rows where
    the integrand reads x: the reference's layout, value for value."""
    s = ref[case]
    ef, ej = s["ef"], s["ej"]
    assert np.array_equal(ef.fused_geom.numpy(), np.asarray(ej.fused_geom))
    gd = ef.space.mesh.gdim
    x_rows = case in ("x_using", "scalar")
    assert ef.fused_geom.shape[1] == ef.plan.nv * gd + 1 + gd * x_rows
    assert (not ej._fused_no_xq) == x_rows
    if CASES[case][3]:
        assert np.array_equal(s["ccf"]["_cd"].numpy(),
                              np.asarray(s["ccj"]["_cd"]))
    # the hand-written law takes the 2D elastic case; the generated
    # physics every other
    assert (ef.fused_law is not None) == (case == "elastic")


def test_x_read_only_by_len_is_not_streamed():
    """An integrand that reads only len(qp.x): its graph has no x input
    with a user, so no x rows and the generated kernel runs; the
    reference's poison probe calls it x-free, its block trace then fails
    on x = None and it quietly runs staged (ADVICE.md item 2; ROADMAP
    "Recorded differences")."""
    def integrand(pkg):
        forms = _pkg(pkg)[3]
        return lambda qp: forms.neo_hookean_psi(qp.grad_u, E, NU) * (
            len(qp.x) - 1)

    Vt = t_spaces.FunctionSpace.create(t_mesh.unit_square(4), 1, bs=2)
    Ft = t_form.EnergyFunctional(Vt, [t_form.Term(integrand("torch"), 1)],
                                 **F64)
    Vj = j_spaces.FunctionSpace.create(j_mesh.unit_square(4), 1, bs=2)
    Fj = j_form.EnergyFunctional(Vj, [j_form.Term(integrand("jax"), 1)])
    ej = JLaneEngine(Fj, [], wg_own=8, interpret=True, fused=True)
    assert not ej._fused and ej.fused_geom is None
    ef = TLaneEngine(Ft, [], wg_own=8, fused=True, **F64)
    es = TLaneEngine(Ft, [], plan=ef.plan, **F64)
    assert ef.fused_law is None and not ef.fused_gen(torch.float64).x_rows
    assert ef.fused_geom.shape[1] == 7
    u = ef.to_lane(np.random.default_rng(3).standard_normal(Vt.n_dofs))
    assert _rel(ef.residual(u, {}), es.residual(u, {})) <= 1e-12


# -- 4. engines: fused (generated) == staged == flat == the reference's fused ------


@pytest.fixture(scope="module")
def assembled(ref):
    out = {}
    rng = np.random.default_rng(31)
    for case in ("x_using", "tet_bs3", "scalar"):
        s = ref[case]
        ef, ej = s["ef"], s["ej"]
        es = TLaneEngine(s["Ft"], s["bt"], plan=ef.plan, **F64)
        ccs = es.prepare_coeffs(s["coeffs"])
        n = s["Vt"].n_dofs
        u, v = 1e-2 * rng.standard_normal(n), rng.standard_normal(n)
        asm = TAssembler(s["Ft"], s["bt"])
        ct = {k: to_torch(c, **F64) for k, c in s["coeffs"].items()}
        ut, vt = to_torch(u, **F64), to_torch(v, **F64)
        ul, vl = ef.to_lane(u), ef.to_lane(v)
        ulj, vlj = jnp.asarray(ej.to_lane(u)), jnp.asarray(ej.to_lane(v))
        out[case] = dict(
            eng=ef,
            r=(ef.residual(ul, s["ccf"]), es.residual(ul, ccs),
               asm.residual(ut, ct).numpy(),
               ej.from_lane(ej.residual(ulj, s["ccj"]))),
            jv=(ef.tangent_action(ul, s["ccf"], vl),
                es.tangent_action(ul, ccs, vl),
                asm.tangent_action(ut, ct, vt).numpy(),
                ej.from_lane(ej.tangent_action(ulj, s["ccj"], vlj))))
    return out


@pytest.mark.parametrize("what", ["r", "jv"])
@pytest.mark.parametrize("case", ["x_using", "tet_bs3", "scalar"])
def test_fused_gen_engine_parity(assembled, case, what):
    a = assembled[case]
    eng = a["eng"]
    fused, staged, flat, reference = a[what]
    assert eng.fused_law is None
    got = eng.from_lane(fused)
    assert _rel(got, eng.from_lane(staged)) <= 1e-12
    assert _rel(got, flat) <= 1e-12
    assert _rel(got, np.asarray(reference)) <= 1e-12


# -- 5. the solve against the reference's fused solve -------------------------------


SOLVER = dict(cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=3000,
              newton_maxit=20, preconditioner="jacobi")


def test_fused_gen_solve_matches_reference_fused_solve(ref):
    """The x-using integrand (a load that reads x) solved by both fused
    engines: the same Newton count, CG within 1 a step, u rel <= 1e-9."""
    s = ref["x_using"]
    ej, ef = s["ej"], s["ef"]
    uj, sj = ej.make_solver(JSolverConfig(**SOLVER), cg_chunk=50)(
        jnp.zeros_like(ej.bc_lane), s["ccj"])
    ut, st = ef.make_solver(TSolverConfig(**SOLVER), cg_chunk=50)(
        torch.zeros_like(ef.bc_lane), s["ccf"])
    assert sj["converged"] and st["converged"]
    assert st["newton_iters"] == int(sj["newton_iters"])
    assert all(abs(a - int(b)) <= 1
               for a, b in zip(st["cg_iters"], sj["cg_iters"]))
    assert _rel(ef.from_lane(ut), ej.from_lane(uj)) <= 1e-9


# -- 6. the launch geometry ------------------------------------------------------------


def test_fused_gen_geometry_at_the_path_shapes():
    """The loaded polycrystal at n = 1024 (wr 40, 9 geometry and 4
    coefficient rows), float32, int8: windows staged, 32 lane columns x 4
    cells; the 3D bar's window (float32, int32, three components, wr 272):
    read from global memory, where one block of 32 columns fits."""
    for ns in (1, 2):
        g = tk.fused_gen_geometry(ns, 40, 3, 2, 13, 4, 1)
        assert g["lb"] == 32 and g["win"] and g["threads"] == 128
        assert g["smem"] == tk.gen_layout_bytes(32, 4, 3, ns, True, 40, 3, 2,
                                                13, 4, 1)
        assert 2 * (g["smem"] + tk.SMEM_RESERVED) <= tk.SMEM_PER_SM
    g = tk.fused_gen_geometry(2, 272, 4, 3, 13, 4, 4)
    assert (g["lb"], g["win"]) == (32, False)
    assert g["smem"] <= tk.SMEM_PER_BLOCK
    assert g["smem"] == (tk._pad16(3 * 272 * 32 * 4)
                         + tk._pad16(3 * 13 * 4 * 32 * 4)
                         + tk._pad16(3 * 4 * 4 * 32 * 4)
                         + tk._pad16(2 * 4 * 4 * 3 * 32 * 4)
                         + tk._pad16(2 * 4 * 4 * 32 * 2))


@pytest.mark.parametrize("vb,ib", [(4, 1), (4, 4), (8, 1), (8, 4)])
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("wr,nv,C", [(9, 3, 1), (40, 3, 2), (126, 4, 3),
                                     (300, 4, 3)])
def test_fused_gen_geometry_takes_the_first_layout_that_fits(vb, ib, ns, wr,
                                                             nv, C):
    nval = nv * (nv - 1) + 1
    g = tk.fused_gen_geometry(ns, wr, nv, C, nval, vb, ib)
    fits = []
    for lb, ky, stages, win in tk.GEN_CONFIGS:
        smem = tk.gen_layout_bytes(lb, ky, stages, ns, win, wr, nv, C, nval,
                                   vb, ib)
        room = (tk.SMEM_PER_SM // 2 - tk.SMEM_RESERVED if win
                else tk.SMEM_PER_BLOCK)
        if smem <= room:
            fits.append((lb, ky, stages, win, smem))
    assert fits and (g["lb"], g["ky"], g["stages"], g["win"],
                     g["smem"]) == fits[0]
    assert g["grid_y"] * g["lb"] == 128


def test_fused_gen_geometry_raises():
    with pytest.raises(ValueError, match="wr"):
        tk.fused_gen_geometry(1, 0, 3, 2, 7, 4, 1)
    with pytest.raises(ValueError, match="states"):
        tk.fused_gen_geometry(3, 40, 3, 2, 7, 4, 1)
    with pytest.raises(ValueError, match="does not fit"):
        tk.fused_gen_geometry(2, 4000, 4, 3, 13, 8, 4)
