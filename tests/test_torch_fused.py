"""The fused element kernel and LaneEngine(fused=True) of tpufem_torch
against tpufem (CPU, float64, same numpy inputs through both).

The JAX side runs ``tpufem.lane.kernels.lane_fused_elem`` in Pallas
interpret mode with the JAX engine's own traced element functions
(``_elem_grad_block`` / ``_elem_jvp_block``: AD of the integrand); the
port's wrapper takes ``lane_fused_elem_plain`` because the tensors lie on
the CPU, with the physics written by hand -- so every comparison here is
hand-derived formulas against AD.

Tolerances: kernel results and assembled quantities rel <= 1e-12 (other
order of the sums, hand-derived against AD rounding); ``fused_geom`` and
``_cd`` exactly equal; solves: same Newton count, ``cg_iters`` +-1, ``u``
rel <= 1e-9.

One module-scoped fixture builds the meshes, the engines of both packages
and the interpret-mode results once."""

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
from tpufem.config import SolverConfig as JSolverConfig
from tpufem.lane import LaneEngine as JLaneEngine
from tpufem.lane import kernels as jk
from tpufem_torch.assemble import Assembler as TAssembler
from tpufem_torch.config import SolverConfig as TSolverConfig
from tpufem_torch.lane import LaneEngine as TLaneEngine
from tpufem_torch.lane import kernels as tk
from tpufem_torch.utils.convert import (fused_cell_data, set_fused_cell_data,
                                        to_torch)
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
N, WG_OWN = 12, 8
F64 = dict(device="cpu", dtype=torch.float64)
SOLVER = dict(cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=3000,
              newton_maxit=20, preconditioner="jacobi")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _problem(pkg, law, mesh=None):
    """Damage law with a P1 damage and a P0 modulus coefficient (the
    polycrystal's integrand), or coefficient-free linear elasticity."""
    if pkg == "jax":
        mesh_m, sp, bc, forms, form, kw = (j_mesh, j_spaces, j_bc, j_forms,
                                           j_form, {})
    else:
        mesh_m, sp, bc, forms, form, kw = (t_mesh, t_spaces, t_bc, t_forms,
                                           t_form, F64)
    mesh = mesh_m.unit_square(N) if mesh is None else mesh
    V = sp.FunctionSpace.create(mesh, 1, bs=2)
    if law == "damage":
        DS = sp.FunctionSpace.create(mesh, 1, bs=1)
        P0 = sp.FunctionSpace.create(mesh, 0, bs=1)
        t = form.Term(lambda qp: forms.asym_damage_psi(
            qp.eps, qp.coeff("d"), qp.coeff("E"), NU), 1)
        F = form.EnergyFunctional(
            V, [t], [form.Coefficient("d", DS), form.Coefficient("E", P0)],
            **kw)
    else:
        t = form.Term(lambda qp: forms.linear_elastic_psi(qp.eps, E, NU), 1)
        F = form.EnergyFunctional(V, [t], **kw)
    left = bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = bc.locate_dofs_geometrical(
        V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [sp.DirichletBC(V, left, [0.0, 0.0]),
           sp.DirichletBC(V, right, [0.01, 0.0])]
    return F, bcs, V


def _coeffs(law, V, mesh):
    if law != "damage":
        return {}
    rng = np.random.default_rng(11)
    x = V.dof_coords
    d = np.zeros(len(x))
    d[(x[:, 1] > 0.4) & (x[:, 1] < 0.6)] = 0.8
    d[(x[:, 1] > 0.47) & (x[:, 1] < 0.53) & (x[:, 0] < 0.3)] = 1.0
    return {"d": d, "E": E * rng.uniform(0.5, 2.0, mesh.n_cells)}


@pytest.fixture(scope="module")
def setup():
    """Per law: the engines of both packages on one mesh (JAX fused in
    interpret mode; port fused and staged), their prepared coefficients,
    random lane states, and the JAX kernel's results for both modes and
    both index types."""
    out = {}
    rng = np.random.default_rng(5)
    for law in ("damage", "elastic"):
        Fj, bj, Vj = _problem("jax", law)
        Ft, bt, Vt = _problem("torch", law)
        coeffs = _coeffs(law, Vj, Vj.mesh)
        ej = JLaneEngine(Fj, bj, wg_own=WG_OWN, interpret=True, fused=True)
        assert ej._fused  # the reference did not fall back
        ef = TLaneEngine(Ft, bt, wg_own=WG_OWN, fused=True, **F64)
        es = TLaneEngine(Ft, bt, plan=ef.plan, **F64)
        ccj = ej.prepare_coeffs(coeffs)
        p = ej.plan
        u = 1e-3 * rng.standard_normal((2, p.R, 128))
        u[:, : p.wg] = 0.0  # one bin at exactly zero strain
        v = rng.standard_normal((2, p.R, 128))
        cds_j = ej._fused_cds(ccj, jnp.float64)
        ref = {}
        for idt in (np.int8, np.int32):
            idx = jnp.asarray(np.asarray(p.gather_idx).astype(idt))
            for mode, states, fn in (
                    ("grad", (u,), ej._elem_grad_block),
                    ("jvp", (u, v), ej._elem_jvp_block)):
                ref[(np.dtype(idt).name, mode)] = np.asarray(
                    jk.lane_fused_elem(
                        tuple(jnp.asarray(s) for s in states),
                        ej.gather_starts, idx, cds_j, fn, wr=p.wg, nv=p.nv,
                        k_block=ej._fused_kb, interpret=True))
        out[law] = dict(ej=ej, ef=ef, es=es, ccj=ccj, coeffs=coeffs,
                        ccf=ef.prepare_coeffs(coeffs),
                        ccs=es.prepare_coeffs(coeffs), u=u, v=v, ref=ref,
                        Ft=Ft, bt=bt, Vt=Vt)
    return out


# -- the kernel: plain version against the Pallas original -----------------------


@pytest.mark.parametrize("mode", ["grad", "jvp"])
@pytest.mark.parametrize("idt", ["int8", "int32"])
@pytest.mark.parametrize("law", ["damage", "elastic"])
def test_fused_elem_plain_matches_pallas(setup, law, idt, mode):
    """With (damage: geometry + `_cd`) and without (elastic: geometry
    only) coefficient rows, int8 and int32 indices, both modes."""
    s = setup[law]
    ef = s["ef"]
    p = ef.plan
    states = (s["u"],) if mode == "grad" else (s["u"], s["v"])
    cds = ef._fused_cds(s["ccf"], torch.float64)
    assert len(cds) == (2 if law == "damage" else 1)
    idx = ef.gather_idx.to(getattr(torch, idt))
    got = tk.lane_fused_elem(
        tuple(torch.from_numpy(x) for x in states), ef.gather_starts, idx,
        cds, ef.fused_law, wr=p.wg, nv=p.nv)
    ref = s["ref"][(idt, mode)]
    assert got.shape == ref.shape == (p.G, 2, p.wg, 128)
    assert got.permute(1, 0, 2, 3).is_contiguous()  # channel-leading storage
    assert torch.isfinite(got).all()
    assert _rel(got.numpy(), ref) <= 1e-12
    # the zero-strain bin contributes exact zeros in grad mode
    if mode == "grad":
        assert (got.numpy()[0] == 0).all()
    assert tk.lane_fused_elem.launches == 0  # CPU tensors: no kernel launch


@pytest.mark.parametrize("law", ["damage", "elastic"])
def test_fused_cell_data_equals_reference(setup, law):
    s = setup[law]
    mine = fused_cell_data(s["ef"], s["ccf"])
    theirs = fused_cell_data(s["ej"], s["ccj"])
    assert sorted(mine) == sorted(theirs) == (
        ["_cd", "fused_geom"] if law == "damage" else ["fused_geom"])
    for k in mine:
        assert mine[k].shape == theirs[k].shape
        assert np.array_equal(mine[k], theirs[k]), k
    # damage: 3 rows of P1 d, then 1 row of P0 E; geometry: 6 dN rows + w
    assert mine["fused_geom"].shape[1] == 7
    if law == "damage":
        assert mine["_cd"].shape[1] == 4
        assert s["ef"].fused_law == tk.FusedLaw(
            "asym_damage", NU, E=(3, 1), d=(0, 3))
    else:
        assert s["ef"].fused_law == tk.FusedLaw("linear_elastic", NU, E=E)


def test_reference_cell_data_set_on_port_engine(setup):
    """The reference engine's cell data, carried over as numpy, drives
    the port's fused engine to the same residual."""
    s = setup["damage"]
    Ft, bt = s["Ft"], s["bt"]
    eng = TLaneEngine(Ft, bt, plan=s["ef"].plan, fused=True, **F64)
    cc = set_fused_cell_data(eng, eng.prepare_coeffs(s["coeffs"]),
                             fused_cell_data(s["ej"], s["ccj"]))
    ul = torch.from_numpy(s["u"])
    assert torch.equal(eng.residual(ul, cc), s["ef"].residual(ul, s["ccf"]))
    with pytest.raises(ValueError, match="fused_geom"):
        set_fused_cell_data(eng, cc, {"fused_geom": np.zeros((1, 6, 8, 128))})


# -- the engine: fused == staged == flat assembler ---------------------------------


def _rare_tail_engines():
    """The jittered polycrystal mesh of test_torch_engine.py's rare-copy
    tail test, with per-grain moduli and linear elasticity."""
    import tpufem_torch.cases.polycrystal as t_poly

    mesh = t_poly.generate_polycrystal(48, n_grains=12)
    V = t_spaces.FunctionSpace.create(mesh, 1, bs=2)
    P0 = t_spaces.FunctionSpace.create(mesh, 0, bs=1)
    t = t_form.Term(lambda qp: t_forms.linear_elastic_psi(
        qp.eps, qp.coeff("E"), NU), 1)
    F = t_form.EnergyFunctional(V, [t], [t_form.Coefficient("E", P0)], **F64)
    coeffs = {"E": E * (1.0 + np.asarray(mesh.cell_tags) % 5)}
    ef = TLaneEngine(F, [], wg_own=16, fused=True, **F64)
    assert ef._tail_copy is not None and len(ef._tail_copy) > 0
    assert ef.fused_law == tk.FusedLaw("linear_elastic", NU, E=(0, 1))
    return dict(ef=ef, es=TLaneEngine(F, [], plan=ef.plan, **F64), Ft=F,
                bt=[], Vt=V, coeffs=coeffs,
                ccf=ef.prepare_coeffs(coeffs))


@pytest.fixture(scope="module")
def assembled(setup):
    """Residual and tangent action of the fused engine, the staged engine
    and the flat assembler on the damage mesh and on the rare-tail mesh."""
    out = {}
    rng = np.random.default_rng(9)
    for name, s in (("damage", setup["damage"]),
                    ("rare_tail", _rare_tail_engines())):
        ef, es = s["ef"], s["es"]
        ccs = s.get("ccs") or es.prepare_coeffs(s["coeffs"])
        n = s["Vt"].n_dofs
        u, v = 1e-3 * rng.standard_normal(n), rng.standard_normal(n)
        asm = TAssembler(s["Ft"], s["bt"])
        ct = {k: to_torch(c, **F64) for k, c in s["coeffs"].items()}
        ut, vt = to_torch(u, **F64), to_torch(v, **F64)
        ul, vl = ef.to_lane(u), ef.to_lane(v)
        out[name] = dict(
            eng=ef,
            r=(ef.residual(ul, s["ccf"]), es.residual(ul, ccs),
               asm.residual(ut, ct)),
            jv=(ef.tangent_action(ul, s["ccf"], vl),
                es.tangent_action(ul, ccs, vl),
                asm.tangent_action(ut, ct, vt)),
            jv_closure=(ef.make_tangent(ul, s["ccf"])(vl),
                        es.make_tangent(ul, ccs)(vl),
                        asm.tangent_action(ut, ct, vt)),
        )
    return out


@pytest.mark.parametrize("what", ["r", "jv", "jv_closure"])
@pytest.mark.parametrize("mesh", ["damage", "rare_tail"])
def test_fused_equals_staged_equals_flat(assembled, mesh, what):
    a = assembled[mesh]
    eng = a["eng"]
    fused, staged, flat = a[what]
    got = eng.from_lane(fused)
    assert _rel(got, eng.from_lane(staged)) <= 1e-12
    assert _rel(got, flat.numpy()) <= 1e-12
    # copy slots carry their owners' values
    assert torch.equal(eng.refresh_copies(fused), fused)
    assert torch.equal(eng.to_lane_dev(eng.from_lane_dev(fused)), fused)


# -- the slice as a whole: fused Jacobi solve against the reference's ---------------


def test_fused_solve_matches_reference_fused_solve(setup):
    s = setup["damage"]
    ej, ef = s["ej"], s["ef"]
    uj, sj = ej.make_solver(JSolverConfig(**SOLVER), cg_chunk=200)(
        jnp.zeros_like(ej.bc_lane), s["ccj"])
    ut, st = ef.make_solver(TSolverConfig(**SOLVER), cg_chunk=50)(
        torch.zeros_like(ef.bc_lane), s["ccf"])
    assert sj["converged"] and st["converged"]
    assert st["newton_iters"] == sj["newton_iters"] > 1
    assert len(st["cg_iters"]) == len(sj["cg_iters"])
    assert all(abs(a - b) <= 1
               for a, b in zip(st["cg_iters"], sj["cg_iters"]))
    assert _rel(ef.from_lane(ut), ej.from_lane(uj)) <= 1e-9
    # and the port's staged solve lands on the same solution
    es = s["es"]
    us, ss = es.make_solver(TSolverConfig(**SOLVER), cg_chunk=50)(
        torch.zeros_like(es.bc_lane), s["ccs"])
    assert ss["newton_iters"] == st["newton_iters"]
    assert _rel(ef.from_lane(ut), es.from_lane(us)) <= 1e-9


# -- what the fused kernel has no law for runs generated ---------------------------


def _engine_for(integrand, *, degree=1, coefficients=()):
    mesh = t_mesh.unit_square(4)
    V = t_spaces.FunctionSpace.create(mesh, degree, bs=2)
    coeffs = [t_form.Coefficient(n, t_spaces.FunctionSpace.create(mesh, 1))
              for n in coefficients]
    F = t_form.EnergyFunctional(V, [t_form.Term(integrand, 1)], coeffs, **F64)
    return lambda **kw: TLaneEngine(F, [], wg_own=8, **kw, **F64)


def _custom_energy(eps, Ey, nu):  # linear elasticity, but not a tagged law
    lam, mu = t_forms.lame_parameters(Ey, nu)
    tr = eps[0, 0] + eps[1, 1]
    return 0.5 * lam * tr * tr + mu * (
        eps[0, 0] ** 2 + eps[1, 1] ** 2 + 2.0 * eps[0, 1] * eps[1, 0])


# integrands no hand-written law takes: each once raised here, and now runs
# on the generated route (tests/test_torch_fused_gen.py holds that route
# against the reference)
_NO_LAW = {
    "reads_x": dict(integrand=lambda qp: (1.0 + qp.x[0])
                    * t_forms.linear_elastic_psi(qp.eps, E, NU)),
    "untagged_energy": dict(integrand=lambda qp: _custom_energy(
        qp.eps, E, NU)),
    "scaled_law": dict(integrand=lambda qp: 2.0 * t_forms.asym_damage_psi(
        qp.eps, qp.coeff("d"), E, NU), coefficients=("d",)),
    "derived_argument": dict(integrand=lambda qp: t_forms.asym_damage_psi(
        qp.eps, 1.0 - qp.coeff("d"), E, NU), coefficients=("d",)),
    "two_laws": dict(integrand=lambda qp: t_forms.linear_elastic_psi(
        qp.eps, E, NU) + t_forms.asym_damage_psi(qp.eps, 0.5, E, NU)),
}


@pytest.mark.parametrize("case", sorted(_NO_LAW))
def test_fused_generated_takes_what_no_law_does(case):
    """No hand-written law, the physics generated from the integrand:
    residual and tangent action equal the staged engine's (rel <=
    1e-12); x rows streamed only where the integrand reads x."""
    make = _engine_for(**_NO_LAW[case])
    ef = make(fused=True)
    es = make(fused=False, plan=ef.plan)
    assert ef.fused_law is None and es.fused_law is None
    assert ef.fused_geom.shape[1] == (9 if case == "reads_x" else 7)
    rng = np.random.default_rng(13)
    n = ef.space.n_dofs
    coeffs = {c: rng.uniform(0.0, 1.0, ef.space.mesh.n_nodes)
              for c in _NO_LAW[case].get("coefficients", ())}
    ccf, ccs = ef.prepare_coeffs(coeffs), es.prepare_coeffs(coeffs)
    u, v = ef.to_lane(1e-3 * rng.standard_normal(n)), ef.to_lane(
        rng.standard_normal(n))
    assert _rel(ef.residual(u, ccf), es.residual(u, ccs)) <= 1e-12
    assert _rel(ef.tangent_action(u, ccf, v),
                es.tangent_action(u, ccs, v)) <= 1e-12


_UNSUPPORTED = {
    "p2_space": dict(integrand=lambda qp: t_forms.linear_elastic_psi(
        qp.eps, E, NU), degree=2),
}


@pytest.mark.parametrize("case", sorted(_UNSUPPORTED))
def test_fused_raises_for_unsupported_integrand(case):
    """Once raised here (the multi-quadrature-point path ran staged only);
    now the fused engine takes it on the generated multi-point route
    (``lane_fused_gen_mq``): residual and tangent action equal the staged
    engine's, rel <= 1e-12 (tests/test_torch_fused_mq.py holds that route
    against the reference)."""
    make = _engine_for(**_UNSUPPORTED[case])
    ef = make(fused=True)
    es = make(fused=False, plan=ef.plan)
    assert ef.path == "multiqp" and ef.fused_gen(torch.float64).MULTIQP
    rng = np.random.default_rng(14)
    n = ef.space.n_dofs
    cc = ef.prepare_coeffs({})
    u, v = ef.to_lane(1e-3 * rng.standard_normal(n)), ef.to_lane(
        rng.standard_normal(n))
    assert _rel(ef.residual(u, cc), es.residual(u, cc)) <= 1e-12
    assert _rel(ef.tangent_action(u, cc, v),
                es.tangent_action(u, cc, v)) <= 1e-12


def test_fused_engine_refuses_foreign_coefficients(setup):
    """Coefficients prepared by a staged engine lack the `_cd` block: the
    fused engine raises instead of switching to the staged path."""
    s = setup["damage"]
    with pytest.raises(KeyError, match="_cd"):
        s["ef"].residual(torch.from_numpy(s["u"]), s["ccs"])


# K4's launch geometry (lane_fused_elem on a CUDA tensor): the wrapper
# computes it on the host and the kernel checks its shared-memory size
def _layout(lb, ky, stages, ns, wr, dn, vb, ib):
    """csrc/lane_fused_elem.cu:fused_layout, region by region."""
    pad = tk._pad16
    return (pad(2 * wr * lb * vb) + pad(ns * 2 * wr * lb * vb)
            + pad(stages * (7 + dn) * ky * lb * vb)
            + pad(stages * 3 * ky * lb * ib) + pad(2 * ky * 6 * lb * vb)
            + pad(2 * ky * 3 * lb * 2))


def test_fused_geometry_at_the_main_path():
    """The n = 1024 plan (wr = 40, 4 coefficient rows), float32 values,
    int8 indices: blocks of 32 lane columns x 4 cells (128 threads), four
    to a bin, a ring of 3 rounds; the Hessian-vector product's 56 448
    bytes let four blocks share an SM (228 KB, 1 KB reserved per block)."""
    for ns, smem in ((1, 46208), (2, 56448)):
        g = tk.fused_elem_geometry(ns, 40, 4, 4, 1)
        assert g == dict(lb=32, ky=4, stages=3, smem=smem, grid_y=4,
                         threads=128)
        assert smem == _layout(32, 4, 3, ns, 40, 4, 4, 1)
        assert smem == tk.fused_layout_bytes(32, 4, 3, ns, 40, 4, 4, 1)
    assert 4 * (56448 + 1024) <= 228 * 1024


@pytest.mark.parametrize("vb,ib", [(4, 1), (4, 4), (8, 1), (8, 4)])
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("wr", [9, 40, 126])
def test_fused_geometry_takes_the_first_layout_that_fits(vb, ib, ns, wr):
    """Every dtype pair, both modes and windows up to the int8 limit: the
    first block layout of ``FUSED_CONFIGS`` that fits 227 KB; the float64
    Hessian-vector product of a 126-row window takes 16 lane columns."""
    g = tk.fused_elem_geometry(ns, wr, 4, vb, ib)
    fits = [cfg for cfg in tk.FUSED_CONFIGS
            if _layout(*cfg, ns, wr, 4, vb, ib) <= tk.SMEM_PER_BLOCK]
    assert (g["lb"], g["ky"], g["stages"]) == fits[0]
    assert g["smem"] == _layout(*fits[0], ns, wr, 4, vb, ib)
    assert g["grid_y"] * g["lb"] == 128 and g["threads"] == g["ky"] * g["lb"]
    assert (g["lb"] == 16) == (vb == 8 and ns == 2 and wr == 126)


def test_fused_geometry_raises_where_no_layout_fits():
    """A window too tall for every layout: ValueError, no launch and no
    other kernel in its place."""
    with pytest.raises(ValueError, match="does not fit"):
        tk.fused_elem_geometry(2, 400, 4, 8, 4)
    with pytest.raises(ValueError):
        tk.fused_elem_geometry(3, 40, 4, 4, 1)
