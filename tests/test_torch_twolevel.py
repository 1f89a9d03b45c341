"""The two-level preconditioner of tpufem_torch (``lane.twolevel``, K5
``lane_gather_weighted``, ``make_solver(preconditioner="twolevel")``)
against tpufem (CPU, float64, same numpy inputs through both).

The fixture is the reference's own (tests/test_twolevel.py): the n = 32,
10-grain polycrystal with wg_own = 8, whose plan teleports cells, so the
transfer tables have excluded copy slots refreshed from their owners; the
lattice has nc = 16 cells per side. The JAX side runs its Pallas kernels
in interpret mode; the port's wrappers take their plain versions because
the tensors lie on the CPU.

Tolerances: K5 rel <= 1e-13 (the Pallas kernel sums window-row-outer, the
port v-ascending); host tables and static dims exactly equal; the coarse
pseudo-inverse's free block rel <= 1e-10 (the rest is SVD noise, see
test_torch_mg.py); one application of the cycle rel <= 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.lane.twolevel as j_tl
import tpufem_torch.lane.twolevel as t_tl
from tpufem.lane import kernels as jk
from tpufem_torch.lane import kernels as tk
from tpufem_torch.utils.convert import twolevel_from_numpy
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
N, GRAINS, WG_OWN, NC = 32, 10, 8, 16
F64 = dict(device="cpu", dtype=torch.float64)
TABLES = ("S", "p_starts", "p_idx", "p_wts", "r_starts", "r_idx", "r_wts",
          "o_dst", "o_src")
DIMS = ("SC", "WRp", "WRr", "Kc", "ncx", "ncy", "Rv", "degree")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


# -- K5 against the Pallas kernel -------------------------------------------


@pytest.mark.parametrize("V,K,wr,idt", [
    (4, 40, 16, np.int8), (4, 40, 16, np.int32),
    (15, 16, 16, np.int8), (15, 16, 16, np.int32),
], ids=["prolong-int8", "prolong-int32", "restrict-int8", "restrict-int32"])
def test_lane_gather_weighted_plain_matches_pallas(V, K, wr, idt):
    """Random tables with -1 entries (a third), the two shapes of the
    two-level transfers (prolongation: V = 4 parents, K = wg rows;
    restriction: V supporters, K = Kc view rows), both index types."""
    rng = np.random.default_rng(V * 100 + K)
    C, T, L = 2, 3, 128
    R = T * wr
    values = rng.standard_normal((C, R, L))
    starts = (rng.integers(0, R - wr + 1, T)).astype(np.int32)
    idx = rng.integers(0, wr, (T, V, K, L))
    idx[rng.random(idx.shape) < 0.33] = -1
    idx = idx.astype(idt)
    wts = rng.uniform(0.0, 1.0, (T, V, K, L))
    want = np.asarray(jk.lane_gather_weighted(
        jnp.asarray(values), jnp.asarray(starts), jnp.asarray(idx),
        jnp.asarray(wts), wr=wr, interpret=True))
    got = tk.lane_gather_weighted(
        torch.from_numpy(values), torch.from_numpy(starts),
        torch.from_numpy(idx), torch.from_numpy(wts), wr=wr)
    assert got.shape == (T, C, K, L)
    assert got.permute(1, 0, 2, 3).is_contiguous()
    assert _rel(got, want) <= 1e-13


# -- the two-level structures on the reference's fixture ----------------------


def _problem(pkg, mesh=None):
    if pkg == "jax":
        from tpufem.cases.polycrystal import generate_polycrystal
        from tpufem.forms import EnergyFunctional, asym_damage_psi
        from tpufem.forms.form import Coefficient, Term
        from tpufem.spaces import DirichletBC, FunctionSpace
        from tpufem.spaces.bc import locate_dofs_geometrical
        kw = {}
    else:
        from tpufem_torch.cases.polycrystal import generate_polycrystal
        from tpufem_torch.forms import EnergyFunctional, asym_damage_psi
        from tpufem_torch.forms.form import Coefficient, Term
        from tpufem_torch.spaces import DirichletBC, FunctionSpace
        from tpufem_torch.spaces.bc import locate_dofs_geometrical
        kw = F64
    mesh = generate_polycrystal(N, n_grains=GRAINS) if mesh is None else mesh
    V = FunctionSpace.create(mesh, 1, bs=2)
    DS = FunctionSpace.create(mesh, 1, bs=1)
    t = Term(lambda qp: asym_damage_psi(qp.eps, qp.coeff("d"), E, NU), 1)
    F = EnergyFunctional(V, [t], [Coefficient("d", DS)], **kw)
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [DirichletBC(V, left, [0.0, 0.0]),
           DirichletBC(V, right, [0.01, 0.0])]
    d = np.zeros(DS.n_dofs)
    d[np.abs(DS.dof_coords[:, 1] - 0.5) < 0.05] = 0.6
    return F, bcs, V, d


@pytest.fixture(scope="module")
def setup():
    """Both packages' engines on the reference's fixture (JAX staged in
    interpret mode; port staged and fused on the port's own plan, which
    is field-exact with the reference's), both two-level builds, the
    port's smoother data at the Dirichlet-lifted zero state, and the
    port's structures rebuilt from the reference's tables."""
    from tpufem.lane import LaneEngine as JLaneEngine
    from tpufem_torch.lane import LaneEngine as TLaneEngine

    Fj, bj, Vj, d = _problem("jax")
    Ft, bt, Vt, _ = _problem("torch")
    ej = JLaneEngine(Fj, bj, wg_own=WG_OWN, interpret=True)
    stj, geoj = j_tl.build_twolevel_geo(ej, {"d": d}, nc=NC)

    es = TLaneEngine(Ft, bt, wg_own=WG_OWN, **F64)
    ef = TLaneEngine(Ft, bt, plan=es.plan, fused=True, **F64)
    ccs = es.prepare_coeffs({"d": d})
    ccf = ef.prepare_coeffs({"d": d})
    sts, geos = t_tl.build_twolevel_geo(es, {"d": d}, nc=NC)
    datas = t_tl.refresh_twolevel(es, sts, geos, es.bc_lane, ccs)
    # the reference's cycle on the same smoother data
    dataj = j_tl.TwoLevelData(inv_d=jnp.asarray(datas.inv_d.numpy()),
                              lmax=jnp.asarray(datas.lmax), **geoj)

    mgj = geoj["mg_data"]
    ref_geo = {k: np.asarray(geoj[k]) for k in TABLES}
    ref_geo["coarse_free"] = np.asarray(geoj["coarse_free"])
    ref_geo["mg_data"] = dict(
        levels=[dict(u_lin=np.asarray(L.u_lin), free=np.asarray(L.free),
                     fields={k: np.asarray(f) for k, f in L.fields.items()},
                     inv_d=np.asarray(L.inv_d), lmax=np.asarray(L.lmax))
                for L in mgj.levels],
        coarse_inv=np.asarray(mgj.coarse_inv),
        coarse_free=np.asarray(mgj.coarse_free))
    g0 = stj.mg_grids[0]
    stx, datax = twolevel_from_numpy(
        es, {k: getattr(stj, k) for k in DIMS}, ref_geo, hx=g0.hx, hy=g0.hy,
        field_kinds=g0.field_kinds, inv_d=datas.inv_d, lmax=datas.lmax)
    return dict(d=d, ej=ej, stj=stj, geoj=geoj, dataj=dataj,
                es=es, ef=ef, ccs=ccs, ccf=ccf, sts=sts, geos=geos,
                datas=datas, stx=stx, datax=datax, Vt=Vt)


def test_geo_tables_and_dims_exactly_equal(setup):
    s = setup
    stj, sts = s["stj"], s["sts"]
    for k in DIMS:
        assert getattr(sts, k) == getattr(stj, k), k
    for k in TABLES:
        got, want = _np(s["geos"][k]), np.asarray(s["geoj"][k])
        assert got.shape == want.shape and np.array_equal(got, want), k
        if k.endswith("_idx"):
            assert got.dtype == want.dtype, k
    assert np.array_equal(_np(s["geos"]["coarse_free"]),
                          np.asarray(s["geoj"]["coarse_free"]))
    assert int(s["geoj"]["o_dst"].size) > 0, "fixture lost its teleports"


def test_coarse_hierarchy_matches(setup):
    """nc = 16: 578 lattice dofs, below coarse_dofs, so the hierarchy is
    the dense coarse operator alone (levels are held against the
    reference in test_torch_mg.py)."""
    s = setup
    mj, mt = s["geoj"]["mg_data"], s["geos"]["mg_data"]
    assert len(mt.levels) == len(mj.levels) == 0
    cf = np.asarray(mj.coarse_free).ravel() > 0.5
    blk = np.ix_(cf, cf)
    got, want = _np(mt.coarse_inv), np.asarray(mj.coarse_inv)
    assert _rel(got[blk], want[blk]) <= 1e-10
    assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()


def test_transfers_match_reference(setup):
    """restrict / prolong (K5 + the selector products + the teleported
    copy refresh) on the same tables and vectors."""
    s = setup
    rng = np.random.default_rng(4)
    c = rng.normal(size=(2, NC + 1, NC + 1))
    v = rng.normal(size=s["es"].bc_lane.shape)
    Pj = np.asarray(j_tl.prolong(s["ej"], s["stj"], s["dataj"],
                                 jnp.asarray(c)))
    Rj = np.asarray(j_tl.restrict(s["ej"], s["stj"], s["dataj"],
                                  jnp.asarray(v)))
    for st, data in ((s["sts"], s["datas"]), (s["stx"], s["datax"])):
        Pt = t_tl.prolong(s["es"], st, data, torch.from_numpy(c))
        Rt = t_tl.restrict(s["es"], st, data, torch.from_numpy(v))
        assert _rel(Pt, Pj) <= 1e-13
        assert _rel(Rt, Rj) <= 1e-13


def test_transfer_adjoint_pou_and_teleports(setup):
    """P and R are exact adjoints in the owned inner product, P
    reproduces constants at owned slots, and every excluded copy slot
    carries its owner's prolonged value."""
    s = setup
    es, st, data = s["es"], s["sts"], s["datas"]
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.normal(size=(2, NC + 1, NC + 1)))
    v = torch.from_numpy(rng.normal(size=es.bc_lane.shape))
    lhs = float(es.dot(t_tl.prolong(es, st, data, c), v))
    rhs = float((c * t_tl.restrict(es, st, data, v)).sum())
    assert abs(lhs - rhs) < 1e-12 * abs(lhs)
    P1 = t_tl.prolong(es, st, data, torch.ones_like(c)).numpy()
    assert np.abs(P1[0][es.plan.owned_mask] - 1).max() < 1e-12
    Pc = t_tl.prolong(es, st, data, c).reshape(2, -1).numpy()
    o_dst, o_src = _np(data.o_dst), _np(data.o_src)
    assert len(o_dst) > 0
    assert np.abs(Pc[:, o_dst] - Pc[:, o_src]).max() == 0.0


@pytest.mark.parametrize("engine", ["staged", "fused"])
def test_cycle_matches_reference(setup, engine):
    """One application of the cycle (``precondition_with``: Chebyshev
    smoothing, K5 restriction, lattice V-cycle, K5 prolongation and the
    teleported-copy refresh, Chebyshev again) in both packages around one
    and the same fine operator -- the port engine's constrained tangent at
    the Dirichlet-lifted zero state, staged (stored Hessian) or fused
    (K4's plain version) -- and the same smoother data; on the port's own
    tables and on the reference's (``twolevel_from_numpy``).
    ``precondition`` builds that operator itself and gives the same."""
    s = setup
    eng = s["es"] if engine == "staged" else s["ef"]
    cc = s["ccs"] if engine == "staged" else s["ccf"]
    free = eng.free_lane
    Araw = eng.make_tangent(eng.bc_lane, cc)

    def At(v):
        return Araw(v * free) * free + v * (1.0 - free)

    def Aj(v):  # the same operator, for the reference's cycle
        return jnp.asarray(At(torch.from_numpy(np.asarray(v))).numpy())

    rng = np.random.default_rng(9)
    rt = eng.to_lane(rng.normal(size=s["Vt"].n_dofs)) * free
    zj = np.asarray(j_tl.precondition_with(
        s["ej"], s["stj"], s["dataj"], jnp.asarray(free.numpy()),
        jnp.asarray(rt.numpy()), Aj))
    before = dict(tk.launch_counts())
    for st, data in ((s["sts"], s["datas"]), (s["stx"], s["datax"])):
        zt = t_tl.precondition_with(eng, st, data, free, rt, At)
        assert _rel(zt, zj) <= 1e-10
    zp = t_tl.precondition(eng, s["sts"], s["datas"], eng.bc_lane, cc, free,
                           rt)
    assert _rel(zp, zj) <= 1e-10
    # CPU tensors: the wrappers ran their plain versions, counting nothing
    assert tk.launch_counts() == before
    # the cycle is symmetric in the owned inner product (CG needs it)
    rt2 = eng.to_lane(rng.normal(size=s["Vt"].n_dofs)) * free
    zt2 = t_tl.precondition_with(eng, s["sts"], s["datas"], free, rt2, At)
    a, b = float(eng.dot(rt2, zp)), float(eng.dot(rt, zt2))
    assert abs(a - b) <= 1e-10 * abs(a)


def test_unported_twolevel_paths_raise(setup, monkeypatch):
    s = setup
    es = s["es"]
    for kw in (dict(lattice={}), dict(coarse=()), dict(owned=np.ones(1)),
               dict(force={})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_tl.build_twolevel_geo(es, {"d": s["d"]}, nc=NC, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_tl.build_twolevel_geo_sharded(None, {"d": s["d"]})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_tl.rigid_body_modes_lane(es)
    r = es.free_lane.clone()
    for kw in (dict(coarse_reduce=lambda x: x), dict(defl=(None, None))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_tl.precondition_with(es, s["sts"], s["datas"], es.free_lane,
                                   r, lambda v: v, **kw)
    monkeypatch.setenv("TPUFEM_ARTIFACT_CACHE", "/nonexistent")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_tl.build_twolevel_geo(es, {"d": s["d"]}, nc=NC)
