"""The lattice multigrid of tpufem_torch (``la.precond.chebyshev_iterate``,
``structured.grid2d``, ``structured.mg2d``) against tpufem (CPU, float64,
same numpy inputs through both).

Tolerances: lattice residual, tangent action (the JVP and the stored
stencil), diagonal and energy rel <= 1e-12 (sums in another order);
``prolong`` / ``restrict`` exactly equal (the same additions in the same
order); per-level ``inv_d``, ``lmax``, ``coarse_inv`` (its free block;
see ``_check_coarse_inv`` for the rest) and the V-cycle rel <= 1e-10
(15 power iterations and a pseudo-inverse amplify rounding differences of
the level operators)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.forms as j_forms
import tpufem_torch.forms as t_forms
from tpufem.la.precond import chebyshev_iterate as j_cheb
from tpufem.structured import mg2d as j_mg
from tpufem.structured.grid2d import StructuredGrid2D as JGrid
from tpufem_torch.la.precond import chebyshev_iterate as t_cheb
from tpufem_torch.structured import mg2d as t_mg
from tpufem_torch.structured.grid2d import StructuredGrid2D as TGrid
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
LAWS = ("linear", "asym")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _grids(n, law):
    """The same lattice discretization in both packages: linear
    elasticity, or the damage law with a vertex damage and a per-cell
    modulus field (the polycrystal's coarse lattice)."""
    out = []
    for G, forms in ((JGrid, j_forms), (TGrid, t_forms)):
        if law == "linear":
            dens = (lambda g, c, f=forms: f.linear_elastic_psi(
                0.5 * (g + g.T), E, NU))
            kinds = {}
        else:
            dens = (lambda g, c, f=forms: f.asym_damage_psi(
                0.5 * (g + g.T), c["d"], c["E"], NU))
            kinds = {"d": "vertex", "E": "cell"}
        out.append(G(nx=n, ny=n, hx=1.0 / n, hy=1.0 / n, bs=2,
                     energy_density=dens, field_kinds=kinds))
    return out


def _fields(n, law, rng):
    if law == "linear":
        return {}
    d = np.zeros((n + 1, n + 1))
    d[(n + 1) // 3: (n + 1) // 2] = 0.8
    d[(n + 1) // 2, : n // 3] = 1.0
    return {"d": d, "E": E * rng.uniform(0.5, 2.0, (2, n, n))}


def _free(n):
    free = np.ones((2, n + 1, n + 1))
    free[:, :, 0] = 0.0
    free[:, :, -1] = 0.0
    return free


@pytest.fixture(scope="module", params=LAWS)
def grid_case(request):
    """n = 12 lattice: both grids, fields, a state with zero-strain cells,
    a direction, and the reference's residual / tangent / diagonal /
    energy / load residual."""
    law = request.param
    n = 12
    rng = np.random.default_rng(7)
    gj, gt = _grids(n, law)
    f = _fields(n, law, rng)
    u = 1e-3 * rng.standard_normal((2, n + 1, n + 1))
    u[:, : n // 3] = 0.0  # whole rows of cells at exactly zero strain
    v = rng.standard_normal((2, n + 1, n + 1))
    load = rng.standard_normal((2, n + 1, n + 1))
    fj = {k: jnp.asarray(a) for k, a in f.items()}
    uj, vj = jnp.asarray(u), jnp.asarray(v)
    ref = dict(
        residual=gj.residual(uj, fj), tangent=gj.tangent_action(uj, fj, vj),
        diagonal=gj.diagonal(uj, fj), energy=gj.energy(uj, fj),
        load=gj.load_residual(jnp.asarray(load)),
        tangent0=gj.tangent_action(jnp.zeros_like(uj), fj, vj),
        diagonal0=gj.diagonal(jnp.zeros_like(uj), fj),
    )
    ref = {k: np.asarray(a) for k, a in ref.items()}
    ft = {k: _t(a) for k, a in f.items()}
    return dict(law=law, gt=gt, ft=ft, u=_t(u), v=_t(v), load=_t(load),
                ref=ref)


def test_grid2d_residual_energy_load(grid_case):
    c = grid_case
    gt, ft, u, ref = c["gt"], c["ft"], c["u"], c["ref"]
    assert _rel(gt.residual(u, ft), ref["residual"]) <= 1e-12
    assert _rel(gt.load_residual(c["load"]), ref["load"]) <= 1e-12
    assert abs(float(gt.energy(u, ft)) - ref["energy"]) <= 1e-12 * abs(
        ref["energy"])


def test_grid2d_tangent_jvp_and_stored_agree(grid_case):
    """The JVP tangent and the stored stencil (element matrices from
    ``linearize``) both equal the reference's jvp of the residual."""
    c = grid_case
    gt, ft, u, v, ref = c["gt"], c["ft"], c["u"], c["v"], c["ref"]
    jv = gt.tangent_action(u, ft, v)
    st = gt.operator(u, ft)(v)
    assert _rel(jv, ref["tangent"]) <= 1e-12
    assert _rel(st, ref["tangent"]) <= 1e-12
    assert _rel(st, jv) <= 1e-12
    assert _rel(gt.diagonal(u, ft), ref["diagonal"]) <= 1e-12
    assert _rel(gt.operator(u, ft).diagonal(), ref["diagonal"]) <= 1e-12


def test_grid2d_linearized_at_zero_strain(grid_case):
    """Every level of the two-level cycle is linearized at u = 0: the
    Hessian of the damage law is taken at eps = 0 exactly (the
    where/sqrt trap). Finite, and equal to the reference's."""
    c = grid_case
    gt, ft, v, ref = c["gt"], c["ft"], c["v"], c["ref"]
    z = torch.zeros_like(c["u"])
    Ke = gt.linearize(z, ft)
    assert torch.isfinite(Ke).all()
    assert _rel(gt.operator(z, ft)(v), ref["tangent0"]) <= 1e-12
    assert _rel(gt.diagonal(z, ft), ref["diagonal0"]) <= 1e-12
    assert _rel(gt.tangent_action(z, ft, v), ref["tangent0"]) <= 1e-12


def test_constrained_operator_folds_dirichlet_rows(grid_case):
    """``operator(u, fields, free)`` is v -> J(v*free)*free + v*(1-free)."""
    c = grid_case
    gt, ft, u, v = c["gt"], c["ft"], c["u"], c["v"]
    n = gt.nx
    free = _t(_free(n))
    want = gt.tangent_action(u, ft, v * free) * free + v * (1.0 - free)
    assert _rel(gt.operator(u, ft, free)(v), want) <= 1e-12
    # leading batch dimensions are kept
    vb = torch.stack([v, 2.0 * v])
    got = gt.operator(u, ft, free)(vb)
    assert _rel(got[1], 2.0 * want) <= 1e-12


def test_prolong_restrict_exact_and_adjoint():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(2, 9, 13))
    f = rng.normal(size=(2, 17, 25))
    P = t_mg.prolong(_t(c)).numpy()
    R = t_mg.restrict(_t(f)).numpy()
    assert np.array_equal(P, np.asarray(j_mg.prolong(jnp.asarray(c))))
    assert np.array_equal(R, np.asarray(j_mg.restrict(jnp.asarray(f))))
    lhs, rhs = float((P * f).sum()), float((c * R).sum())
    assert abs(lhs - rhs) < 1e-12 * abs(lhs)


def test_coarse_operator_is_galerkin():
    """Rediscretized coarse operator == P^T A P (nested P1), from the
    port's stored stencils."""
    n = 8
    _, gf = _grids(n, "linear")
    gc = t_mg.coarsen_grid(gf)
    sf, sc = (2, n + 1, n + 1), (2, n // 2 + 1, n // 2 + 1)
    nf, ncd = 2 * (n + 1) ** 2, 2 * (n // 2 + 1) ** 2
    Af = gf.operator(torch.zeros(sf, dtype=torch.float64), {})(
        torch.eye(nf, dtype=torch.float64).reshape(nf, *sf)).reshape(nf, nf).T
    Ac = gc.operator(torch.zeros(sc, dtype=torch.float64), {})(
        torch.eye(ncd, dtype=torch.float64).reshape(ncd, *sc)).reshape(
            ncd, ncd).T
    P = t_mg.prolong(torch.eye(ncd, dtype=torch.float64).reshape(
        ncd, *sc)).reshape(ncd, nf).T
    G = P.T @ Af @ P
    assert float((G - Ac).abs().max()) < 1e-10 * float(Ac.abs().max())


def test_chebyshev_iterate_matches_reference():
    """Same iterate from a given start and from zero (the port skips the
    exactly-zero product A(0))."""
    rng = np.random.default_rng(3)
    M = rng.standard_normal((40, 40))
    A = M @ M.T + 40.0 * np.eye(40)
    inv_d = 1.0 / np.diag(A)
    lmax = float(np.linalg.eigvalsh(inv_d[:, None] * A).max())
    b, x0 = rng.standard_normal(40), rng.standard_normal(40)
    Aj, At = jnp.asarray(A), _t(A)
    for x in (x0, None):
        want = j_cheb(lambda y: Aj @ y, jnp.asarray(inv_d), lmax,
                      jnp.asarray(b), jnp.asarray(np.zeros(40) if x is None
                                                  else x),
                      degree=3, lmin_ratio=1.0 / 8.0)
        got = t_cheb(lambda y: At @ y, _t(inv_d), lmax, _t(b),
                     None if x is None else _t(x), degree=3,
                     lmin_ratio=1.0 / 8.0)
        assert _rel(got, want) <= 1e-13


def _check_coarse_inv(got, want, coarse_free):
    """coarse_inv: the block between free dofs (the only block the cycle
    reads: its input and output are masked by coarse_free) rel <= 1e-10;
    the whole matrix within 1e-8 of its largest entry. The pseudo-inverse
    of an operator with unit Dirichlet rows beside E-scale rows leaves
    SVD rounding noise of about eps * sigma_max / sigma_min ~ 1e-9 in the
    entries that are exactly zero (measured 1.1e-9 here and 4.1e-9 on the
    polycrystal of test_torch_twolevel.py); numpy computes the pinv in
    both."""
    m = np.asarray(coarse_free).ravel() > 0.5
    blk = np.ix_(m, m)
    assert _rel(got[blk], want[blk]) <= 1e-10
    assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()


@pytest.fixture(scope="module")
def hierarchy():
    """n = 16, coarse_dofs = 100: two smoothed levels (17^2 and 9^2
    nodes) and a dense 5^2 coarsest level, damage law with vertex and
    cell fields, linearized at u = 0 -- as the two-level cycle builds it.

    Damage is capped at 0.8 here: a fully damaged cell at zero strain has
    no stiffness, the level operators are then nearly singular, and the
    cycle amplifies rounding-level differences of their entries (1.2e-10
    measured for the V-cycle at n = 32 with a d = 1 row)."""
    n = 16
    rng = np.random.default_rng(11)
    gj, gt = _grids(n, "asym")
    f = _fields(n, "asym", rng)
    f["d"] = np.minimum(f["d"], 0.8)
    free = _free(n)
    u0 = np.zeros((2, n + 1, n + 1))
    gjs, dj = j_mg.build_mg2d(gj, jnp.asarray(u0),
                              {k: jnp.asarray(a) for k, a in f.items()},
                              jnp.asarray(free), coarse_dofs=100)
    gts, dt = t_mg.build_mg2d(gt, _t(u0), {k: _t(a) for k, a in f.items()},
                              _t(free), coarse_dofs=100)
    b = rng.standard_normal((2, n + 1, n + 1)) * free
    want = np.asarray(jax.jit(lambda d_, b_: j_mg.vcycle(gjs, d_, b_))(
        dj, jnp.asarray(b)))
    return dict(gjs=gjs, dj=dj, gts=gts, dt=dt, b=b, want=want)


def test_build_mg2d_levels_match_reference(hierarchy):
    h = hierarchy
    dj, dt = h["dj"], h["dt"]
    assert len(dt.levels) == len(dj.levels) == 2
    assert len(h["gts"]) == len(h["gjs"]) == 3
    for lj, lt in zip(dj.levels, dt.levels):
        assert np.array_equal(lt.free.numpy(), np.asarray(lj.free))
        for k in lj.fields:
            assert _rel(lt.fields[k], lj.fields[k]) <= 1e-15
        assert _rel(lt.inv_d, lj.inv_d) <= 1e-10
        assert abs(lt.lmax - float(lj.lmax)) <= 1e-10 * abs(float(lj.lmax))
    assert np.array_equal(dt.coarse_free.numpy(), np.asarray(dj.coarse_free))
    _check_coarse_inv(dt.coarse_inv.numpy(), np.asarray(dj.coarse_inv),
                      np.asarray(dj.coarse_free))


def test_vcycle_matches_reference(hierarchy):
    h = hierarchy
    got = t_mg.vcycle(h["dt"], _t(h["b"]))
    assert _rel(got, h["want"]) <= 1e-10
    M = t_mg.mg_preconditioner()
    assert torch.equal(M(h["dt"], _t(h["b"])), got)
