"""The 3D structured lattice of tpufem_torch (``structured.grid3d``,
``structured.mg3d``) against tpufem (CPU, float64, the same numpy inputs
through both).

Tolerances: residual, tangent action (the JVP and the stored 27-point
stencil), diagonal, energy and load residual rel <= 1e-12 (sums in another
order); ``prolong`` / ``restrict`` exactly equal (the same additions in
the same order).

The reference's own ``StructuredGrid3D.diagonal`` (24 JVP columns under
``jit``) takes about 70 s to compile on the CPU whatever the lattice, so
the diagonal is held against the diagonal of the reference's Jacobian
(``jax.jacfwd`` of its residual), which compiles in a few seconds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.forms as j_forms
import tpufem_torch.forms as t_forms
from tpufem.structured import mg3d as j_mg3
from tpufem.structured.grid3d import StructuredGrid3D as JGrid
from tpufem_torch.structured import kernels3d as K3
from tpufem_torch.structured import mg3d as t_mg3
from tpufem_torch.structured.grid3d import StructuredGrid3D as TGrid
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _grids(nx, ny, nz, law, h=None):
    """The same lattice in both packages: linear elasticity, or linear
    elasticity softened by a vertex damage field and scaled by a per-cell
    modulus factor (both kinds of coefficient)."""
    h = h or (1.0 / nx, 1.0 / ny, 1.0 / nz)
    out = []
    for G, f in ((JGrid, j_forms), (TGrid, t_forms)):
        if law == "linear":
            dens = (lambda g, c, f=f: f.linear_elastic_psi(
                0.5 * (g + g.T), E, NU))
            kinds = {}
        else:
            dens = (lambda g, c, f=f: (1.0 - 0.5 * c["d"]) * c["k"]
                    * f.linear_elastic_psi(0.5 * (g + g.T), E, NU))
            kinds = {"d": "vertex", "k": "cell"}
        out.append(G(nx=nx, ny=ny, nz=nz, hx=h[0], hy=h[1], hz=h[2], bs=3,
                     energy_density=dens, field_kinds=kinds))
    return out


@pytest.fixture(scope="module")
def case():
    """A 4x3x5 anisotropic lattice with both kinds of coefficient field
    (linear elasticity is the special case d = 0, k = 1, held against the
    reference in test_torch_structured_kernels.py): both grids, fields, a
    state, a direction, a load, and the reference's quantities."""
    law = "damaged"
    nx, ny, nz = 4, 3, 5
    gj, gt = _grids(nx, ny, nz, law, h=(0.25, 0.4, 0.15))
    rng = np.random.default_rng(11)
    shape = (3, nz + 1, ny + 1, nx + 1)
    f = {} if law == "linear" else {
        "d": rng.uniform(0, 1, shape[1:]),
        "k": rng.uniform(0.5, 2.0, (nz, ny, nx))}
    u = 1e-3 * rng.standard_normal(shape)
    v = rng.standard_normal(shape)
    load = rng.standard_normal(shape)
    fj = {k: jnp.asarray(a) for k, a in f.items()}
    uj, vj = jnp.asarray(u), jnp.asarray(v)

    def res(w):
        return gj.residual(w, fj)

    J = jax.jit(jax.jacfwd(res))(uj)
    n = u.size
    ref = dict(
        residual=jax.jit(res)(uj),
        tangent=jax.jit(lambda w, x: gj.tangent_action(w, fj, x))(uj, vj),
        diagonal=jnp.diagonal(J.reshape(n, n)).reshape(shape),
        jacobian=J.reshape(n, n),
        energy=jax.jit(lambda w: gj.energy(w, fj))(uj),
        load=jax.jit(gj.load_residual)(jnp.asarray(load)),
        flat=gj.flatten(uj),
    )
    ref = {k: np.asarray(a) for k, a in ref.items()}
    return dict(law=law, gt=gt, ft={k: _t(a) for k, a in f.items()},
                u=_t(u), v=_t(v), load=_t(load), ref=ref)


def test_grid3d_residual_energy_load(case):
    gt, ft, u, ref = case["gt"], case["ft"], case["u"], case["ref"]
    assert _rel(gt.residual(u, ft), ref["residual"]) <= 1e-12
    assert _rel(gt.load_residual(case["load"]), ref["load"]) <= 1e-12
    assert abs(float(gt.energy(u, ft)) - ref["energy"]) <= 1e-12 * abs(
        ref["energy"])
    assert np.array_equal(gt.flatten(u).numpy(), ref["flat"])
    assert torch.equal(gt.unflatten(gt.flatten(u)), u)


def test_grid3d_tangent_jvp_stencil_and_diagonal(case):
    """The JVP tangent and the stored 27-point stencil (``linearize``) both
    equal the reference's jvp of the residual; the diagonal equals the
    reference Jacobian's."""
    gt, ft, u, v, ref = (case[k] for k in ("gt", "ft", "u", "v", "ref"))
    jv = gt.tangent_action(u, ft, v)
    op = gt.operator(u, ft)
    assert _rel(jv, ref["tangent"]) <= 1e-12
    assert _rel(op(v), ref["tangent"]) <= 1e-12
    assert _rel(gt.diagonal(u, ft), ref["diagonal"]) <= 1e-12
    assert _rel(op.diagonal(), ref["diagonal"]) <= 1e-12
    # the whole operator: its application to every unit vector
    n = u.numel()
    eye = torch.eye(n, dtype=torch.float64).reshape(n, *u.shape)
    assert _rel(op(eye).reshape(n, n).T, ref["jacobian"]) <= 1e-12


def test_grid3d_constrained_operator_folds_dirichlet_rows(case):
    gt, ft, u, v = case["gt"], case["ft"], case["u"], case["v"]
    free = torch.ones_like(u)
    free[..., 0] = 0.0
    free[0, -1] = 0.0
    want = gt.tangent_action(u, ft, v * free) * free + v * (1.0 - free)
    A = gt.operator(u, ft, free)
    assert _rel(A(v), want) <= 1e-12
    vb = torch.stack([v, 2.0 * v])  # leading batch dimensions are kept
    assert _rel(A(vb)[1], 2.0 * want) <= 1e-12


def test_grid3d_cell_energy_matches_reference():
    gj, gt = _grids(2, 2, 2, "damaged", h=(0.3, 0.5, 0.7))
    rng = np.random.default_rng(5)
    u_e = 1e-3 * rng.standard_normal((8, 3))
    coeffs = {"d": rng.uniform(0, 1, 8), "k": 1.7}
    ref = gj._cell_energy_with_coeffs()(
        jnp.asarray(u_e), {k: jnp.asarray(a) for k, a in coeffs.items()})
    got = gt._cell_energy_with_coeffs()(
        _t(u_e), {k: _t(a) for k, a in coeffs.items()})
    assert abs(float(got) - float(ref)) <= 1e-12 * abs(float(ref))


def test_mg3d_prolong_restrict_exact_and_adjoint():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(3, 5, 7, 9))
    f = rng.normal(size=(3, 9, 13, 17))
    P = t_mg3.prolong(_t(c)).numpy()
    R = t_mg3.restrict(_t(f)).numpy()
    assert np.array_equal(P, np.asarray(j_mg3.prolong(jnp.asarray(c))))
    assert np.array_equal(R, np.asarray(j_mg3.restrict(jnp.asarray(f))))
    lhs, rhs = float((P * f).sum()), float((c * R).sum())
    assert abs(lhs - rhs) < 1e-12 * abs(lhs)


def test_mg3d_coarsening_matches_reference():
    _, gt = _grids(4, 6, 2, "damaged")
    gj, _ = _grids(4, 6, 2, "damaged")
    rng = np.random.default_rng(1)
    f = {"d": rng.uniform(0, 1, (3, 7, 5)), "k": rng.uniform(1, 2, (2, 6, 4))}
    want = j_mg3._coarsen_fields(gj, {k: jnp.asarray(a) for k, a in f.items()})
    got = t_mg3._coarsen_fields(gt, {k: _t(a) for k, a in f.items()})
    for k in f:
        assert _rel(got[k], want[k]) <= 1e-15
    gc = t_mg3.coarsen_grid(gt)
    assert (gc.nx, gc.ny, gc.nz, gc.hx, gc.hy, gc.hz) == (
        2, 3, 1, gt.hx * 2, gt.hy * 2, gt.hz * 2)


def test_mg3d_coarse_operator_is_galerkin():
    """Rediscretized coarse operator == P^T A P (nested Q1), from the
    port's stored stencils."""
    _, gf = _grids(4, 4, 2, "linear")
    gc = t_mg3.coarsen_grid(gf)
    sf, sc = (3, 3, 5, 5), (3, 2, 3, 3)
    nf, ncd = int(np.prod(sf)), int(np.prod(sc))
    Af = gf.operator(torch.zeros(sf, dtype=torch.float64), {})(
        torch.eye(nf, dtype=torch.float64).reshape(nf, *sf)).reshape(nf, nf).T
    Ac = gc.operator(torch.zeros(sc, dtype=torch.float64), {})(
        torch.eye(ncd, dtype=torch.float64).reshape(ncd, *sc)).reshape(
            ncd, ncd).T
    P = torch.stack([t_mg3.prolong(e.reshape(sc)).reshape(-1) for e in
                     torch.eye(ncd, dtype=torch.float64)]).T
    assert float((P.T @ Af @ P - Ac).abs().max()) < 1e-10 * float(
        Ac.abs().max())


@pytest.fixture
def bar8(monkeypatch):
    """An 8x8x8 pulled bar with one multigrid level above the dense coarse
    solve: the lattice (2187 dofs) is below ``mg3d.COARSE_DOFS``, which
    the fixture lowers to 1000 for the test."""
    monkeypatch.setattr(t_mg3, "COARSE_DOFS", 1000)
    n = 8
    _, gt = _grids(n, n, n, "linear")
    free = torch.ones((3, n + 1, n + 1, n + 1), dtype=torch.float64)
    free[..., 0] = 0.0
    free[..., -1] = 0.0
    return gt, free


def test_mg3d_vcycle_with_and_without_k8(bar8):
    """The hierarchy of an 8x8x8 pulled bar: levels, coarse size, and one
    V-cycle on the stored stencils against the same cycle with K8 (plain)
    overriding the level-0 smoother operator: equal to K8's float32
    rounding. The cycle is symmetric (CG needs it)."""
    gt, free = bar8
    grids, data = t_mg3.build_mg3d(gt, torch.zeros_like(free), {}, free)
    assert [g.nx for g in grids] == [8, 4] and len(data.levels) == 1
    assert data.coarse_inv.shape == (375, 375)
    rng = np.random.default_rng(4)
    b = _t(rng.standard_normal(free.shape)) * free
    c = _t(rng.standard_normal(free.shape)) * free
    z = t_mg3.vcycle(data, b)
    mv = [K3.make_linear_matvec(gt, E, NU)]
    z8 = t_mg3.vcycle(data, b, matvecs=mv)
    assert _rel(z8, z) <= 1e-5
    lhs = float((t_mg3.vcycle(data, c) * b).sum())
    rhs = float((z * c).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def test_mg3d_level_with_a_matvec_stores_no_stencil(bar8):
    """build_mg3d with a matvec factory (K8 plain on the fine level, None
    below): that level keeps no stencil, its inverse diagonal is the
    stored stencil's (rel <= 1e-12: grid.diagonal against the stencil's
    diagonal, sums in another order) and its lambda_max the power
    iteration's through K8 (rel <= 1e-5: K8 rounds to float32); the cycle
    on it equals the cycle on the stored data given the same matvec to
    that rounding. Without the matvec the cycle refuses that level."""
    gt, free = bar8
    u = torch.zeros_like(free)
    mv = K3.make_linear_matvec(gt, E, NU)
    _, data = t_mg3.build_mg3d(
        gt, u, {}, free, matvec_factory=lambda g: mv if g.nx == 8 else None)
    _, ref = t_mg3.build_mg3d(gt, u, {}, free)
    (lv,), (rl,) = data.levels, ref.levels
    assert lv.op is None and rl.op is not None
    assert _rel(lv.inv_d, rl.inv_d) <= 1e-12
    assert abs(lv.lmax - rl.lmax) <= 1e-5 * rl.lmax
    assert torch.equal(data.coarse_inv, ref.coarse_inv)
    b = _t(np.random.default_rng(5).standard_normal(free.shape)) * free
    z = t_mg3.vcycle(data, b, matvecs=[mv])
    assert _rel(z, t_mg3.vcycle(ref, b, matvecs=[mv])) <= 1e-5
    with pytest.raises(ValueError, match="stores no operator"):
        t_mg3.vcycle(data, b)
