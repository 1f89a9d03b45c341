"""The structured lattice kernels of tpufem_torch (K6 / K7:
``structured.kernels2d``; K8: ``structured.kernels3d``) against tpufem
(CPU; the same numpy inputs through both).

On the CPU every wrapper runs its plain version; these tests hold the
plain versions against the reference, and ``chip_smoke.py`` holds the
CUDA kernels against the plain versions on the card.

Tolerances: K6 / K7 plain against the Pallas kernels in interpret mode
rel <= 2e-6 / 5e-6 (float32 on both sides; the reference sums whole
rolled slabs, its interpreter may contract or reorder products); the
hand-derived stress JVP against ``torch.func.jvp`` rel <= 1e-12 (float64);
the K8 cell matrix and stencil constants exactly equal (the same NumPy
float64 code); K8 plain against the reference's AD tangent rel <= 5e-6
(float32 constants and sums against float64 AD)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from torch.func import hessian, jvp

import tpufem.structured.pallas2d as p2d
import tpufem.structured.pallas3d as p3d
import tpufem_torch.forms as t_forms
from tpufem.forms import linear_elastic_psi as j_linear
from tpufem.structured.grid3d import StructuredGrid3D as JGrid3D
from tpufem_torch.structured import kernels2d as K2
from tpufem_torch.structured import kernels3d as K3
from tpufem_torch.structured.grid3d import StructuredGrid3D as TGrid3D
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
SHAPES = [(13, 9), (16, 16), (7, 30), (40, 12)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(p2d.pl, "pallas_call", interp)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _lattice_inputs(nx, ny, seed=0):
    """float32 state (whole rows of cells at exactly zero strain, so the
    degenerate branch runs), direction, damage in [0, 1)."""
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=(2, ny + 1, nx + 1)) * 1e-3).astype(np.float32)
    u[:, : (ny + 1) // 4] = 0.0
    v = rng.normal(size=(2, ny + 1, nx + 1)).astype(np.float32)
    d = rng.uniform(0, 1, (ny + 1, nx + 1)).astype(np.float32)
    return u, v, d


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_residual_plain_matches_pallas(nx, ny):
    u, _v, d = _lattice_inputs(nx, ny)
    ref = p2d.make_residual_kernel(nx, ny, 1 / nx, 1 / ny, E, NU,
                                   block_rows=8)(jnp.asarray(u),
                                                 jnp.asarray(d))
    res = K2.make_residual_kernel(nx, ny, 1 / nx, 1 / ny, E, NU)
    got = res(torch.as_tensor(u), torch.as_tensor(d))
    assert got.dtype == torch.float32 and got.shape == u.shape
    assert _rel(got, ref) <= 2e-6


@pytest.mark.parametrize("nx,ny", SHAPES)
def test_tangent_plain_matches_pallas(nx, ny):
    u, v, d = _lattice_inputs(nx, ny, seed=1)
    ref = p2d.make_tangent_kernel(nx, ny, 1 / nx, 1 / ny, E, NU,
                                  block_rows=8)(
        jnp.asarray(u), jnp.asarray(d), jnp.asarray(v))
    jv = K2.make_tangent_kernel(nx, ny, 1 / nx, 1 / ny, E, NU)
    got = jv(torch.as_tensor(u), torch.as_tensor(d), torch.as_tensor(v))
    assert _rel(got, ref) <= 5e-6


def test_phys_grads_exactly_equal():
    for hx, hy in ((1 / 13, 1 / 9), (0.1, 0.37)):
        want, got = p2d._phys_grads(hx, hy), K2._phys_grads(hx, hy)
        for tag in ("lo", "up"):
            assert np.array_equal(got[tag][0], want[tag][0])
            assert got[tag][0].dtype == np.float32
            assert got[tag][1] == want[tag][1]


def test_stress_matches_reference():
    """The port's elementwise stress and its JVP against the reference's
    pallas2d._stress / _stress_jvp (float64, degenerate points included)."""
    lam, mu = (float(v) for v in t_forms.lame_parameters(E, NU))
    rng = np.random.default_rng(2)
    e = rng.normal(size=(3, 500)) * 1e-3
    t = rng.normal(size=(3, 500)) * 1e-3
    e[:, :20] = 0.0  # zero strain
    e[2, 20:40] = 0.0
    e[1, 20:40] = e[0, 20:40]  # spherical strain: delta == 0
    d = rng.uniform(0, 1, 500)
    ref_s = p2d._stress(*map(jnp.asarray, (*e, d)), lam, mu)
    ref_t = p2d._stress_jvp(*map(jnp.asarray, (*e, *t, d)), lam, mu)
    got_s = K2._stress(*map(torch.as_tensor, (*e, d)), lam, mu)
    got_t = K2._stress_jvp(*map(torch.as_tensor, (*e, *t, d)), lam, mu)
    for g, r in zip(got_s + got_t, ref_s + ref_t):
        assert _rel(g, r) <= 1e-12


def test_stress_jvp_matches_autodiff():
    """``_stress_jvp`` is the directional derivative of ``_stress``:
    against ``torch.func.jvp`` of the port's stress, float64, off the
    coalescent set."""
    lam, mu = (float(v) for v in t_forms.lame_parameters(E, NU))
    rng = np.random.default_rng(3)
    e = torch.as_tensor(rng.normal(size=(3, 2000)) * 1e-3)
    t = torch.as_tensor(rng.normal(size=(3, 2000)) * 1e-3)
    d = torch.as_tensor(rng.uniform(0, 1, 2000))
    _s, ad = jvp(lambda a, b, c: K2._stress(a, b, c, d, lam, mu),
                 tuple(e), tuple(t))
    hand = K2._stress_jvp(*e, *t, d, lam, mu)
    for h, a in zip(hand, ad):
        assert _rel(h, a) <= 1e-12


def test_lattice_kernels_zero_state_and_uniform_strain():
    """u = 0 gives r = 0; a uniform strain state (linear ramp in x) is in
    equilibrium inside: the residual lives on the clamped columns."""
    nx = ny = 16
    res = K2.make_residual_kernel(nx, ny, 1 / nx, 1 / ny, E, NU)
    d = torch.full((ny + 1, nx + 1), 0.5)
    assert float(res(torch.zeros((2, ny + 1, nx + 1)), d).abs().max()) == 0.0
    u = torch.zeros((2, ny + 1, nx + 1))
    u[0] = torch.linspace(0, 0.01, nx + 1)[None, :]
    r = res(u, torch.zeros_like(d))
    assert float(r[:, 1:-1, 1:-1].abs().max()) < 1e-3 * float(r.abs().max())


def _grid3d(G, forms_linear, nx=9, ny=7, nz=11, h=(0.1, 0.2, 0.15)):
    return G(nx=nx, ny=ny, nz=nz, hx=h[0], hy=h[1], hz=h[2], bs=3,
             energy_density=lambda g, c: forms_linear(0.5 * (g + g.T), E, NU),
             field_kinds={})


def test_cell_matrix_and_stencil_constants_exactly_equal():
    gj = _grid3d(JGrid3D, j_linear, 3, 3, 3, (0.11, 0.23, 0.31))
    gt = _grid3d(TGrid3D, t_forms.linear_elastic_psi, 3, 3, 3,
                 (0.11, 0.23, 0.31))
    Kj, Kt = p3d._cell_matrix(gj, E, NU), K3._cell_matrix(gt, E, NU)
    assert np.array_equal(Kt, Kj)
    sj, st = p3d._stencil_constants(Kj), K3._stencil_constants(Kt)
    assert list(sj) == list(st)
    for delta in sj:
        assert [c for c, _ in sj[delta]] == [c for c, _ in st[delta]]
        for (_, a), (_, b) in zip(sj[delta], st[delta]):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    # the analytic matrix is the Hessian of the port's cell energy
    energy = gt._cell_energy_with_coeffs()
    H = hessian(lambda w: energy(w, {}))(torch.zeros((8, 3),
                                                     dtype=torch.float64))
    assert _rel(H.numpy(), Kt) <= 1e-14


def test_linear_matvec_plain_matches_reference_tangent():
    """K8 (plain) on an anisotropic 9x7x11 lattice against the reference's
    AD tangent of the lattice residual, boundary incidence included."""
    gj = _grid3d(JGrid3D, j_linear)
    gt = _grid3d(TGrid3D, t_forms.linear_elastic_psi)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 12, 8, 10)).astype(np.float32)
    ref = gj.tangent_action(jnp.zeros(x.shape), {}, jnp.asarray(x, jnp.float64))
    mv = K3.make_linear_matvec(gt, E, NU)
    got = mv(torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got, ref) <= 5e-6
    # float64 in, float64 out, float32 inside
    got64 = mv(torch.as_tensor(x, dtype=torch.float64))
    assert got64.dtype == torch.float64
    assert torch.equal(got64, got.to(torch.float64))
    # the port's stored stencil of the same grid
    st = gt.operator(torch.zeros(x.shape, dtype=torch.float64), {})(
        torch.as_tensor(x, dtype=torch.float64))
    assert _rel(got, st) <= 5e-6


def test_linear_matvec_serves_linear_elasticity_only():
    gt = _grid3d(TGrid3D, t_forms.linear_elastic_psi, 3, 3, 3)
    with pytest.raises(NotImplementedError, match="explicit E and nu"):
        K3.make_linear_matvec(gt)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K3.make_linear_matvec(gt, 2.0 * E, NU)  # another modulus
    damaged = TGrid3D(
        nx=3, ny=3, nz=3, hx=1 / 3, hy=1 / 3, hz=1 / 3, bs=3,
        energy_density=lambda g, c: (1 - 0.5 * c["d"])
        * t_forms.linear_elastic_psi(0.5 * (g + g.T), E, NU),
        field_kinds={"d": "vertex"})
    with pytest.raises(NotImplementedError, match="coefficient fields"):
        K3.make_linear_matvec(damaged, E, NU)


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    K2.reset_launch_counts()
    K3.reset_launch_counts()
    nx, ny = 5, 4
    u, v, d = map(torch.as_tensor, _lattice_inputs(nx, ny))
    k = K2.LatticeConsts(nx, ny, 1 / nx, 1 / ny, E, NU)
    assert torch.equal(K2.lattice_residual(u, d, k), K2.residual_plain(u, d, k))
    assert torch.equal(K2.lattice_tangent(u, d, v, k),
                       K2.tangent_plain(u, d, v, k))
    gt = _grid3d(TGrid3D, t_forms.linear_elastic_psi, 3, 2, 4)
    c3 = K3.make_linear_matvec(gt, E, NU).consts
    x = torch.randn((3, 5, 3, 4))
    assert torch.equal(K3.lattice_matvec3d(x, c3),
                       K3.linear_matvec_plain(x, c3))
    assert set(K2.launch_counts().values()) == {0}
    assert set(K3.launch_counts().values()) == {0}
    assert len(c3.terms) == K3.N_TERMS == 64
    assert len(bytes(k.packed())) == 16 * 4
    assert len(bytes(c3.packed())) == 64 * 9 * 4
