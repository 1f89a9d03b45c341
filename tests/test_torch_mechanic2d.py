"""The reference study's own workload in the port, ``cases/mechanic2d``
``setup`` / ``run``, against tpufem on the CPU (float64): the set-up
fields exactly, the Dirichlet helpers of the flat ``Assembler``, CG and
Newton, whole runs (traction, compression, one refinement, P2) with their
output phase, what is not ported, and the phase names."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpufem.cases.mechanic2d as j_mech
import tpufem.config as j_config
import tpufem.la as j_la
import tpufem.nls as j_nls
import tpufem_torch.cases.mechanic2d as t_mech
import tpufem_torch.config as t_config
import tpufem_torch.la as t_la
import tpufem_torch.nls as t_nls
from tpufem.io.xdmf import read_xdmf as j_read_xdmf
from tpufem.perf import PHASES as J_PHASES
from tpufem_torch.io import read_xdmf
from tpufem_torch.perf import PHASES as T_PHASES
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def configs(**kw):
    """The same Mechanic2DConfig in both packages (the reference's
    SolverConfig defaults)."""
    return t_config.Mechanic2DConfig(**kw), j_config.Mechanic2DConfig(**kw)


def assert_same_run(t, j):
    """Same Newton count, CG +-1 per step, u rel <= 1e-9, energy rel <=
    1e-10, DG0 strain / stress rel <= 1e-9."""
    assert t.newton_iterations == j.newton_iterations
    assert len(t.krylov_iters) == len(j.krylov_iters)
    assert all(abs(a - b) <= 1 for a, b in zip(t.krylov_iters,
                                               j.krylov_iters))
    assert rel(t.u.numpy(), j.u) <= 1e-9
    assert abs(t.energy.sum() - j.energy.sum()) <= 1e-10 * abs(
        j.energy.sum())
    assert rel(t.strain, j.strain) <= 1e-9
    assert rel(t.stress, j.stress) <= 1e-9


@pytest.fixture(scope="module")
def runs_r0(tmp_path_factory):
    """The default workload (r = 0, traction) in both packages, each
    writing its output phase."""
    out = tmp_path_factory.mktemp("mech")
    t_cfg, j_cfg = configs()
    t_cfg.output_dir, j_cfg.output_dir = str(out / "t"), str(out / "j")
    return t_mech.run(t_cfg, **F64), j_mech.run(j_cfg), out


@pytest.mark.parametrize("r", [0, 2, 3])
def test_setup_fields_exactly_equal(r):
    """Mesh, damage, modulus, load vector and Dirichlet dofs and values.
    From r = 3 on (3 233 nodes) the damage takes the Neper tag list."""
    t_cfg, j_cfg = configs(max_refine=r)
    t_asm, tc, tV, tmesh, _ = t_mech.setup(t_cfg, **F64)
    j_asm, jc, jV, jmesh, _ = j_mech.setup(j_cfg)
    assert (tmesh.n_nodes >= 1000) == (r == 3)
    np.testing.assert_array_equal(tmesh.cells, jmesh.cells)
    np.testing.assert_array_equal(tV.dof_coords, jV.dof_coords)
    for name in ("d", "E", "f"):
        assert tc[name].dtype == torch.float64
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]),
                                      err_msg=name)
    assert tc["d"].numpy().max() == 1.0
    np.testing.assert_array_equal(t_asm.bc_dofs.numpy(),
                                  np.asarray(j_asm.bc_dofs))
    np.testing.assert_array_equal(t_asm.bc_vals_np, j_asm.bc_vals_np)
    np.testing.assert_array_equal(t_asm.bc_values(torch.float64).numpy(),
                                  np.asarray(j_asm.bc_values(jnp.float64)))


def test_dirichlet_helpers_match_reference():
    """lifted_rhs, constrained_action (from the element matrices),
    element_action against the reference's jvp tangent_action, set_bc and
    diagonal at a seeded state: rel <= 1e-12."""
    t_cfg, j_cfg = configs()
    t_asm, tc, tV, _, _ = t_mech.setup(t_cfg, **F64)
    j_asm, jc, _, _, _ = j_mech.setup(j_cfg)
    rng = np.random.default_rng(11)
    u = 1e-3 * rng.standard_normal(tV.n_dofs)
    v = rng.standard_normal(tV.n_dofs)
    ut, vt, uj, vj = (torch.from_numpy(u), torch.from_numpy(v),
                      jnp.asarray(u), jnp.asarray(v))
    em = t_asm.element_matrices(ut, tc)
    # the reference's helpers under jit, as its run calls them
    j_act = jax.jit(lambda a, w, c, x: a.constrained_action(w, c)(x))
    want = np.asarray(j_act(j_asm, uj, jc, vj))
    assert rel(t_asm.constrained_action(ut, tc, em)(vt).numpy(),
               want) <= 1e-12
    j_tan = jax.jit(lambda a, w, c, x: a.tangent_action(w, c, x))
    assert rel(t_asm.element_action(em, vt).numpy(),
               np.asarray(j_tan(j_asm, uj, jc, vj))) <= 1e-12
    j_rhs = jax.jit(lambda a, w, c: a.lifted_rhs(w, c))
    assert rel(t_asm.lifted_rhs(ut, tc).numpy(),
               np.asarray(j_rhs(j_asm, uj, jc))) <= 1e-12
    j_diag = jax.jit(lambda a, w, c: a.diagonal(w, c))
    assert rel(t_asm.diagonal(ut, tc).numpy(),
               np.asarray(j_diag(j_asm, uj, jc))) <= 1e-12
    np.testing.assert_array_equal(t_asm.diagonal(ut, tc, em).numpy(),
                                  t_asm.diagonal(ut, tc).numpy())
    np.testing.assert_array_equal(t_asm.set_bc(ut).numpy(),
                                  np.asarray(j_asm.set_bc(uj)))
    assert np.array_equal(ut.numpy(), u)  # set_bc leaves its input alone


def _spd(n, seed):
    """A well-conditioned SPD matrix (eigenvalues in about [1, 5]) with a
    varied diagonal, and a right-hand side."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n))
    A = q @ q.T / n + np.diag(1.0 + rng.random(n))
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("kw", [dict(rtol=1e-10), dict(rtol=1e-14, maxit=8),
                                dict(rtol=0.0, atol=1e-6)],
                         ids=["rtol", "maxit", "atol"])
def test_cg_matches_reference_chunked_or_not(kw):
    """Jacobi CG on an SPD system: the reference's iteration count and x
    (rel <= 1e-12), whatever the chunk (1 = the unchunked loop)."""
    A, b = _spd(60, 3)
    d = np.diag(A).copy()
    ref = j_la.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                  M=j_la.jacobi_preconditioner(jnp.asarray(d)), **kw)
    At, dt = torch.from_numpy(A), torch.from_numpy(d)
    for chunk in (1, 7, 50):
        got = t_la.cg(lambda v: At @ v, torch.from_numpy(b),
                      M=t_la.jacobi_preconditioner(dt), chunk=chunk, **kw)
        assert got.iters == int(ref.iters), chunk
        assert got.converged == bool(ref.converged)
        assert rel(got.x.numpy(), ref.x) <= 1e-12
        # the final residual is at the level of rounding: held to |b|
        assert abs(got.residual_norm - float(ref.residual_norm)) <= (
            1e-13 * np.linalg.norm(b))


def _cubic_problem(mod, array):
    """F(u) = K u + u^3 - f: Newton callbacks built from ``mod``'s own
    arrays (the reference's and the port's Newton run the same system)."""
    K, f = _spd(30, 5)
    K, f = array(K), array(3.0 * f)
    return dict(
        rhs=lambda u: f - K @ u - u ** 3,
        operator=lambda u: (lambda v: K @ v + 3.0 * u * u * v),
    )


@pytest.mark.parametrize("convergence", ["r0", "du0"])
def test_newton_conventions_match_reference(convergence):
    kw = dict(convergence=convergence, cg_rtol=1e-12, newton_rtol=1e-9,
              newton_atol=0.0)
    ref = j_nls.NewtonSolver(j_config.SolverConfig(**kw)).solve(
        jnp.zeros(30), **_cubic_problem(j_nls, jnp.asarray))
    got = t_nls.NewtonSolver(t_config.SolverConfig(**kw)).solve(
        torch.zeros(30, dtype=torch.float64),
        **_cubic_problem(t_nls, torch.from_numpy))
    assert got.converged and ref.converged
    assert got.iterations == ref.iterations >= 3
    assert all(abs(a - b) <= 1 for a, b in zip(got.krylov_iters,
                                               ref.krylov_iters))
    np.testing.assert_allclose(got.residual_norms, ref.residual_norms,
                               rtol=1e-6, atol=1e-9)
    assert rel(got.u.numpy(), ref.u) <= 1e-10


def test_newton_nonconvergence():
    kw = dict(newton_maxit=1, newton_rtol=1e-12, newton_atol=0.0)
    with pytest.raises(t_nls.NonConvergenceError, match="1 iterations"):
        t_nls.NewtonSolver(t_config.SolverConfig(**kw)).solve(
            torch.zeros(30, dtype=torch.float64),
            **_cubic_problem(t_nls, torch.from_numpy))
    res = t_nls.NewtonSolver(t_config.SolverConfig(
        error_on_nonconvergence=False, **kw)).solve(
        torch.zeros(30, dtype=torch.float64),
        **_cubic_problem(t_nls, torch.from_numpy))
    assert not res.converged and res.iterations == 1


def test_run_r0_matches_reference(runs_r0):
    t, j, _ = runs_r0
    assert_same_run(t, j)
    assert t.krylov_iters == [63, 62, 63, 63, 64]
    uu = t.u.numpy().reshape(-1, 2)
    right = np.abs(t.V.dof_coords[:, 0] - 1) < 1e-9
    np.testing.assert_array_equal(uu[right, 0], 0.01)


@pytest.mark.parametrize("kw", [dict(use_trac=False), dict(max_refine=1),
                                dict(degree=2)],
                         ids=["compression", "r1", "p2"])
def test_run_matches_reference(kw):
    t_cfg, j_cfg = configs(**kw)
    t, j = t_mech.run(t_cfg, **F64), j_mech.run(j_cfg)
    assert_same_run(t, j)
    assert t.V.element.degree == kw.get("degree", 1)


def test_output_phase_reads_back(runs_r0):
    """The VTU and the XDMF / HDF5 files of '8 Outputs': the port's XDMF
    reads back to its own fields exactly, and to the reference's at the
    run tolerances; the VTU is the reference's but for the solution's
    last digits."""
    t, j, out = runs_r0
    mesh, pd, cd = read_xdmf(str(out / "t" / "mechanic2d.xdmf"))
    jmesh, jpd, jcd = j_read_xdmf(str(out / "j" / "mechanic2d.xdmf"))
    np.testing.assert_array_equal(mesh.x, jmesh.x)
    np.testing.assert_array_equal(mesh.cells, jmesh.cells)
    assert sorted(pd) == sorted(jpd) == ["d", "u"]
    assert sorted(cd) == sorted(jcd) == ["E", "energy", "strain", "stress"]
    np.testing.assert_array_equal(pd["u"][:, :2].reshape(-1), t.u.numpy())
    np.testing.assert_array_equal(pd["d"], t.d.numpy())
    np.testing.assert_array_equal(cd["E"], t.E_cell.numpy())
    for name, field in (("strain", t.strain), ("stress", t.stress),
                        ("energy", t.energy)):
        np.testing.assert_array_equal(cd[name].reshape(field.shape), field)
    np.testing.assert_array_equal(pd["d"], jpd["d"])
    np.testing.assert_array_equal(cd["E"], jcd["E"])
    for name in ("strain", "stress", "energy"):
        assert rel(cd[name], jcd[name]) <= 1e-9
    assert rel(pd["u"], jpd["u"]) <= 1e-9
    vtu = (out / "t" / "mechanic2d.vtu").read_text()
    jvtu = (out / "j" / "mechanic2d.vtu").read_text()
    assert vtu.split("<PointData>")[0] == jvtu.split("<PointData>")[0]
    assert t.timers.elapsed["8 Outputs"] > 0


def test_phase_names_are_the_reference_s(runs_r0):
    t, j, _ = runs_r0
    assert T_PHASES == J_PHASES
    assert t.timers.phases == j.timers.phases
    assert t.timers.report().splitlines()[0] == j.timers.report(
    ).splitlines()[0]


@pytest.mark.parametrize("pc", ["amg", "block_jacobi", "chebyshev", "none"])
def test_unported_preconditioners_raise(pc):
    cfg = t_config.Mechanic2DConfig(
        solver=t_config.SolverConfig(preconditioner=pc))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_mech.run(cfg, **F64)


def test_config_and_device_rules():
    """use_trac clears use_ecst as in the reference; a lane preconditioner
    is refused; without a device argument the run asks for CUDA."""
    assert not t_config.Mechanic2DConfig(use_ecst=True).use_ecst
    assert t_config.Mechanic2DConfig(use_ecst=True, use_trac=False).use_ecst
    with pytest.raises(ValueError, match="jacobi"):
        t_mech.run(t_config.Mechanic2DConfig(
            solver=t_config.SolverConfig(preconditioner="twolevel")), **F64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_mech.run(t_config.Mechanic2DConfig())
