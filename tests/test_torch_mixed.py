"""The mixed-precision solver of tpufem_torch (``LaneEngine.make_mixed_solver``
and its checkpoints) against tpufem's (CPU, the
reference with x64 on and its Pallas kernels in interpret mode; the port's
inner solves in float32 on the CPU, through the kernels' plain versions).

The engine-level fixture is tests/test_lane.py's ``_problem(n=10)``: a unit
square, a damaged band, x clamped, u_x = 0.01 at x = 1, wg_own = 8, the
reference's settings (cg_rtol 1e-8, newton_rtol 1e-10). The float64 root
is the port's float64 lane solve (cg_rtol 1e-12), itself held against the
reference's in test_torch_engine.py.

Tolerances: each mixed solve reaches the float64 root to rel <= 1e-10
(the reference's own bound for its mixed solves); the two packages agree
in the Newton count within 1 and in u to rel <= 1e-9 (float32 inner CG,
different rounding); a resumed checkpoint lands on the uninterrupted
solve's root to rel <= 1e-9. ``run(mixed=True)`` is held against the
reference's in test_torch_mixed_run.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.config import SolverConfig as JSolverConfig
from tpufem_torch.config import SolverConfig as TSolverConfig
from tpufem_torch.lane import LaneEngine as TLaneEngine
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
N, WG_OWN = 10, 8
CPU = dict(device="cpu")
CFG = dict(cg_rtol=1e-8, newton_rtol=1e-10, cg_maxit=4000, newton_maxit=30)
# the reference's callers' chunks
CHUNK = {"jacobi": 200, "twolevel": 20, "amg": 200}
# amg: a coarse size small enough for levels on this mesh (242 dofs)
PC_CFG = {"amg": dict(amg_coarse_size=32)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _problem(pkg):
    """tests/test_lane.py's _problem(n=10) in either package (float64)."""
    if pkg == "jax":
        from tpufem.forms import EnergyFunctional, asym_damage_psi
        from tpufem.forms.form import Coefficient, Term
        from tpufem.mesh import unit_square
        from tpufem.spaces import DirichletBC, FunctionSpace
        from tpufem.spaces.bc import locate_dofs_geometrical
        kw = {}
    else:
        from tpufem_torch.forms import EnergyFunctional, asym_damage_psi
        from tpufem_torch.forms.form import Coefficient, Term
        from tpufem_torch.mesh import unit_square
        from tpufem_torch.spaces import DirichletBC, FunctionSpace
        from tpufem_torch.spaces.bc import locate_dofs_geometrical
        kw = dict(dtype=torch.float64, **CPU)
    mesh = unit_square(N)
    V = FunctionSpace.create(mesh, 1, bs=2)
    DS = FunctionSpace.create(mesh, 1, bs=1)
    d = np.zeros(DS.n_dofs)
    d[(DS.dof_coords[:, 1] > 0.45) & (DS.dof_coords[:, 1] < 0.55)] = 0.8
    t = Term(lambda qp: asym_damage_psi(qp.eps, qp.coeff("d"), E, NU), 1)
    F = EnergyFunctional(V, [t], [Coefficient("d", DS)], **kw)
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [DirichletBC(V, left, [0.0, 0.0]),
           DirichletBC(V, right, [0.01, 0.0])]
    return F, bcs, V, d


@pytest.fixture(scope="module")
def port():
    F, bcs, V, d = _problem("torch")
    e64 = TLaneEngine(F, bcs, wg_own=WG_OWN, dtype=torch.float64, **CPU)
    u, st = e64.make_solver(TSolverConfig(
        cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=4000, newton_maxit=20))(
        torch.zeros_like(e64.bc_lane), e64.prepare_coeffs({"d": d}))
    assert st["converged"]
    return dict(F=F, bcs=bcs, V=V, d=d, gold=e64.from_lane(u))


def _port_mixed(port, pc, **kw):
    eng = TLaneEngine(port["F"], port["bcs"], wg_own=WG_OWN,
                      dtype=torch.float32, **CPU)
    cfg = TSolverConfig(preconditioner=pc, **CFG, **PC_CFG.get(pc, {}))
    solve = eng.make_mixed_solver(cfg, cg_chunk=CHUNK[pc], **kw)
    d = port["d"]
    u, st = solve(torch.zeros(port["V"].n_dofs, dtype=torch.float64),
                  {"d": d}, eng.prepare_coeffs({"d": d}))
    return u.numpy(), st


@pytest.mark.parametrize("pc", ["jacobi", "twolevel", "amg"])
def test_mixed_solver_matches_reference(port, pc):
    """The reference's make_mixed_solver on its float32-stored engine, the
    port's on a float32 engine: both on the float64 root, and alike. Under
    amg the hierarchy (float32 levels) has two levels or more."""
    from tpufem.lane import LaneEngine as JLaneEngine

    Fj, bj, Vj, d = _problem("jax")
    ej = JLaneEngine(Fj, bj, wg_own=WG_OWN, interpret=True,
                     store_dtype=np.float32)
    cj = {"d": jnp.asarray(d)}
    uj, sj = ej.make_mixed_solver(
        JSolverConfig(preconditioner=pc, error_on_nonconvergence=False,
                      **CFG, **PC_CFG.get(pc, {})), cg_chunk=CHUNK[pc])(
        jnp.zeros(Vj.n_dofs, dtype=jnp.float64), cj, ej.prepare_coeffs(cj))
    ut, st = _port_mixed(port, pc)
    assert sj["converged"] and st["converged"]
    assert set(sj) <= set(st)  # the reference's statistics, and more
    assert set(st["phase_s"]) == set(sj["phase_s"])
    assert _rel(np.asarray(uj), port["gold"]) <= 1e-10
    assert _rel(ut, port["gold"]) <= 1e-10
    assert abs(st["newton_iters"] - sj["newton_iters"]) <= 1
    assert _rel(ut, np.asarray(uj)) <= 1e-9
    assert st["final_residual"] < 1e-10 * st["r0"]
    assert st["r0"] == pytest.approx(sj["r0"], rel=1e-12)
    assert len(st["residuals"]) == st["newton_iters"] + 1
    if pc != "jacobi":
        assert st["phase_s"]["tl_setup"] > 0.0
    if pc == "amg":
        assert len(st["amg"]["levels"]) >= 3
        assert set(st["amg"]["setup_s"]) == {"matrix", "to_host",
                                             "hierarchy", "upload"}


def test_mixed_checkpoint_resumes_onto_the_same_root(port, tmp_path,
                                                    monkeypatch):
    """A solve that crashes in its second Newton step leaves the
    checkpoint of the first; a fresh solver with the same configuration
    resumes after that step and lands on the uninterrupted solve's root;
    the converged solve deletes the file. (The crash is an exception in
    the second CG solve: the fingerprint hashes newton_maxit too, so a
    first run stopped by newton_maxit = 1 would not be resumed.)"""
    import tpufem_torch.lane.engine as t_engine
    from tpufem_torch.io import load_checkpoint

    ckpt = str(tmp_path / "mixed.ckpt.npz")
    u_gold, s_gold = _port_mixed(port, "jacobi")
    assert s_gold["converged"] and s_gold["newton_iters"] >= 2
    pcg, calls = t_engine._chunked_pcg, []

    def crash_in_step_2(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("crash")
        return pcg(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(t_engine, "_chunked_pcg", crash_in_step_2)
        with pytest.raises(RuntimeError, match="crash"):
            _port_mixed(port, "jacobi", checkpoint_path=ckpt)
    ck = load_checkpoint(ckpt)
    assert int(ck["it"]) == 1
    assert int(ck["total_cg"]) == s_gold["cg_iters"][0]
    u_res, s_res = _port_mixed(port, "jacobi",
                               checkpoint_path=ckpt)
    assert s_res["converged"]
    assert s_res["newton_iters"] == s_gold["newton_iters"]
    assert s_res["cg_iters"] == s_gold["cg_iters"][1:]
    assert _rel(u_res, u_gold) <= 1e-9
    assert not (tmp_path / "mixed.ckpt.npz").exists()


def _scaled(d):
    return 0.5 * d


def _last_entry(d):
    d2 = d.copy()
    d2[-1] = 0.3
    return d2


@pytest.mark.parametrize("change", [_scaled, _last_entry],
                         ids=["scaled", "last_entry"])
def test_mixed_checkpoint_of_another_problem_is_ignored(port, tmp_path,
                                                        capsys, change):
    """A checkpoint written for other coefficients (same shapes: all of d
    scaled, or only its last entry changed) has another fingerprint: the
    solve starts afresh instead of resuming."""
    ckpt = str(tmp_path / "mixed.ckpt.npz")
    eng = TLaneEngine(port["F"], port["bcs"], wg_own=WG_OWN,
                      dtype=torch.float32, **CPU)
    d = port["d"]
    d2 = change(d)
    u0 = torch.zeros(port["V"].n_dofs, dtype=torch.float64)
    eng.make_mixed_solver(TSolverConfig(**dict(CFG, newton_maxit=1)),
                          cg_chunk=200, checkpoint_path=ckpt)(
        u0, {"d": d}, eng.prepare_coeffs({"d": d}))
    capsys.readouterr()
    solve = eng.make_mixed_solver(TSolverConfig(**CFG), cg_chunk=200,
                                  checkpoint_path=ckpt)
    u, st = solve(u0, {"d": d2}, eng.prepare_coeffs({"d": d2}))
    assert "different problem/config fingerprint" in capsys.readouterr().out
    fresh, sf = eng.make_mixed_solver(TSolverConfig(**CFG), cg_chunk=200)(
        u0, {"d": d2}, eng.prepare_coeffs({"d": d2}))
    assert st["converged"] and st["cg_iters"] == sf["cg_iters"]
    assert torch.equal(u, fresh)


def test_mixed_fingerprint_hashes_whole_arrays():
    """Two coefficient vectors that differ only past their first MiB (a
    damage field at n = 1024 holds about 8 MB) give two fingerprints; the
    same arrays give the same one, as a tensor or as an array."""
    from tpufem_torch.lane.engine import _fingerprint

    cfg = (2, "jacobi")
    d = np.random.default_rng(0).random(1 << 18)  # 2 MiB of float64
    d2 = d.copy()
    d2[-1] += 1.0
    assert _fingerprint(cfg, {"d": d}) != _fingerprint(cfg, {"d": d2})
    assert _fingerprint(cfg, {"d": d}) == _fingerprint(
        cfg, {"d": torch.as_tensor(d)})
    assert _fingerprint(cfg, {"d": d}) != _fingerprint((3, "jacobi"),
                                                       {"d": d})


def test_mixed_solver_refuses_what_it_cannot_do(port):
    """block_jacobi is refused (the reference runs Jacobi for it without
    a word); a float32 functional cannot give the float64 outer
    residual."""
    eng = TLaneEngine(port["F"], port["bcs"], wg_own=WG_OWN,
                      dtype=torch.float32, **CPU)
    with pytest.raises(ValueError, match="without a word"):
        eng.make_mixed_solver(TSolverConfig(preconditioner="block_jacobi"))
    from tpufem_torch.forms import EnergyFunctional

    f32 = EnergyFunctional(port["F"].space, port["F"].terms,
                           port["F"].coefficients, dtype=torch.float32,
                           **CPU)
    with pytest.raises(ValueError, match="float64"):
        TLaneEngine(f32, port["bcs"], wg_own=WG_OWN, **CPU
                    ).make_mixed_solver()
