"""tpufem_torch.cases.polycrystal.run and the CLI on the CPU (float64):
the port's own entry points end to end at a tiny size (by default the
fused engine with the two-level preconditioner, as in the reference),
what they refuse for now, and that nothing runs on the CPU unless it was
asked to."""

import numpy as np
import pytest
import torch

import tpufem_torch.cases.polycrystal as t_poly
from tpufem_torch.config import SolverConfig as TSolverConfig
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)


def test_run_entry_point_small():
    """The port's own ``run`` end to end on the CPU: converges, fields are
    finite, and sum(sigma:eps * area) = 2 * strain energy (the law is
    positively homogeneous of degree 2)."""
    res = t_poly.run(
        12, n_grains=6, smooth_iters=4, use_volume=False,
        solver=TSolverConfig(cg_rtol=1e-10, cg_maxit=2000), **F64)
    assert res.stats["converged"]
    assert np.isfinite(res.energy) and res.energy_stiff > 0
    v = res.mesh.x[res.mesh.cells]
    area = 0.5 * np.abs(
        (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
        - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1]))
    assert res.strain.shape == (len(res.mesh.cells), 3)
    assert np.isfinite(res.stress).all()
    np.testing.assert_allclose(float(res.energy_density @ area),
                               2.0 * res.energy_stiff, rtol=1e-6)
    uu = res.u_flat.reshape(-1, 2)
    right = np.abs(res.mesh.x[:, 0] - 1) < 1e-9
    np.testing.assert_allclose(uu[right, 0], 0.01, atol=1e-12)
    np.testing.assert_allclose(uu[np.abs(res.mesh.x[:, 0]) < 1e-9], 0.0,
                               atol=1e-12)


def test_run_fused_entry_point_matches_staged():
    """``run(fused=True)`` (the default) and ``run(fused=False)`` with the
    CLI's ``--fused`` / ``--no-fused``: the same Jacobi solve through the
    fused element kernel's plain version and through the staged pipeline
    -- same Newton count, CG counts within +-1 (the exit test compares a
    rounded residual with a tolerance), u rel <= 1e-9 (float64)."""
    kw = dict(n_grains=6, smooth_iters=4, use_volume=False,
              postprocess_fields=False,
              solver=TSolverConfig(cg_rtol=1e-10, cg_maxit=2000), **F64)
    mesh = t_poly.generate_polycrystal(12, n_grains=6)
    staged = t_poly.run(12, mesh=mesh, fused=False, **kw)
    fused = t_poly.run(12, mesh=mesh, **kw)
    assert fused.stats["converged"]
    assert fused.stats["newton_iters"] == staged.stats["newton_iters"]
    assert all(abs(a - b) <= 1 for a, b in zip(fused.stats["cg_iters"],
                                               staged.stats["cg_iters"]))
    assert np.abs(fused.u_flat - staged.u_flat).max() <= 1e-9 * np.abs(
        staged.u_flat).max()
    assert abs(fused.energy - staged.energy) <= 1e-10 * abs(staged.energy)

    from tpufem_torch.cli import build_parser

    ap = build_parser()
    assert ap.parse_args(["polycrystal", "-n", "8"]).fused
    assert ap.parse_args(["polycrystal", "-n", "8", "--fused"]).fused
    assert not ap.parse_args(["polycrystal", "-n", "8", "--no-fused"]).fused


def test_run_defaults_to_fused_twolevel_like_the_reference():
    """``run``'s defaults are the reference's: the fused engine and CG
    preconditioned by the two-level cycle (cg_chunk 20), with its set-up
    as a row of the phase table. It reaches the Jacobi solution with far
    fewer CG iterations; the CLI's ``--pc`` defaults to twolevel."""
    import inspect

    sig = inspect.signature(t_poly.run)
    assert sig.parameters["fused"].default is True
    kw = dict(n_grains=6, smooth_iters=4, use_volume=False,
              postprocess_fields=False, **F64)
    mesh = t_poly.generate_polycrystal(12, n_grains=6)
    tl = t_poly.run(12, mesh=mesh, solver=TSolverConfig(
        cg_rtol=1e-10, cg_maxit=2000, preconditioner="twolevel"), **kw)
    jac = t_poly.run(12, mesh=mesh, solver=TSolverConfig(
        cg_rtol=1e-10, cg_maxit=2000, preconditioner="jacobi"), **kw)
    assert tl.stats["converged"] and jac.stats["converged"]
    assert tl.stats["newton_iters"] == jac.stats["newton_iters"]
    assert np.abs(tl.u_flat - jac.u_flat).max() <= 1e-9 * np.abs(
        jac.u_flat).max()
    assert 3 * tl.stats["total_cg_iters"] < jac.stats["total_cg_iters"]
    assert "7.3.1 two-level set-up (in 7.3)" in tl.timings
    assert "7.3.1 two-level set-up (in 7.3)" not in jac.timings

    from tpufem_torch.cli import build_parser

    ap = build_parser()
    assert ap.parse_args(["polycrystal", "-n", "8"]).pc == "twolevel"
    assert ap.parse_args(["polycrystal", "--pc", "jacobi"]).pc == "jacobi"


@pytest.mark.parametrize("kw,exc,match", [
    # fused, twolevel and mixed are ported; a preconditioner the lane
    # solver does not have is not, under the mixed solver neither (staged
    # or fused engine); a checkpoint belongs to the mixed solve
    (dict(fused=True, solver=TSolverConfig(preconditioner="amg")),
     NotImplementedError, "ROADMAP"),
    (dict(mixed=True, solver=TSolverConfig(preconditioner="amg")),
     NotImplementedError, "ROADMAP"),
    (dict(checkpoint_path="x"), ValueError, "mixed=True"),
    (dict(mixed=True, fused=False, solver=TSolverConfig(
        preconditioner="amg")), NotImplementedError, "ROADMAP"),
], ids=["fused", "mixed", "checkpoint_path", "twolevel"])
def test_run_unported_options_raise(kw, exc, match):
    with pytest.raises(exc, match=match):
        t_poly.run(8, n_grains=4, smooth_iters=2, use_volume=False,
                   postprocess_fields=False, **F64, **kw)


# one call of both packages' ``run`` with the gmsh round trip and the
# output phase: unloaded (the reference assembles its load in float32
# even under x64), Jacobi, one Newton step of two CG iterations -- enough
# to fill every field; the reference's Pallas kernels run in interpret
# mode, whose first compile dominates
ROUNDTRIP = dict(n_grains=4, smooth_iters=2, use_volume=False,
                 gmsh_roundtrip=True)
ROUNDTRIP_SOLVER = dict(preconditioner="jacobi", cg_maxit=2, newton_maxit=1)


@pytest.fixture(scope="module")
def roundtrip_runs(tmp_path_factory):
    import tpufem.cases.polycrystal as j_poly
    from tpufem.config import SolverConfig as JSolverConfig

    out = tmp_path_factory.mktemp("poly")
    for sub in ("t", "j"):
        (out / sub).mkdir()
    t = t_poly.run(8, output_path=str(out / "t" / "poly.xdmf"),
                   solver=TSolverConfig(**ROUNDTRIP_SOLVER), **ROUNDTRIP,
                   **F64)
    j = j_poly.run(8, output_path=str(out / "j" / "poly.xdmf"),
                   solver=JSolverConfig(error_on_nonconvergence=False,
                                        **ROUNDTRIP_SOLVER),
                   interpret=True, **ROUNDTRIP)
    return t, j, out


def test_run_gmsh_roundtrip(roundtrip_runs):
    """The mesh after the port's round trip is the reference's (which
    writes 16 significant digits and so moves x by up to 4 ulps, at a
    mantissa just above a power of ten; the port's writes 17 and gives the
    mesh back exactly), and the run is bit for bit the run without the
    round trip."""
    t, j, _ = roundtrip_runs
    np.testing.assert_array_equal(t.mesh.cells, j.mesh.cells)
    np.testing.assert_array_equal(t.mesh.cell_tags, j.mesh.cell_tags)
    assert t.mesh.cells.dtype == j.mesh.cells.dtype
    assert sorted(t.mesh.entity_tags) == sorted(j.mesh.entity_tags)
    np.testing.assert_array_max_ulp(t.mesh.x, j.mesh.x, maxulp=4)
    assert "2.1b gmsh roundtrip" in t.timings
    kw = {**ROUNDTRIP, "gmsh_roundtrip": False}
    plain = t_poly.run(8, solver=TSolverConfig(**ROUNDTRIP_SOLVER), **kw,
                       **F64)
    np.testing.assert_array_equal(t.mesh.x, plain.mesh.x)
    np.testing.assert_array_equal(t.u_flat, plain.u_flat)
    assert t.energy == plain.energy
    for name in ("strain", "stress", "energy_density"):
        np.testing.assert_array_equal(getattr(t, name), getattr(plain, name))


def test_run_output_path_writes_the_reference_s_xdmf(roundtrip_runs):
    """The XDMF of ``output_path`` is the reference's for the same call
    (mesh, field names and layout: the same XML), and its fields read back
    to the run's own result exactly (to the reference's values at the run
    tolerance)."""
    from tpufem_torch.io import read_xdmf

    t, j, out = roundtrip_runs
    xml = (out / "t" / "poly.xdmf").read_text()
    assert xml == (out / "j" / "poly.xdmf").read_text()
    mesh, pd, cd = read_xdmf(str(out / "t" / "poly.xdmf"))
    np.testing.assert_array_equal(mesh.x, t.mesh.x)
    np.testing.assert_array_equal(mesh.cells, t.mesh.cells)
    np.testing.assert_array_equal(pd["u"][:, :2].reshape(-1), t.u_flat)
    fields = dict(E=None, grain=t.mesh.cell_tags.astype(np.float64),
                  strain=t.strain, stress=t.stress,
                  energy_density=t.energy_density)
    assert sorted(cd) == sorted(fields) and sorted(pd) == ["damage", "u"]
    for name, want in fields.items():
        if want is not None:
            np.testing.assert_array_equal(cd[name].reshape(want.shape), want)
    assert np.abs(pd["u"][:, :2].reshape(-1) - j.u_flat).max() <= (
        1e-9 * np.abs(j.u_flat).max())
    assert "8 outputs" in t.timings


def test_cli_runs_on_cpu_and_refuses_missing_cuda(capsys):
    from tpufem_torch.cli import main

    rc = main(["--device", "cpu", "--x64", "polycrystal", "-n", "8",
               "--grains", "4", "--smooth-iters", "2", "--cg-rtol", "1e-8",
               "--rel", "1e-6"])
    out = capsys.readouterr().out
    assert rc == 0 and "7.3 nonlinear resolution" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["polycrystal", "-n", "8"])
