"""``polycrystal.run(mixed=True)`` of tpufem_torch against tpufem's (CPU, the
reference with x64 on and its Pallas kernels in interpret mode; the port's
float32 engine on the CPU, through the kernels' plain versions), and the
``--mixed`` flag of the CLI. The engine-level mixed solver is held against
the reference's in test_torch_mixed.py.

Tolerances: against the reference's ``run``, u and energy rel <= 1e-10
(both solve to newton_rtol 1e-10). The ``slow`` twins of
tests/test_polycrystal.py:153-239 hold the mixed run against the port's
float64 lane solve: rel < 1e-10 unloaded, < 2e-7 loaded (the reference's
own bounds)."""

import numpy as np
import pytest
import torch

import tpufem_torch.cases.polycrystal as t_poly
from tpufem.config import SolverConfig as JSolverConfig
from tpufem_torch.config import SolverConfig as TSolverConfig
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_run_mixed_matches_reference():
    """``polycrystal.run(mixed=True)`` (float64 load, functional, energy
    and DG0 fields; float32 engine) against the reference's, Jacobi, both
    to newton_rtol 1e-10; the CLI has ``--mixed``."""
    import tpufem.cases.polycrystal as j_poly

    kw = dict(n_grains=4, smooth_iters=2, use_volume=False, mixed=True)
    cfg = dict(cg_rtol=1e-6, newton_rtol=1e-10, cg_maxit=5000,
               newton_maxit=30, preconditioner="jacobi")
    ref = j_poly.run(8, interpret=True, solver=JSolverConfig(
        error_on_nonconvergence=False, **cfg), **kw)
    got = t_poly.run(8, solver=TSolverConfig(**cfg), **CPU, **kw)
    assert ref.stats["converged"] and got.stats["converged"]
    assert _rel(got.u_flat, ref.u_flat) <= 1e-10
    assert abs(got.energy - ref.energy) <= 1e-10 * abs(ref.energy)
    assert got.u_flat.dtype == np.float64 and got.stress.dtype == np.float64
    assert np.abs(got.stress - ref.stress).max() <= 1e-8 * np.abs(
        ref.stress).max()

    from tpufem_torch.cli import build_parser

    ap = build_parser()
    assert ap.parse_args(["polycrystal", "--mixed"]).mixed
    assert not ap.parse_args(["polycrystal"]).mixed


def _run_pair(n, **kw):
    """The port's twins of the reference's slow polycrystal tests: the
    float64 lane solve (the gold) and the mixed solve, both to
    newton_rtol 1e-10 (tests/test_polycrystal.py:153-239)."""
    base = dict(n_grains=12, smooth_iters=4, **CPU, **kw)
    gold = t_poly.run(n, dtype=torch.float64, solver=TSolverConfig(
        cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=5000, newton_maxit=20,
        preconditioner="jacobi"), **base)
    mixed = t_poly.run(n, mixed=True, solver=TSolverConfig(
        cg_rtol=1e-6, newton_rtol=1e-10, cg_maxit=5000, newton_maxit=30,
        preconditioner="jacobi"), **base)
    assert gold.stats["converged"] and mixed.stats["converged"]
    return gold, mixed


@pytest.mark.slow
def test_run_mixed_unloaded_lands_on_the_float64_root():
    gold, mixed = _run_pair(20, use_volume=False)
    assert _rel(mixed.u_flat, gold.u_flat) < 1e-10
    assert abs(mixed.energy - gold.energy) < 1e-10 * abs(gold.energy)


@pytest.mark.slow
def test_run_mixed_loaded_consistent():
    gold, mixed = _run_pair(16)
    assert _rel(mixed.u_flat, gold.u_flat) < 2e-7
    assert abs(mixed.energy - gold.energy) < 1e-5 * abs(gold.energy)
