"""The slice as a whole: the Jacobi Newton-Krylov solve of the polycrystal
elasto-damage problem in tpufem_torch against tpufem (CPU, float64).

Tier-1 compares engine-level solves on identical inputs: the same mesh,
damage field, per-grain modulus and load vector (numpy) go into
``LaneEngine.make_solver`` of both packages, the JAX engine with its
Pallas kernels in interpret mode. The comparison of the two full
``cases.polycrystal.run`` entry points is marked ``slow``.

Tolerances: same Newton count; per-Newton CG counts within +-1 (the exit
test compares a rounded residual with a tolerance); u rel <= 1e-9, energy
rel <= 1e-10, DG0 stress rel <= 1e-9 -- both solves stop at
newton_rtol = 1e-10, so what remains is rounding, amplified by the
conditioning of the damaged stiffness."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.cases.polycrystal as j_poly
import tpufem_torch.cases.polycrystal as t_poly
from tpufem.config import SolverConfig as JSolverConfig
from tpufem_torch.config import SolverConfig as TSolverConfig
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)
N, GRAINS, SMOOTH, WG_OWN = 16, 12, 4, 8
NU = 0.3
SOLVER = dict(cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=5000,
              newton_maxit=20, preconditioner="jacobi")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _inputs():
    """Host inputs shared by both packages (the port's host code is
    field-exact with the reference's, see test_torch_plan.py)."""
    from tpufem_torch.cases import mechanic2d
    from tpufem_torch.cases.damage import smooth_damage

    mesh = t_poly.generate_polycrystal(N, n_grains=GRAINS)
    E_cell = mechanic2d.young_modulus_range()[
        np.asarray(mesh.cell_tags, dtype=np.int64) % 200]
    d0 = np.zeros(mesh.n_nodes)
    d0[t_poly.damage_seed_nodes(mesh, n_chains=30)] = 1.0
    d = smooth_damage(mesh, d0, iterations=SMOOTH, backend="host")
    return mesh, d, E_cell


def _solve_jax(mesh_t, d, E_cell):
    from tpufem.assemble import Assembler
    from tpufem.cases import mechanic2d
    from tpufem.forms import EnergyFunctional, asym_damage_psi
    from tpufem.forms.form import Coefficient, Term
    from tpufem.lane import LaneEngine
    from tpufem.mesh.mesh import Mesh
    from tpufem.spaces import DirichletBC, FunctionSpace
    from tpufem.spaces.bc import locate_dofs_geometrical

    mesh = Mesh(x=mesh_t.x, cells=mesh_t.cells, cell_type=mesh_t.cell_type,
                cell_tags=mesh_t.cell_tags)
    V = FunctionSpace.create(mesh, 1, bs=2)
    DS = FunctionSpace.create(mesh, 1, bs=1)
    P0 = FunctionSpace.create(mesh, 0, bs=1)
    F = EnergyFunctional(
        V, [Term(lambda qp: asym_damage_psi(
            qp.eps, qp.coeff("d"), qp.coeff("E"), NU), 1)],
        [Coefficient("d", DS), Coefficient("E", P0)])
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [DirichletBC(V, left, [0.0, 0.0]),
           DirichletBC(V, right, [0.01, 0.0])]
    f_vec = jnp.asarray(mechanic2d.volumetric_load(V.dof_coords).reshape(-1))
    F_load = EnergyFunctional(
        V, [Term(lambda qp: -jnp.dot(qp.coeff("f"), qp.u), 2)],
        [Coefficient("f", V)])
    r_load = np.asarray(Assembler(F_load, []).residual(
        jnp.zeros(V.n_dofs), {"f": f_vec}))
    eng = LaneEngine(F, bcs, wg_own=WG_OWN, interpret=True)
    cc = eng.prepare_coeffs({"d": d, "E": E_cell})
    solve = eng.make_solver(
        JSolverConfig(**SOLVER), cg_chunk=200,
        const_residual=jnp.asarray(eng.plan.to_lane(r_load, 2)))
    u_lane, stats = solve(jnp.zeros_like(eng.bc_lane), cc)
    u = eng.from_lane(u_lane)
    asm = Assembler(F, bcs)
    coeffs = {"d": jnp.asarray(d), "E": jnp.asarray(E_cell)}
    energy = float(asm.energy(jnp.asarray(u), coeffs)) + float(r_load @ u)
    strain, stress, endens = mechanic2d.postprocess(
        asm, jnp.asarray(u), coeffs)
    return dict(u=u, stats=stats, energy=energy, stress=stress,
                strain=strain, r_load=r_load)


def _solve_torch(mesh, d, E_cell, r_load):
    from tpufem_torch.assemble import Assembler
    from tpufem_torch.cases import mechanic2d
    from tpufem_torch.forms import EnergyFunctional, asym_damage_psi
    from tpufem_torch.forms.form import Coefficient, Term
    from tpufem_torch.lane import LaneEngine
    from tpufem_torch.spaces import DirichletBC, FunctionSpace
    from tpufem_torch.spaces.bc import locate_dofs_geometrical
    from tpufem_torch.utils.convert import to_torch

    V = FunctionSpace.create(mesh, 1, bs=2)
    DS = FunctionSpace.create(mesh, 1, bs=1)
    P0 = FunctionSpace.create(mesh, 0, bs=1)
    F = EnergyFunctional(
        V, [Term(lambda qp: asym_damage_psi(
            qp.eps, qp.coeff("d"), qp.coeff("E"), NU), 1)],
        [Coefficient("d", DS), Coefficient("E", P0)], **F64)
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [DirichletBC(V, left, [0.0, 0.0]),
           DirichletBC(V, right, [0.01, 0.0])]
    f_vec = to_torch(mechanic2d.volumetric_load(V.dof_coords).reshape(-1),
                     **F64)
    F_load = EnergyFunctional(
        V, [Term(lambda qp: -torch.dot(qp.coeff("f"), qp.u), 2)],
        [Coefficient("f", V)], **F64)
    own_load = Assembler(F_load, []).residual(
        torch.zeros(V.n_dofs, dtype=torch.float64), {"f": f_vec}).numpy()
    eng = LaneEngine(F, bcs, wg_own=WG_OWN, **F64)
    cc = eng.prepare_coeffs({"d": d, "E": E_cell})
    solve = eng.make_solver(TSolverConfig(**SOLVER), cg_chunk=50,
                            const_residual=eng.to_lane(r_load))
    u_lane, stats = solve(torch.zeros_like(eng.bc_lane), cc)
    u = eng.from_lane(u_lane)
    asm = Assembler(F, bcs)
    coeffs = {"d": to_torch(d, **F64), "E": to_torch(E_cell, **F64)}
    ut = to_torch(u, **F64)
    energy = float(asm.energy(ut, coeffs)) + float(r_load @ u)
    lane_energy = float(eng.cell_energies(u_lane, cc).sum()) + float(
        r_load @ u)
    strain, stress, endens = mechanic2d.postprocess(asm, ut, coeffs)
    return dict(u=u, stats=stats, energy=energy, lane_energy=lane_energy,
                stress=stress, strain=strain, own_load=own_load)


@pytest.fixture(scope="module")
def solves():
    mesh, d, E_cell = _inputs()
    ref = _solve_jax(mesh, d, E_cell)
    got = _solve_torch(mesh, d, E_cell, ref["r_load"])
    return ref, got


def test_load_vector_matches(solves):
    ref, got = solves
    assert _rel(got["own_load"], ref["r_load"]) <= 1e-12


def test_solve_converges_with_same_iteration_counts(solves):
    ref, got = solves
    sj, st = ref["stats"], got["stats"]
    assert sj["converged"] and st["converged"]
    assert st["newton_iters"] == sj["newton_iters"]
    assert len(st["cg_iters"]) == len(sj["cg_iters"])
    assert all(abs(a - b) <= 1 for a, b in zip(st["cg_iters"],
                                               sj["cg_iters"]))
    assert abs(st["r0"] - sj["r0"]) <= 1e-12 * sj["r0"]


def test_solution_matches(solves):
    ref, got = solves
    assert _rel(got["u"], ref["u"]) <= 1e-9


def test_energy_matches(solves):
    ref, got = solves
    assert abs(got["energy"] - ref["energy"]) <= 1e-10 * abs(ref["energy"])
    # the lane engine's own per-cell energies give the same total
    assert abs(got["lane_energy"] - got["energy"]) <= 1e-12 * abs(
        got["energy"])


def test_dg0_fields_match(solves):
    ref, got = solves
    assert got["stress"].shape == ref["stress"].shape
    assert _rel(got["stress"], ref["stress"]) <= 1e-9
    assert _rel(got["strain"], ref["strain"]) <= 1e-9


@pytest.mark.slow
def test_full_run_matches_reference_run():
    """Both ``cases.polycrystal.run`` entry points, unloaded (the
    reference assembles its load vector in float32 even under x64, which
    caps a loaded comparison at ~1e-7)."""
    kw = dict(n_grains=GRAINS, smooth_iters=SMOOTH, use_volume=False)
    rj = j_poly.run(N, solver=JSolverConfig(**SOLVER), interpret=True, **kw)
    rt = t_poly.run(N, solver=TSolverConfig(**SOLVER), **F64, **kw)
    assert rj.stats["converged"] and rt.stats["converged"]
    assert rt.stats["newton_iters"] == rj.stats["newton_iters"]
    assert _rel(rt.u_flat, rj.u_flat) <= 1e-9
    assert abs(rt.energy - rj.energy) <= 1e-10 * abs(rj.energy)
    assert _rel(rt.stress, rj.stress) <= 1e-9


def test_jacobi_run_takes_the_reference_cg_chunk():
    """``run`` under Jacobi against the reference's ``run`` (float64; the
    reference's Pallas kernels in interpret mode; unloaded, since the
    reference assembles its load vector in float32 even under x64): the
    same Newton count, per-step CG counts within +-1 and u rel <= 1e-9.

    Both take CG chunks of 200 iterations under Jacobi
    (tpufem/cases/polycrystal.py:319). The stall guard reads chunk ends and
    gives up after 4 chunks in a row without progress, so a stalling CG
    now stops after the reference's 800 iterations, not 200. No small
    float64 case stalls -- this one converges in under 100 CG iterations
    per step even at cg_rtol 1e-17 -- so the chunk is pinned through the
    port's ``stats["cg_enqueued"]``: one chunk of 200 per Newton step
    (two of 50 with the old default)."""
    kw = dict(n_grains=4, smooth_iters=2, use_volume=False,
              postprocess_fields=False)
    cfg = dict(cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=1000,
               newton_maxit=20, preconditioner="jacobi")
    ref = j_poly.run(8, interpret=True, solver=JSolverConfig(
        error_on_nonconvergence=False, **cfg), **kw)
    got = t_poly.run(8, solver=TSolverConfig(**cfg), **F64, **kw)
    sj, st = ref.stats, got.stats
    assert sj["converged"] and st["converged"]
    assert st["newton_iters"] == sj["newton_iters"]
    assert len(st["cg_iters"]) == len(sj["cg_iters"])
    assert all(abs(a - b) <= 1 for a, b in zip(st["cg_iters"],
                                               sj["cg_iters"]))
    assert all(0 < k < 200 for k in st["cg_iters"])
    assert st["cg_enqueued"] == [200] * len(st["cg_iters"])
    assert _rel(got.u_flat, ref.u_flat) <= 1e-9
