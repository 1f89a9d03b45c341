"""tpufem_torch device code against tpufem (CPU, float64, same numpy
inputs through both): the flat Assembler and LaneEngine(fused=False) on the damage problem of
tests/test_lane.py -- the JAX engine runs its Pallas kernels in interpret
mode, the port's wrappers take their plain versions because the tensors
lie on the CPU.

Tolerance: rel <= 1e-12 for assembled quantities (sums over cells in a
different order)."""

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
from tpufem.assemble import Assembler as JAssembler
from tpufem.lane import LaneEngine as JLaneEngine
from tpufem_torch.assemble import Assembler as TAssembler
from tpufem_torch.config import SolverConfig
from tpufem_torch.lane import LaneEngine as TLaneEngine
from tpufem_torch.utils.convert import (lane_plan_fields,
                                        lane_plan_from_numpy, to_torch)
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
F64 = dict(device="cpu", dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# -- (d) assembler and lane engine on the damage problem ----------------------


def _problem(pkg, n=24):
    """The `_problem(24)` set-up of tests/test_lane.py in either package."""
    if pkg == "jax":
        mesh_m, sp, bc, forms, form, kw = (j_mesh, j_spaces, j_bc, j_forms,
                                           j_form, {})
    else:
        mesh_m, sp, bc, forms, form, kw = (t_mesh, t_spaces, t_bc, t_forms,
                                           t_form, F64)
    mesh = mesh_m.unit_square(n)
    V = sp.FunctionSpace.create(mesh, 1, bs=2)
    DS = sp.FunctionSpace.create(mesh, 1, bs=1)
    d = np.zeros(DS.n_dofs)
    d[(DS.dof_coords[:, 1] > 0.45) & (DS.dof_coords[:, 1] < 0.55)] = 0.8
    t = form.Term(
        lambda qp: forms.asym_damage_psi(qp.eps, qp.coeff("d"), E, NU), 1)
    F = form.EnergyFunctional(V, [t], [form.Coefficient("d", DS)], **kw)
    left = bc.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = bc.locate_dofs_geometrical(
        V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [sp.DirichletBC(V, left, [0.0, 0.0]),
           sp.DirichletBC(V, right, [0.01, 0.0])]
    return F, bcs, V, d


@pytest.fixture(scope="module")
def setup():
    Fj, bj, Vj, d = _problem("jax")
    Ft, bt, Vt, _ = _problem("torch")
    rng = np.random.default_rng(7)
    u = 1e-3 * rng.standard_normal(Vj.n_dofs)
    v = rng.standard_normal(Vj.n_dofs)
    return dict(Fj=Fj, bj=bj, Ft=Ft, bt=bt, d=d, u=u, v=v)


@pytest.fixture(scope="module")
def flat(setup):
    s = setup
    aj, at = JAssembler(s["Fj"], s["bj"]), TAssembler(s["Ft"], s["bt"])
    cj = {"d": jnp.asarray(s["d"])}
    ct = {"d": to_torch(s["d"], **F64)}
    uj, vj = jnp.asarray(s["u"]), jnp.asarray(s["v"])
    ut, vt = to_torch(s["u"], **F64), to_torch(s["v"], **F64)
    ref = dict(
        r=np.asarray(aj.residual(uj, cj)),
        jv=np.asarray(aj.tangent_action(uj, cj, vj)),
        diag=np.asarray(aj.diagonal(uj, cj)),
        energy=float(aj.energy(uj, cj)),
    )
    got = dict(
        r=at.residual(ut, ct).numpy(),
        jv=at.tangent_action(ut, ct, vt).numpy(),
        diag=at.diagonal(ut, ct).numpy(),
        energy=float(at.energy(ut, ct)),
        r_batched=at.residual(ut, ct, batch=500).numpy(),
        energy_batched=float(at.energy(ut, ct, batch=500)),
    )
    return ref, got


@pytest.mark.parametrize("what", ["r", "jv", "diag"])
def test_assembler_matches_jax(flat, what):
    ref, got = flat
    assert _rel(got[what], ref[what]) <= 1e-12


def test_assembler_energy_and_slabs(flat):
    ref, got = flat
    assert abs(got["energy"] - ref["energy"]) <= 1e-12 * abs(ref["energy"])
    assert _rel(got["r_batched"], got["r"]) <= 1e-14
    assert abs(got["energy_batched"] - got["energy"]) <= 1e-13 * abs(
        got["energy"])


def test_elementwise_element_energy_matches_matrix_form(setup, flat):
    """The scalarized element energy (every contraction unrolled) is the
    same function as the matrix-product one the Assembler uses."""
    s = setup
    at = TAssembler(s["Ft"], s["bt"])
    at._energy_fn = s["Ft"].element_energy_fn_elementwise()
    r = at.residual(to_torch(s["u"], **F64), {"d": to_torch(s["d"], **F64)})
    assert _rel(r.numpy(), flat[1]["r"]) <= 1e-13


@pytest.fixture(scope="module")
def lane(setup, flat):
    s = setup
    ej = JLaneEngine(s["Fj"], s["bj"], wg_own=8, interpret=True)
    ccj = ej.prepare_coeffs({"d": s["d"]})
    ulj, vlj = ej.to_lane(s["u"]), ej.to_lane(s["v"])
    ref = dict(
        r=ej.from_lane(ej.residual(ulj, ccj)),
        jv=ej.from_lane(ej.tangent_action(ulj, ccj, vlj)),
        diag=ej.from_lane(ej.diagonal(ulj, ccj)),
    )
    # own plan, and the reference's plan handed over as numpy
    et = TLaneEngine(s["Ft"], s["bt"], wg_own=8, **F64)
    et2 = TLaneEngine(
        s["Ft"], s["bt"], plan=lane_plan_from_numpy(lane_plan_fields(ej.plan)),
        **F64)
    return ref, et, et2


@pytest.mark.parametrize("which", ["own_plan", "reference_plan"])
@pytest.mark.parametrize("what", ["r", "jv", "diag", "jv_linearized"])
def test_lane_engine_matches_jax(setup, flat, lane, which, what):
    s = setup
    ref, et, et2 = lane
    eng = et if which == "own_plan" else et2
    cc = eng.prepare_coeffs({"d": s["d"]})
    ul, vl = eng.to_lane(s["u"]), eng.to_lane(s["v"])
    if what == "r":
        out = eng.residual(ul, cc)
    elif what == "jv":
        out = eng.tangent_action(ul, cc, vl)
    elif what == "jv_linearized":  # the closure the CG iteration applies
        out = eng.make_tangent(ul, cc)(vl)
    else:
        out = eng.diagonal(ul, cc)
    key = "jv" if what == "jv_linearized" else what
    got = eng.from_lane(out)
    assert _rel(got, ref[key]) <= 1e-12
    # and against the flat path of both packages
    assert _rel(got, flat[1][key] if key != "diag" else ref[key]) <= 1e-12
    # copy slots carry their owners' values
    assert torch.equal(eng.refresh_copies(out), out)
    assert torch.equal(eng.to_lane_dev(eng.from_lane_dev(out)), out)


def test_lane_engine_with_rare_copy_tail():
    """A jittered polycrystal plan has a rare-copy tail (copies outside the
    dense pass kernels): the gather-sum tables must give the same residual
    as the flat assembler, with consistent copies."""
    import tpufem_torch.cases.polycrystal as t_poly

    mesh = t_poly.generate_polycrystal(48, n_grains=12)
    V = t_spaces.FunctionSpace.create(mesh, 1, bs=2)
    t = t_form.Term(lambda qp: t_forms.linear_elastic_psi(qp.eps, E, NU), 1)
    F = t_form.EnergyFunctional(V, [t], **F64)
    eng = TLaneEngine(F, [], wg_own=16, **F64)
    assert eng._tail_copy is not None and len(eng._tail_copy) > 0
    u = 1e-3 * np.random.default_rng(3).standard_normal(V.n_dofs)
    r_lane = eng.residual(eng.to_lane(u), {})
    r_flat = TAssembler(F, []).residual(to_torch(u, **F64), {}).numpy()
    assert _rel(eng.from_lane(r_lane), r_flat) <= 1e-12
    assert torch.equal(eng.refresh_copies(r_lane), r_lane)
    assert torch.equal(eng.to_lane(eng.from_lane(r_lane)), r_lane)


def test_cg_exit_does_not_depend_on_chunk(setup):
    """The tolerance is tested every iteration on the device: the exit
    iteration and the iterate are the same for any ``cg_chunk``."""
    s = setup
    eng = TLaneEngine(s["Ft"], s["bt"], wg_own=8, **F64)
    cc = eng.prepare_coeffs({"d": s["d"]})
    cfg = SolverConfig(cg_rtol=1e-8, newton_maxit=2, cg_maxit=400,
                       preconditioner="jacobi")
    outs = []
    for chunk in (7, 100):
        u, st = eng.make_solver(cfg, cg_chunk=chunk)(
            torch.zeros_like(eng.bc_lane), cc)
        outs.append((u, st))
    assert outs[0][1]["cg_iters"] == outs[1][1]["cg_iters"]
    assert all(0 < k < 400 for k in outs[0][1]["cg_iters"])
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1]["residuals"] == outs[1][1]["residuals"]


# -- what is not ported raises ------------------------------------------------


def test_unported_paths_raise(setup):
    """The fused engine and its law; the preconditioners the lane solvers
    do not run raise ValueError (the reference runs Jacobi for them
    without a word): 'amg' and 'block_jacobi' in make_solver (so in a
    lane-only run), 'block_jacobi' in make_mixed_solver; 'amg' builds in
    make_mixed_solver and in the flat solver, which refuses it without
    the assembled matrix."""
    s = setup
    # the fused engine is ported: it builds and knows its hand-written law
    eng = TLaneEngine(s["Ft"], s["bt"], wg_own=8, fused=True, **F64)
    assert eng.fused_law.name == "asym_damage"
    import tpufem_torch.cases.polycrystal as t_poly

    with pytest.raises(ValueError, match="without a word"):
        t_poly.run(8, solver=SolverConfig(preconditioner="amg"), **F64)
    for pc in ("amg", "block_jacobi"):
        with pytest.raises(ValueError, match="without a word"):
            eng.make_solver(SolverConfig(preconditioner=pc))
    with pytest.raises(ValueError, match="fine_coeffs"):
        eng.make_solver(SolverConfig(preconditioner="twolevel"))
    with pytest.raises(ValueError, match="without a word"):
        eng.make_mixed_solver(SolverConfig(preconditioner="block_jacobi"))
    eng.make_mixed_solver(SolverConfig(preconditioner="amg"))
    from tpufem_torch.nls import make_newton_solver

    asm = TAssembler(s["Ft"], s["bt"])
    make_newton_solver(asm, SolverConfig(preconditioner="amg"))
    with pytest.raises(ValueError, match="use_matrix"):
        make_newton_solver(asm, SolverConfig(preconditioner="amg"),
                           use_matrix=False)


def test_default_device_is_cuda_and_absent_cuda_raises(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TLaneEngine(setup["Ft"], setup["bt"])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_form.EnergyFunctional(setup["Ft"].space, setup["Ft"].terms)
