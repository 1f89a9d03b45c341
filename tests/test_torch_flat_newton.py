"""The flat Newton-Krylov layer of tpufem_torch against tpufem's (CPU,
float64): the sparsity pattern (exactly equal tables), the assembled ELL
Jacobian, the SFC / RCM reorderings (exactly equal), the power iteration
and the Chebyshev preconditioner, the neo-Hookean energy and its Hessian,
``make_newton_solver`` (assembled and matrix-free; Jacobi, Chebyshev,
none; r0 and du0), the chunked solver and its checkpoint, and
``evaluate_expression`` / ``Function``.

Tolerances: host tables exactly equal; float64 device values rel <=
1e-12; solves the same Newton count, |d total_cg_iters| <= newton_iters,
u rel <= 1e-9. Each reference solve is run once (a module-scoped cache),
most of its cost the reference compiling its solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.assemble.pattern as j_pattern
import tpufem.config as j_config
import tpufem.la.precond as j_precond
import tpufem.mesh.reorder as j_reorder
import tpufem.nls.newton_chunked as j_chunked
import tpufem.nls.newton_jit as j_jit
import tpufem_torch.assemble.pattern as t_pattern
import tpufem_torch.config as t_config
import tpufem_torch.la.precond as t_precond
import tpufem_torch.mesh.reorder as t_reorder
import tpufem_torch.nls as t_nls
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
F64 = dict(device="cpu", dtype=torch.float64)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pkg(pkg):
    """The modules of either package that build a problem."""
    if pkg == "jax":
        import tpufem.assemble as A
        import tpufem.forms as F
        import tpufem.forms.form as FF
        import tpufem.mesh as M
        import tpufem.spaces as S
        import tpufem.spaces.bc as B
        kw = {}
    else:
        import tpufem_torch.assemble as A
        import tpufem_torch.forms as F
        import tpufem_torch.forms.form as FF
        import tpufem_torch.mesh as M
        import tpufem_torch.spaces as S
        import tpufem_torch.spaces.bc as B
        kw = F64
    return A, F, FF, M, S, B, kw


def damage_problem(pkg, n=6):
    """tests/test_precond.py::test_chunked_solver_matches_jit's problem at
    n: an SFC-ordered unit square, damage 0.4 above y = 0.6, x clamped,
    u_x = 0.01 at x = 1 (asymmetric damage: a nonlinear Newton)."""
    A, F, FF, M, S, B, kw = _pkg(pkg)
    reorder = j_reorder if pkg == "jax" else t_reorder
    mesh = reorder.sfc_reorder(M.unit_square(n))
    V = S.FunctionSpace.create(mesh, 1, bs=2)
    DS = S.FunctionSpace.create(mesh, 1, bs=1)
    d = np.zeros(DS.n_dofs)
    d[DS.dof_coords[:, 1] > 0.6] = 0.4
    t = FF.Term(lambda qp: F.asym_damage_psi(qp.eps, qp.coeff("d"), E, NU), 1)
    fn = F.EnergyFunctional(V, [t], [FF.Coefficient("d", DS)], **kw)
    left = B.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = B.locate_dofs_geometrical(
        V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    asm = A.Assembler(fn, [S.DirichletBC(V, left, [0.0, 0.0]),
                           S.DirichletBC(V, right, [0.01, 0.0])])
    coeffs = {"d": (jnp.asarray(d) if pkg == "jax"
                    else torch.as_tensor(d, dtype=torch.float64))}
    return asm, coeffs, V


def neohookean_box(pkg):
    """A neo-Hookean box(2, 2, 2) of hexes (2x2x2 points), x = 0 clamped
    and x = 1 pulled by 0.1."""
    A, F, FF, M, S, B, kw = _pkg(pkg)
    V = S.FunctionSpace.create(M.box(2, 2, 2), 1, bs=3)
    t = FF.Term(lambda qp: F.neo_hookean_psi(qp.grad_u, E, NU), 2)
    left = B.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = B.locate_dofs_geometrical(
        V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    return A.Assembler(F.EnergyFunctional(V, [t], **kw), [
        S.DirichletBC(V, left, [0.0] * 3),
        S.DirichletBC(V, right, [0.1, 0.0, 0.0])]), V


def matrix(asm, u):
    """``asm.matrix(u, {})``; the reference's under jit, as its solvers
    call it (eagerly it dispatches every small op of the Hessian)."""
    if isinstance(u, torch.Tensor):
        return asm.matrix(u, {})
    asm.pattern
    return jax.jit(lambda a, w: a.matrix(w, {}))(asm, u)


def elastic_system(pkg, n):
    """tests/test_precond.py:27-37's system: an SFC-ordered unit square,
    linear elasticity, x = 0 clamped, the ELL matrix at u = 0 and a
    seeded right-hand side on the free dofs."""
    A, F, FF, M, S, B, kw = _pkg(pkg)
    reorder = j_reorder if pkg == "jax" else t_reorder
    V = S.FunctionSpace.create(reorder.sfc_reorder(M.unit_square(n)), 1,
                               bs=2)
    left = B.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    t = FF.Term(lambda qp: F.linear_elastic_psi(qp.eps, E, NU), 1)
    asm = A.Assembler(F.EnergyFunctional(V, [t], **kw),
                      [S.DirichletBC(V, left, [0.0, 0.0])])
    b = np.random.default_rng(0).normal(size=V.n_dofs)
    if pkg == "jax":
        mat = matrix(asm, jnp.zeros(V.n_dofs))
        return asm, mat, jnp.asarray(b) * asm.free_mask(jnp.float64)
    mat = matrix(asm, torch.zeros(V.n_dofs, dtype=torch.float64))
    return asm, mat, torch.as_tensor(b) * asm.free_mask(torch.float64)


# -- pattern, matrix, reordering ------------------------------------------------


@pytest.mark.parametrize("which", ["unit_square(4)", "box(2, 2, 2)"])
def test_pattern_tables_exactly_equal(which):
    from tpufem_torch.mesh import box, unit_square
    from tpufem_torch.spaces import FunctionSpace

    mesh, bs = ((unit_square(4), 2) if which == "unit_square(4)"
                else (box(2, 2, 2), 3))
    V = FunctionSpace.create(mesh, 1, bs=bs)
    dm = V.vector_dofmap()
    j = j_pattern.SparsityPattern.from_dofmap(dm, V.n_dofs)
    t = t_pattern.SparsityPattern.from_dofmap(dm, V.n_dofs)
    for f in ("n_rows", "n_cols", "nnz", "ell_width"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("rows", "cols", "perm", "sorted_slots", "ell_cols",
              "ell_slots"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.ell_width == (14 if bs == 2 else 81)  # 7 or 27 nodes a row
    # the nnz plan, built by torch's sort, equals the host table
    from tpufem_torch.assemble.scatter import GatherSumPlan

    es = np.empty(len(t.perm), np.int64)
    es[t.perm] = t.sorted_slots
    nc, nd = dm.shape
    slots_T = es.reshape(nc, nd * nd).T.ravel()
    np.testing.assert_array_equal(
        GatherSumPlan.build(slots_T, t.nnz, device="cpu").idx.numpy(),
        GatherSumPlan.build_table(slots_T, t.nnz))


@pytest.mark.parametrize("which", ["elastic 2D", "neo-Hookean hex"])
def test_matrix_matches_reference(which):
    """Assembler.matrix (ELL columns exactly; values, to_dense and the
    diagonal rel <= 1e-12) at a seeded state, Dirichlet rows and columns
    eliminated with a unit diagonal; its product is the constrained
    matrix-free operator's."""
    if which == "elastic 2D":
        t_asm, _, _ = elastic_system("torch", 4)
        j_asm, _, _ = elastic_system("jax", 4)
        scale = 1e-3
    else:
        t_asm, _ = neohookean_box("torch")
        j_asm, _ = neohookean_box("jax")
        scale = 2e-2
    n = t_asm.n_dofs
    rng = np.random.default_rng(5)
    u = t_asm.set_bc(torch.as_tensor(scale * rng.standard_normal(n)))
    v = rng.standard_normal(n)
    tm = matrix(t_asm, u)
    jm = matrix(j_asm, jnp.asarray(u.numpy()))
    np.testing.assert_array_equal(tm.cols.numpy(), np.asarray(jm.cols))
    assert rel(tm.vals.numpy(), jm.vals) <= 1e-12
    assert rel(tm.to_dense().numpy(), jm.to_dense()) <= 1e-12
    assert rel(tm.diagonal().numpy(), jm.diagonal()) <= 1e-12
    free = t_asm.free_mask(torch.float64).numpy()
    np.testing.assert_array_equal(tm.diagonal().numpy()[free == 0], 1.0)
    vt = torch.as_tensor(v)
    em = t_asm.element_matrices(u, {})
    assert rel(t_asm.constrained_matvec(tm)(vt).numpy(),
               t_asm.constrained_action(u, {}, em)(vt).numpy()) <= 1e-12
    assert rel(tm.matvec(vt).numpy(), jm.matvec(jnp.asarray(v))) <= 1e-12


@pytest.mark.parametrize("which", ["unit_square(7)", "box(3, 4, 2)"])
def test_reorderings_exactly_equal(which):
    """sfc_reorder and rcm_reorder (nodes, cells, cell tags) and the
    bandwidth, against the reference's on the same mesh."""
    from tpufem.mesh import box as j_box, unit_square as j_us
    from tpufem_torch.mesh import box as t_box, unit_square as t_us

    tm, jm = ((t_us(7), j_us(7)) if which == "unit_square(7)"
              else (t_box(3, 4, 2), j_box(3, 4, 2)))
    for name in ("sfc_reorder", "rcm_reorder"):
        t = getattr(t_reorder, name)(tm)
        j = getattr(j_reorder, name)(jm)
        np.testing.assert_array_equal(t.x, j.x, err_msg=name)
        np.testing.assert_array_equal(t.cells, j.cells, err_msg=name)
        np.testing.assert_array_equal(t.cell_tags, j.cell_tags, err_msg=name)
        assert t_reorder.bandwidth(t) == j_reorder.bandwidth(j)


def test_morton_numpy_twin_equals_the_library():
    from tpufem_torch import native
    from tpufem_torch.mesh import box

    x = np.random.default_rng(3).random((500, 3))
    for pts in (x, x[:, :2], box(3, 2, 5).x):
        np.testing.assert_array_equal(native._morton_numpy(pts),
                                      native.morton_order(pts))


# -- preconditioners, energies ------------------------------------------------


def test_lambda_max_and_chebyshev_match_reference():
    """estimate_lambda_max (12 iterations) and one Chebyshev application
    (degree 4, its band) rel <= 1e-12 on tests/test_precond.py's system;
    lambda_max within 5 % of the true one (30 iterations, the reference
    test's check); Chebyshev-CG takes under half Jacobi-CG's count."""
    t_asm, tm, tb = elastic_system("torch", 12)
    j_asm, jm, jb = elastic_system("jax", 12)
    td, jd = tm.diagonal(), jm.diagonal()
    t_l = t_precond.estimate_lambda_max(tm.matvec, td, tm.n_rows)
    j_l = j_precond.estimate_lambda_max(jm.matvec, jd, jm.n_rows)
    assert abs(float(t_l) - float(j_l)) <= 1e-12 * float(j_l)
    t_M = t_precond.chebyshev_preconditioner(tm.matvec, td, lmax=t_l)
    j_M = j_precond.chebyshev_preconditioner(jm.matvec, jd, lmax=j_l)
    assert rel(t_M(tb).numpy(), j_M(jb)) <= 1e-12
    # defaults: lambda_max 2.0
    assert rel(t_precond.chebyshev_preconditioner(tm.matvec, td)(tb).numpy(),
               j_precond.chebyshev_preconditioner(jm.matvec, jd)(jb)
               ) <= 1e-12
    lmax = float(t_precond.estimate_lambda_max(tm.matvec, td, tm.n_rows,
                                               iters=30))
    A = tm.to_dense().numpy()
    true = np.abs(np.linalg.eigvals(np.diag(1.0 / td.numpy()) @ A)).max()
    assert abs(lmax - true) / true < 0.05
    from tpufem_torch.la import cg

    r1 = cg(tm.matvec, tb, M=t_precond.jacobi_preconditioner(td),
            rtol=1e-10, maxit=20000)
    r2 = cg(tm.matvec, tb, M=t_M, rtol=1e-10, maxit=20000)
    assert r1.converged and r2.converged and r2.iters < 0.5 * r1.iters


def test_neo_hookean_psi_and_hessian_match_reference():
    """psi, its gradient and its Hessian (torch.func.hessian against
    jax.hessian) rel <= 1e-12 at seeded 3x3 and 2x2 displacement
    gradients; forward-over-forward equals the Hessian (the reference
    test's check)."""
    from torch.func import grad, hessian, jacfwd

    from tpufem.forms import neo_hookean_psi as j_psi
    from tpufem_torch.forms import neo_hookean_psi as t_psi

    rng = np.random.default_rng(0)
    ft = lambda x: t_psi(x, E, NU)  # noqa: E731
    fj = jax.jit(lambda x: (j_psi(x, E, NU), jax.grad(j_psi)(x, E, NU),
                            jax.hessian(j_psi)(x, E, NU)))
    for dim in (3, 2):
        for _ in range(3):
            g = 0.1 * rng.standard_normal((dim, dim))
            gt = torch.as_tensor(g)
            psi, sig, hj = fj(jnp.asarray(g))
            assert rel(ft(gt).numpy(), psi) <= 1e-12
            assert rel(grad(ft)(gt).numpy(), sig) <= 1e-12
            h = hessian(ft)(gt)
            assert rel(h.numpy(), hj) <= 1e-12
            assert rel(jacfwd(jacfwd(ft))(gt).numpy(), h.numpy()) <= 1e-12


# -- make_newton_solver ---------------------------------------------------------

# (use_matrix, preconditioner, convergence); the assembled Jacobi and
# matrix-free Chebyshev paths under r0 are the 3D cases' own
# (test_torch_cases3d.py)
NEWTON_CASES = [
    (True, "chebyshev", "du0"),
    (True, "none", "r0"),
    (False, "jacobi", "du0"),
    (False, "none", "r0"),
]


@pytest.fixture(scope="module")
def damage_asm():
    return damage_problem("torch"), damage_problem("jax")


@pytest.mark.parametrize("use_matrix,pc,conv", NEWTON_CASES)
def test_make_newton_solver_matches_reference(damage_asm, use_matrix, pc,
                                              conv):
    (t_asm, tc, tV), (j_asm, jc, _) = damage_asm
    kw = dict(preconditioner=pc, convergence=conv, cg_rtol=1e-10)
    t = t_nls.make_newton_solver(
        t_asm, t_config.SolverConfig(**kw), use_matrix=use_matrix)(
            torch.zeros(tV.n_dofs, dtype=torch.float64), tc)
    j = j_jit.make_newton_solver(
        j_asm, j_config.SolverConfig(**kw), use_matrix=use_matrix)(
            jnp.zeros(tV.n_dofs), jc)
    assert t.converged and bool(j.converged)
    assert t.newton_iters == int(j.newton_iters) >= 2
    assert abs(t.total_cg_iters - int(j.total_cg_iters)) <= t.newton_iters
    assert rel(t.u.numpy(), j.u) <= 1e-9
    assert abs(t.r0 - float(j.r0)) <= 1e-9 * float(j.r0)
    assert set(t.phase_s) == {"tangent", "lambda_max", "cg", "residual"}


def test_unported_preconditioners_raise(damage_asm):
    """What the flat solvers do not run raises ValueError: block Jacobi and
    AMG without the assembled matrix, Chebyshev and none in the chunked
    solver (the reference runs Jacobi for them without a word), the lane
    and structured solvers' preconditioners; block Jacobi and AMG build
    (their solves are held against the reference's below and in
    test_torch_amg.py)."""
    t_asm = damage_asm[0][0]
    for pc in ("block_jacobi", "amg"):
        cfg = t_config.SolverConfig(preconditioner=pc)
        with pytest.raises(ValueError, match="use_matrix"):
            t_nls.make_newton_solver(t_asm, cfg, use_matrix=False)
        t_nls.make_newton_solver(t_asm, cfg)
        t_nls.make_chunked_solver(t_asm, cfg)
    for pc in ("chebyshev", "none"):  # the reference runs Jacobi for them
        with pytest.raises(ValueError, match="jacobi"):
            t_nls.make_chunked_solver(
                t_asm, t_config.SolverConfig(preconditioner=pc))
    with pytest.raises(ValueError, match="twolevel"):
        t_nls.make_newton_solver(
            t_asm, t_config.SolverConfig(preconditioner="twolevel"))


# -- block Jacobi -----------------------------------------------------------------


@pytest.mark.parametrize("n,B", [(24, 128), (11, 100)])
def test_block_jacobi_matches_reference(n, B):
    """tests/test_precond.py's block Jacobi tests: the plan's table exactly
    the reference's (also for a block size that does not divide n), the
    blocks and one application rel <= 1e-12 (padding rows get a unit
    diagonal), block-Jacobi CG within 1 of the reference's count, and at
    n = 24 under 0.6 of point Jacobi's (test_block_jacobi_beats_point_
    jacobi)."""
    from tpufem.la.block_jacobi import BlockJacobiPlan as JPlan
    from tpufem.la.cg import cg as j_cg
    from tpufem_torch.la import BlockJacobiPlan as TPlan, cg as t_cg

    t_asm, tm, tb = elastic_system("torch", n)
    j_asm, jm, jb = elastic_system("jax", n)
    tp = TPlan.build(t_asm.pattern, B, device="cpu")
    jp = JPlan.build(j_asm.pattern, B)
    assert (tp.n, tp.B, tp.nb) == (jp.n, jp.B, jp.nb)
    assert tp.ell_pos.dtype == torch.int32
    np.testing.assert_array_equal(tp.ell_pos.numpy(), np.asarray(jp.ell_pos))
    assert tp.nb * B > tp.n  # a last block with padding rows
    assert rel(tp.extract(tm).numpy(), jp.extract(jm)) <= 1e-12
    tM, jM = tp.preconditioner(tm), jp.preconditioner(jm)
    assert rel(tM(tb).numpy(), jM(jb)) <= 1e-12
    rt = t_cg(tm.matvec, tb, M=tM, rtol=1e-10, maxit=20000)
    rj = jax.jit(lambda m, p, v: j_cg(m.matvec, v, M=p.preconditioner(m),
                                      rtol=1e-10, maxit=20000))(jm, jp, jb)
    assert rt.converged and bool(rj.converged)
    assert abs(rt.iters - int(rj.iters)) <= 1
    assert rel(rt.x.numpy(), rj.x) <= 1e-9
    if n == 24:
        r1 = t_cg(tm.matvec, tb,
                  M=t_precond.jacobi_preconditioner(tm.diagonal()),
                  rtol=1e-10, maxit=20000)
        assert rt.iters < 0.6 * r1.iters


def pulled_elastic(pkg):
    """tests/test_precond.py::test_newton_with_block_jacobi's system: an
    SFC-ordered unit_square(12), linear elasticity, x = 0 clamped, x = 1
    pulled by 0.01."""
    A, F, FF, M, S, B, kw = _pkg(pkg)
    reorder = j_reorder if pkg == "jax" else t_reorder
    V = S.FunctionSpace.create(reorder.sfc_reorder(M.unit_square(12)), 1,
                               bs=2)
    left = B.locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = B.locate_dofs_geometrical(
        V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    t = FF.Term(lambda qp: F.linear_elastic_psi(qp.eps, E, NU), 1)
    return A.Assembler(F.EnergyFunctional(V, [t], **kw), [
        S.DirichletBC(V, left, [0.0, 0.0]),
        S.DirichletBC(V, right, [0.01, 0.0])]), V


def test_newton_with_block_jacobi_matches_reference():
    """make_newton_solver with block_jacobi (blocks of 64) against the
    reference's: the same Newton count, |d total CG| <= Newton steps, u
    rel <= 1e-9; the blocks are inverted every Newton step."""
    t_asm, tV = pulled_elastic("torch")
    j_asm, _ = pulled_elastic("jax")
    kw = dict(preconditioner="block_jacobi", block_size=64, cg_rtol=1e-10)
    t = t_nls.make_newton_solver(t_asm, t_config.SolverConfig(**kw))(
        torch.zeros(tV.n_dofs, dtype=torch.float64), {})
    j = j_jit.make_newton_solver(j_asm, j_config.SolverConfig(**kw))(
        jnp.zeros(tV.n_dofs), {})
    assert t.converged and bool(j.converged)
    assert t.newton_iters == int(j.newton_iters) >= 1
    assert abs(t.total_cg_iters - int(j.total_cg_iters)) <= t.newton_iters
    assert rel(t.u.numpy(), j.u) <= 1e-9
    assert t.phase_s["block_inverse"] > 0.0


# -- the chunked solver ---------------------------------------------------------


@pytest.mark.parametrize("conv", ["r0", "du0"])
def test_chunked_solver_matches_reference(damage_asm, conv):
    """Whole chunks of 7 (the count grows by 7s), the same history."""
    (t_asm, tc, tV), (j_asm, jc, _) = damage_asm
    kw = dict(convergence=conv, cg_rtol=1e-10)
    t = t_nls.make_chunked_solver(t_asm, t_config.SolverConfig(**kw),
                                  cg_chunk=7)(
        torch.zeros(tV.n_dofs, dtype=torch.float64), tc)
    j = j_chunked.make_chunked_solver(j_asm, j_config.SolverConfig(**kw),
                                      cg_chunk=7)(jnp.zeros(tV.n_dofs), jc)
    assert t.converged and j.converged
    assert t.newton_iters == j.newton_iters >= 2
    assert abs(t.total_cg_iters - j.total_cg_iters) <= t.newton_iters
    assert t.total_cg_iters % 7 == 0
    assert [h[0] for h in t.history] == [h[0] for h in j.history]
    assert all(abs(a[1] - b[1]) <= 1e-9 * j.history[0][1]
               for a, b in zip(t.history, j.history))
    assert rel(t.u.numpy(), j.u) <= 1e-9
    assert abs(t.final_residual - j.final_residual) <= 1e-6 * j.r0


def test_chunked_block_jacobi_matches_reference():
    """tests/test_precond.py::test_chunked_solver_matches_jit's block
    Jacobi case (unit_square(16), blocks of 64, chunks of 37) against the
    reference's chunked solver: the same Newton count, |d total CG| <=
    Newton steps, u rel <= 1e-9; and the port's chunked solve lands on its
    make_newton_solver's within 1e-8 (the reference test's check)."""
    (t_asm, tc, tV), (j_asm, jc, _) = (damage_problem("torch", 16),
                                       damage_problem("jax", 16))
    kw = dict(preconditioner="block_jacobi", block_size=64)
    t = t_nls.make_chunked_solver(t_asm, t_config.SolverConfig(**kw),
                                  cg_chunk=37)(
        torch.zeros(tV.n_dofs, dtype=torch.float64), tc)
    j = j_chunked.make_chunked_solver(j_asm, j_config.SolverConfig(**kw),
                                      cg_chunk=37)(jnp.zeros(tV.n_dofs), jc)
    assert t.converged and j.converged
    assert t.newton_iters == j.newton_iters >= 2
    assert abs(t.total_cg_iters - j.total_cg_iters) <= t.newton_iters
    assert rel(t.u.numpy(), j.u) <= 1e-9
    r1 = t_nls.make_newton_solver(t_asm, t_config.SolverConfig(**kw))(
        torch.zeros(tV.n_dofs, dtype=torch.float64), tc)
    assert float((r1.u - t.u).abs().max()) < 1e-8


def test_chunked_checkpoint_resume_equals_the_uninterrupted_run(damage_asm,
                                                               tmp_path):
    """A run that crashes inside Newton step 2 (after step 1's checkpoint)
    and is resumed from the file lands on the uninterrupted run bit for
    bit; the resumed run continues at step 2 (tests/test_io.py:77-110)."""
    t_asm, tc, tV = damage_asm[0]
    cfg = t_config.SolverConfig(cg_rtol=1e-12, error_on_nonconvergence=False)
    u0 = torch.zeros(tV.n_dofs, dtype=torch.float64)
    ref = t_nls.make_chunked_solver(t_asm, cfg)(u0, tc)
    assert ref.converged and ref.newton_iters >= 3
    ck = str(tmp_path / "newton.npz")
    calls = []
    matrix = t_asm.matrix

    def crash_in_step_2(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt("stopped inside step 2")
        return matrix(*a, **k)

    t_asm.matrix = crash_in_step_2
    try:
        with pytest.raises(KeyboardInterrupt):
            t_nls.make_chunked_solver(t_asm, cfg, checkpoint_path=ck)(u0, tc)
    finally:
        del t_asm.matrix
    res = t_nls.make_chunked_solver(t_asm, cfg, checkpoint_path=ck)(u0, tc)
    assert res.converged and res.history[0][0] == 2
    assert torch.equal(res.u, ref.u)
    assert res.history == ref.history[1:]
    assert res.total_cg_iters == ref.total_cg_iters
    assert res.newton_iters == ref.newton_iters


# -- evaluate_expression, Function ----------------------------------------------


def test_evaluate_expression_and_function_match_reference(damage_asm):
    import tpufem.forms.expression as j_expr
    import tpufem.spaces.function as j_function
    import tpufem_torch.forms.expression as t_expr
    import tpufem_torch.spaces.function as t_function

    (t_asm, tc, tV), (j_asm, jc, jV) = damage_asm
    u = 1e-3 * np.random.default_rng(2).standard_normal(tV.n_dofs)
    pts = np.array([[1 / 3, 1 / 3], [0.2, 0.6]])
    fn = lambda qp: qp.coeff("d") * qp.eps + qp.u[0] * qp.x[1]  # noqa: E731
    for p in (pts, pts[0]):
        t = t_expr.evaluate_expression(t_asm.functional, fn,
                                       torch.as_tensor(u), tc, p)
        j = j_expr.evaluate_expression(j_asm.functional, fn, jnp.asarray(u),
                                       jc, p)
        assert t.shape == j.shape
        assert rel(t, j) <= 1e-12
    f = lambda x: np.stack([x[:, 0] ** 2, x[:, 1] - x[:, 0]], 1)  # noqa
    tf = t_function.Function(tV, dtype=torch.float64,
                             device="cpu").interpolate(f)
    jf = j_function.Function(jV).interpolate(f)
    np.testing.assert_array_equal(tf.values(), jf.values())
    assert tf.values().shape == (tV.n_scalar_dofs, 2)
    np.testing.assert_array_equal(tf.set(0.5).values(), jf.set(0.5).values())
    assert tf.x.dtype == torch.float64 and tf.x.device.type == "cpu"
    if torch.cuda.is_available():  # the default device is the card
        assert t_function.Function(tV).x.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_function.Function(tV)
