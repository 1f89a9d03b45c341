"""SA-AMG of tpufem_torch (``la.amg``) against tpufem's (CPU, float64):
tests/test_amg.py's tests, each held against the reference.

The systems are tests/test_amg.py's: a unit square, linear elasticity or
the asymmetric damage law with a damaged band, x clamped, u_x = 0.01 at
x = 1; and its scalar Poisson problem. ``amg_coarse_size`` is lowered so
that the small meshes still have three levels or more.

Tolerances: host tables (rigid-body modes, strength graph, aggregation,
every table of ``build_hierarchy``) exactly equal, from one SciPy matrix
and from each package's own matrix, through the native aggregation and
through the NumPy rounds; one V-cycle rel <= 1e-12; CG counts within 1;
the Newton solvers the same Newton count, |d total CG| <= Newton steps,
u rel <= 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.config as j_config
import tpufem.la.amg as j_amg
import tpufem.native as j_native
import tpufem_torch.config as t_config
import tpufem_torch.la.amg as t_amg
import tpufem_torch.native as t_native
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3
F64 = dict(device="cpu", dtype=torch.float64)
COARSE = 40  # amg_coarse_size: three levels or more at n <= 16


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def elastic_system(pkg, n, law="damage"):
    """tests/test_amg.py's _elastic_system(n, law) in either package: the
    assembler, the matrix at set_bc(0), the space, the coefficients and
    the free mask."""
    if pkg == "jax":
        from tpufem.assemble import Assembler
        from tpufem.forms import (EnergyFunctional, asym_damage_psi,
                                  linear_elastic_psi)
        from tpufem.forms.form import Coefficient, Term
        from tpufem.mesh import unit_square
        from tpufem.spaces import DirichletBC, FunctionSpace
        from tpufem.spaces.bc import locate_dofs_geometrical
        kw, arr = {}, jnp.asarray
    else:
        from tpufem_torch.assemble import Assembler
        from tpufem_torch.forms import (EnergyFunctional, asym_damage_psi,
                                        linear_elastic_psi)
        from tpufem_torch.forms.form import Coefficient, Term
        from tpufem_torch.mesh import unit_square
        from tpufem_torch.spaces import DirichletBC, FunctionSpace
        from tpufem_torch.spaces.bc import locate_dofs_geometrical
        kw, arr = F64, torch.as_tensor
    mesh = unit_square(n)
    V = FunctionSpace.create(mesh, 1, bs=2)
    if law == "linear":
        t = Term(lambda qp: linear_elastic_psi(qp.eps, E, NU), 1)
        F = EnergyFunctional(V, [t], **kw)
        coeffs = {}
    else:
        DS = FunctionSpace.create(mesh, 1, bs=1)
        d = np.zeros(DS.n_dofs)
        d[(DS.dof_coords[:, 1] > 0.45) & (DS.dof_coords[:, 1] < 0.55)] = 0.8
        t = Term(lambda qp: asym_damage_psi(qp.eps, qp.coeff("d"), E, NU), 1)
        F = EnergyFunctional(V, [t], [Coefficient("d", DS)], **kw)
        coeffs = {"d": arr(d)}
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    asm = Assembler(F, [DirichletBC(V, left, [0.0, 0.0]),
                        DirichletBC(V, right, [0.01, 0.0])])
    if pkg == "jax":
        # eagerly: the port's matrix is then the reference's bit for bit
        # (under jit XLA rounds two of its entries differently here)
        mat = asm.matrix(asm.set_bc(jnp.zeros(V.n_dofs)), coeffs)
        fm = np.asarray(asm.free_mask(jnp.float64))
    else:
        u0 = asm.set_bc(torch.zeros(V.n_dofs, dtype=torch.float64))
        mat = asm.matrix(u0, coeffs)
        fm = asm.free_mask(torch.float64).numpy()
    return asm, mat, V, coeffs, fm


@pytest.fixture(scope="module")
def damage16():
    return elastic_system("torch", 16), elastic_system("jax", 16)


@pytest.fixture
def numpy_rounds(monkeypatch, request):
    """The aggregation route: the native pass, or (both packages' library
    patched away) the NumPy rounds."""
    if request.param == "numpy":
        monkeypatch.setattr(t_native, "amg_aggregate", lambda *a: None)
        monkeypatch.setattr(j_native, "amg_aggregate", lambda *a: None)
    return request.param


# -- host set-up -------------------------------------------------------------


@pytest.mark.parametrize("bs", [1, 2, 3])
def test_rigid_body_modes_match_reference(bs):
    """Exactly the reference's modes, masked or not; bs = 3 spans six
    independent modes (tests/test_amg.py::test_rbm_3d_count), and the
    2D modes span the kernel of the unconstrained elastic operator
    (test_rigid_body_modes_span_nullspace)."""
    coords = np.random.default_rng(bs).normal(size=(10, max(bs, 2)))
    free = (np.arange(10 * bs) % 3 != 0).astype(np.float64)
    for fm in (None, free):
        np.testing.assert_array_equal(
            t_amg.rigid_body_modes(coords, bs, fm),
            j_amg.rigid_body_modes(coords, bs, fm))
    B = t_amg.rigid_body_modes(coords, bs)
    assert B.shape == (10 * bs, {1: 1, 2: 3, 3: 6}[bs])
    assert np.linalg.matrix_rank(B) == B.shape[1]
    if bs == 2:
        from tpufem_torch.assemble import Assembler
        from tpufem_torch.forms import EnergyFunctional, linear_elastic_psi
        from tpufem_torch.forms.form import Term
        from tpufem_torch.mesh import unit_square
        from tpufem_torch.spaces import FunctionSpace

        V = FunctionSpace.create(unit_square(8), 1, bs=2)
        t = Term(lambda qp: linear_elastic_psi(qp.eps, E, NU), 1)
        asm = Assembler(EnergyFunctional(V, [t], **F64), [])
        mat = asm.matrix(torch.zeros(V.n_dofs, dtype=torch.float64), {})
        B = t_amg.rigid_body_modes(V.dof_coords, 2)
        for k in range(3):
            r = mat.matvec(torch.as_tensor(B[:, k])).numpy()
            assert np.abs(r).max() < 1e-6 * E, f"mode {k} not in nullspace"


@pytest.mark.parametrize("numpy_rounds", ["native", "numpy"],
                         indirect=True)
def test_strength_graph_and_aggregation_match_reference(damage16,
                                                        numpy_rounds):
    """ell_to_scipy, the node strength graph and the aggregation exactly
    the reference's on the same matrix; the aggregates cover every node
    and coarsen 2D elasticity by 2-12 nodes an aggregate
    (test_aggregation_covers_and_coarsens)."""
    (_, tm, tV, _, _), (_, jm, _, _, _) = damage16
    At, Aj = t_amg.ell_to_scipy(tm), j_amg.ell_to_scipy(jm)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(At, f), getattr(Aj, f))
    St = t_amg._node_strength_graph(At, 2, 0.0)
    Sj = j_amg._node_strength_graph(Aj, 2, 0.0)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(St, f), getattr(Sj, f))
    St8 = t_amg._node_strength_graph(At, 2, 0.08)
    Sj8 = j_amg._node_strength_graph(Aj, 2, 0.08)
    np.testing.assert_array_equal(St8.indices, Sj8.indices)
    agg_t, n_t = t_amg.aggregate(St)
    agg_j, n_j = j_amg.aggregate(Sj)
    assert n_t == n_j
    np.testing.assert_array_equal(agg_t, agg_j)
    n_nodes = tV.n_scalar_dofs
    assert agg_t.shape == (n_nodes,)
    assert (agg_t >= 0).all() and agg_t.max() == n_t - 1
    assert n_nodes / 12 < n_t < n_nodes / 2


@pytest.mark.parametrize("numpy_rounds", ["native", "numpy"],
                         indirect=True)
@pytest.mark.parametrize("source", ["one matrix", "own matrices"])
def test_build_hierarchy_tables_match_reference(damage16, numpy_rounds,
                                                source):
    """Every table of build_hierarchy (ELL columns and values of A, P, R,
    1/diag, lambda_max, the dense coarse pseudo-inverse) exactly the
    reference's: from one SciPy matrix, and from each package's own
    assembled matrix."""
    (_, tm, tV, _, fm), (_, jm, _, _, _) = damage16
    Aj = j_amg.ell_to_scipy(jm)
    At = Aj if source == "one matrix" else t_amg.ell_to_scipy(tm)
    ht = t_amg.build_hierarchy(At, tV.dof_coords, 2, free_mask=fm,
                               opts=t_amg.AMGOptions(coarse_size=COARSE))
    hj = j_amg.build_hierarchy(Aj, tV.dof_coords, 2, free_mask=fm,
                               opts=j_amg.AMGOptions(coarse_size=COARSE))
    assert ht.n_levels == hj.n_levels >= 3
    for L, J in zip(ht.levels, hj.levels):
        for mine, ref in ((L.a, (J.a_cols, J.a_vals)),
                          (L.p, (J.p_cols, J.p_vals)),
                          (L.r, (J.r_cols, J.r_vals))):
            assert mine.cols.dtype == torch.int32
            np.testing.assert_array_equal(mine.cols.numpy(),
                                          np.asarray(ref[0]))
            np.testing.assert_array_equal(mine.vals.numpy(),
                                          np.asarray(ref[1]))
        np.testing.assert_array_equal(L.inv_d.numpy(), np.asarray(J.inv_d))
        assert L.lmax == float(J.lmax)
    np.testing.assert_array_equal(ht.coarse_inv.numpy(),
                                  np.asarray(hj.coarse_inv))
    # float32 levels: the float64 tables rounded once
    h32 = t_amg.build_hierarchy(At, tV.dof_coords, 2, free_mask=fm,
                                opts=t_amg.AMGOptions(coarse_size=COARSE),
                                dtype=torch.float32)
    np.testing.assert_array_equal(
        h32.levels[0].p.vals.numpy(),
        ht.levels[0].p.vals.numpy().astype(np.float32))
    assert h32.levels[0].lmax == float(np.float32(ht.levels[0].lmax))
    assert h32.to("cpu").shapes() == h32.shapes()


# -- device apply ------------------------------------------------------------


def test_vcycle_matches_reference(damage16):
    """One V-cycle (degree 2 and 3) from hierarchies built from one
    matrix: rel <= 1e-12; the cycle is symmetric (<Mx, y> = <x, My>)."""
    (_, _, tV, _, fm), (_, jm, _, _, _) = damage16
    A = j_amg.ell_to_scipy(jm)
    ht = t_amg.build_hierarchy(A, tV.dof_coords, 2, free_mask=fm,
                               opts=t_amg.AMGOptions(coarse_size=COARSE))
    hj = j_amg.build_hierarchy(A, tV.dof_coords, 2, free_mask=fm,
                               opts=j_amg.AMGOptions(coarse_size=COARSE))
    rng = np.random.default_rng(4)
    b, c = rng.normal(size=(2, tV.n_dofs))
    for deg in (2, 3):
        zt = t_amg.vcycle(ht, torch.as_tensor(b), degree=deg).numpy()
        zj = jax.jit(lambda h, v: j_amg.vcycle(h, v, degree=deg))(
            hj, jnp.asarray(b))
        assert rel(zt, zj) <= 1e-12
    M = t_amg.amg_preconditioner(ht)
    bt, ct = torch.as_tensor(b), torch.as_tensor(c)
    assert abs(float(torch.dot(M(bt), ct) - torch.dot(bt, M(ct)))) <= (
        1e-12 * float(torch.dot(M(bt), bt)))


@pytest.mark.parametrize("which", ["elastic damage", "scalar Poisson"])
def test_amg_cg_matches_reference_and_cuts_jacobi(which):
    """CG with one V-cycle per iteration: the reference's count within 1,
    under a third of Jacobi's count, the same solution
    (test_amg_cuts_iterations_vs_jacobi, test_amg_scalar_poisson)."""
    from tpufem.la.cg import cg as j_cg
    from tpufem_torch.la import cg as t_cg, jacobi_preconditioner

    if which == "elastic damage":
        t_asm, tm, tV, tc, fm = elastic_system("torch", 16)
        j_asm, jm, _, jc, _ = elastic_system("jax", 16)
        b = t_asm.lifted_rhs(t_asm.set_bc(torch.zeros(
            tV.n_dofs, dtype=torch.float64)), tc)
        bs = 2
    else:
        t_asm, tm, tV, fm = _poisson("torch", 16)
        jm = _poisson("jax", 16)[1]
        b = torch.as_tensor(np.random.default_rng(3).normal(
            size=tV.n_dofs)) * torch.as_tensor(fm)
        bs = 1
    A = t_amg.ell_to_scipy(tm)
    coarse = COARSE if bs == 2 else 16  # a scalar level coarsens more
    ht = t_amg.build_hierarchy(A, tV.dof_coords, bs, free_mask=fm,
                               opts=t_amg.AMGOptions(coarse_size=coarse))
    hj = j_amg.build_hierarchy(A, tV.dof_coords, bs, free_mask=fm,
                               opts=j_amg.AMGOptions(coarse_size=coarse))
    assert ht.n_levels >= 3
    ra = t_cg(tm.matvec, b, M=t_amg.amg_preconditioner(ht), rtol=1e-10,
              maxit=2000)
    rj = jax.jit(lambda m, h, v: j_cg(
        m.matvec, v, M=j_amg.amg_preconditioner(h), rtol=1e-10,
        maxit=2000))(jm, hj, jnp.asarray(b.numpy()))
    rjac = t_cg(tm.matvec, b, M=jacobi_preconditioner(tm.diagonal()),
                rtol=1e-10, maxit=20000)
    assert ra.converged and bool(rj.converged) and rjac.converged
    assert abs(ra.iters - int(rj.iters)) <= 1
    assert 3 * ra.iters < rjac.iters
    assert rel(ra.x.numpy(), rj.x) <= 1e-9
    assert rel(ra.x.numpy(), rjac.x.numpy()) <= 1e-8


def _poisson(pkg, n):
    """tests/test_amg.py::test_amg_scalar_poisson's system: the assembler,
    the matrix at 0, the space and the free mask."""
    if pkg == "jax":
        from tpufem.assemble import Assembler
        from tpufem.forms import EnergyFunctional
        from tpufem.forms.form import Term
        from tpufem.mesh import unit_square
        from tpufem.spaces import DirichletBC, FunctionSpace
        from tpufem.spaces.bc import locate_dofs_geometrical
        kw, xp = {}, jnp
    else:
        from tpufem_torch.assemble import Assembler
        from tpufem_torch.forms import EnergyFunctional
        from tpufem_torch.forms.form import Term
        from tpufem_torch.mesh import unit_square
        from tpufem_torch.spaces import DirichletBC, FunctionSpace
        from tpufem_torch.spaces.bc import locate_dofs_geometrical
        kw, xp = F64, torch
    V = FunctionSpace.create(unit_square(n), 1, bs=1)
    t = Term(lambda qp: 0.5 * xp.sum(qp.grad_u * qp.grad_u), 1)
    bnd = locate_dofs_geometrical(
        V, lambda x: (np.abs(x[:, 0]) < 1e-12) | (np.abs(x[:, 0] - 1) < 1e-12))
    asm = Assembler(EnergyFunctional(V, [t], **kw),
                    [DirichletBC(V, bnd, [0.0])])
    if pkg == "jax":
        asm.pattern
        mat = jax.jit(lambda a, u: a.matrix(u, {}))(asm, jnp.zeros(V.n_dofs))
        return asm, mat, V, np.asarray(asm.free_mask(jnp.float64))
    mat = asm.matrix(torch.zeros(V.n_dofs, dtype=torch.float64), {})
    return asm, mat, V, asm.free_mask(torch.float64).numpy()


# -- the Newton solvers --------------------------------------------------------


@pytest.mark.parametrize("solver", ["newton", "chunked"])
def test_newton_solvers_with_amg_match_reference(damage16, solver):
    """make_newton_solver and make_chunked_solver (chunks of 25) with
    'amg' against the reference's: the same Newton count, |d total CG|
    <= Newton steps, u rel <= 1e-9; the hierarchy is built once per
    solver (test_newton_jit_amg_matches_jacobi, test_newton_chunked_amg)."""
    import tpufem.nls.newton_chunked as j_chunked
    import tpufem.nls.newton_jit as j_jit
    import tpufem_torch.nls as t_nls

    (t_asm, _, tV, tc, _), (j_asm, _, _, jc, _) = damage16
    kw = dict(preconditioner="amg", cg_rtol=1e-10, amg_coarse_size=COARSE)
    tcfg, jcfg = t_config.SolverConfig(**kw), j_config.SolverConfig(**kw)
    u0 = torch.zeros(tV.n_dofs, dtype=torch.float64)
    if solver == "newton":
        t_solve = t_nls.make_newton_solver(t_asm, tcfg)
        t = t_solve(u0, tc)
        j = j_jit.make_newton_solver(j_asm, jcfg)(jnp.zeros(tV.n_dofs), jc)
        assert t.phase_s["amg_setup"] > 0.0
        # a second solve of the same solver reuses its hierarchy
        assert t_solve(u0, tc).phase_s["amg_setup"] == 0.0
    else:
        t = t_nls.make_chunked_solver(t_asm, tcfg, cg_chunk=25)(u0, tc)
        j = j_chunked.make_chunked_solver(j_asm, jcfg, cg_chunk=25)(
            jnp.zeros(tV.n_dofs), jc)
        assert t.total_cg_iters % 25 == 0
    assert t.converged and bool(j.converged)
    assert t.newton_iters == int(j.newton_iters) >= 2
    assert abs(t.total_cg_iters - int(j.total_cg_iters)) <= t.newton_iters
    assert rel(t.u.numpy(), j.u) <= 1e-9
