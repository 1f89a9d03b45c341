"""``make_grid_solver`` of tpufem_torch (``structured.solve``) against the
reference's (CPU, float64, the same numpy inputs through both).

Every comparison asks for the same Newton count, the same total CG count
(counted in whole chunks, as the reference counts them) and ``u`` rel <=
1e-9.

The 3D multigrid solve of the reference compiles for more than two
minutes on the CPU (its ``StructuredGrid3D.diagonal`` alone about 70 s, the
V-cycle inside the CG chunk most of the rest), so the tier-1 3D test holds
the port's solve (multigrid, K8 plain on the fine level) against the
reference's residual instead -- its u must be a root of it -- and the
solve-against-solve comparison is marked ``slow``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.forms as j_forms
import tpufem_torch.forms as t_forms
from tpufem.config import SolverConfig as JConfig
from tpufem.structured.grid2d import StructuredGrid2D as JGrid2D
from tpufem.structured.grid3d import StructuredGrid3D as JGrid3D
from tpufem.structured.solve import make_grid_solver as j_solver
from tpufem_torch.config import SolverConfig as TConfig
from tpufem_torch.structured import GridSolveResult
from tpufem_torch.structured import kernels3d as K3
from tpufem_torch.structured import make_grid_solver as t_solver
from tpufem_torch.structured.dist2d import DistStructuredGrid2D
from tpufem_torch.structured.grid2d import StructuredGrid2D as TGrid2D
from tpufem_torch.structured.grid3d import StructuredGrid3D as TGrid3D
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E0, NU = 3.7e7, 0.3  # tests/test_structured.py's problem
E3 = 1.0e6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _problem2d(n=16):
    """tests/test_structured.py::test_end_to_end_solve_matches on the
    lattice: damage 0.5 above y = 0.6, x clamped at both ends, u_x = 0.01
    at x = 1."""
    grids = [G(nx=n, ny=n, hx=1 / n, hy=1 / n, bs=2,
               energy_density=lambda g, c, f=f: f.asym_damage_psi(
                   0.5 * (g + g.T), c["d"], E0, NU),
               field_kinds={"d": "vertex"})
             for G, f in ((JGrid2D, j_forms), (TGrid2D, t_forms))]
    yy = np.linspace(0, 1, n + 1)[:, None]
    d = np.broadcast_to(np.where(yy > 0.6, 0.5, 0.0), (n + 1, n + 1)).copy()
    free = np.ones((2, n + 1, n + 1))
    free[:, :, 0] = 0.0
    free[:, :, -1] = 0.0
    bcv = np.zeros((2, n + 1, n + 1))
    bcv[0, :, -1] = 0.01
    return grids, d, free, bcv


def _solve_both(cfg, kw_j, kw_t):
    (gj, gt), d, free, bcv = _problem2d()
    rj = j_solver(gj, JConfig(**cfg), **kw_j)(
        jnp.zeros(free.shape), {"d": jnp.asarray(d)}, jnp.asarray(free),
        jnp.asarray(bcv))
    rt = t_solver(gt, TConfig(**cfg), **kw_t)(
        torch.zeros(free.shape, dtype=torch.float64),
        {"d": torch.as_tensor(d)}, torch.as_tensor(free),
        torch.as_tensor(bcv))
    return rj, rt


def _same_solve(rj, rt):
    assert isinstance(rt, GridSolveResult)
    assert rt.converged and rj.converged
    assert rt.newton_iters == rj.newton_iters
    assert rt.total_cg_iters == rj.total_cg_iters
    assert sum(rt.cg_iters) == rt.total_cg_iters
    assert len(rt.residuals) == rt.newton_iters
    assert _rel(rt.u.numpy(), rj.u) <= 1e-9
    assert abs(rt.r0 - rj.r0) <= 1e-12 * rj.r0


def test_grid_solver_2d_jacobi_matches_reference():
    """The reference's test problem with its defaults (Jacobi, cg_chunk
    200)."""
    _same_solve(*_solve_both({}, {}, {}))


def test_grid_solver_2d_mg_matches_reference():
    cfg = dict(preconditioner="mg")
    _same_solve(*_solve_both(cfg, dict(cg_chunk=10), dict(cg_chunk=10)))


def test_grid_solver_2d_mg_with_matvec_factory_matches_reference():
    """A raw linear matvec per level through ``mg_matvec_factory`` (the
    fine CG operator and the smoothers; None on the coarser levels):
    linear elasticity, the reference's factory the JVP at zero, the port's
    the stored stencil at zero. n = 32: the reference needs a multigrid
    level (2178 dofs > coarse_dofs 1500) when a factory is given."""
    n = 32
    gj, gt = (G(nx=n, ny=n, hx=1 / n, hy=1 / n, bs=2,
                energy_density=lambda g, c, f=f: f.linear_elastic_psi(
                    0.5 * (g + g.T), E0, NU), field_kinds={})
              for G, f in ((JGrid2D, j_forms), (TGrid2D, t_forms)))
    _, _d, free, bcv = _problem2d(n)

    def j_factory(g):
        if g.nx < n:
            return None
        z = jnp.zeros((2, g.ny + 1, g.nx + 1))
        return lambda v: g.tangent_action(z, {}, v)

    def t_factory(g):
        if g.nx < n:
            return None
        return g.operator(torch.zeros((2, g.ny + 1, g.nx + 1),
                                      dtype=torch.float64), {})

    cfg = dict(preconditioner="mg", newton_rtol=1e-10, newton_atol=0.0)
    rj = j_solver(gj, JConfig(**cfg), cg_chunk=10,
                  mg_matvec_factory=j_factory)(
        jnp.zeros(free.shape), {}, jnp.asarray(free), jnp.asarray(bcv))
    rt = t_solver(gt, TConfig(**cfg), cg_chunk=10,
                  mg_matvec_factory=t_factory)(
        torch.zeros(free.shape, dtype=torch.float64), {},
        torch.as_tensor(free), torch.as_tensor(bcv))
    _same_solve(rj, rt)


def test_grid_solver_2d_mixed_float32_inner_matches_reference():
    """inner_dtype float32: the CG solves (and the Jacobi diagonal) in
    float32 on the normalized right-hand side, Newton in float64 down to
    newton_rtol 1e-10."""
    cfg = dict(cg_rtol=1e-6, newton_rtol=1e-10, newton_maxit=20)
    rj, rt = _solve_both(cfg, dict(cg_chunk=10, inner_dtype=jnp.float32),
                         dict(cg_chunk=10, inner_dtype=torch.float32))
    _same_solve(rj, rt)
    assert rt.u.dtype == torch.float64
    assert rt.newton_iters >= 3  # defect correction: several Newton steps


def _bar3d(nx, ny, nz, G, forms):
    grid = G(nx=nx, ny=ny, nz=nz, hx=1 / nx, hy=1 / ny, hz=1 / nz, bs=3,
             energy_density=lambda g, c: forms.linear_elastic_psi(
                 0.5 * (g + g.T), E3, NU),
             field_kinds={})
    shape = (3, nz + 1, ny + 1, nx + 1)
    free = np.ones(shape)
    free[..., 0] = 0.0
    free[..., -1] = 0.0
    bcv = np.zeros(shape)
    bcv[0, ..., -1] = 0.01
    return grid, free, bcv


# the pulled bar of solve3d_bench.py, cut to a lattice with one multigrid
# level above the dense coarse solve (12x8x8: 3159 dofs > coarse_dofs 3000;
# coarse 6x4x4, 525 dofs)
CFG3 = dict(preconditioner="mg", cg_rtol=1e-6, newton_rtol=1e-10,
            newton_atol=0.0, cg_maxit=500, newton_maxit=10)


def _k8_factory(g):
    return K3.make_linear_matvec(g, E3, NU)


def test_grid_solver_3d_mg_k8_solves_the_reference_problem():
    """3D, preconditioner 'mg', the K8 factory (plain on the CPU: float32
    inside) on the fine level: converges by defect correction to a u that
    is a root of the REFERENCE's residual (free rows below 1e-9 of its
    initial norm, Dirichlet values exact)."""
    nx, ny, nz = 12, 8, 8
    gj, free, bcv = _bar3d(nx, ny, nz, JGrid3D, j_forms)
    gt, _, _ = _bar3d(nx, ny, nz, TGrid3D, t_forms)
    args = (torch.zeros(free.shape, dtype=torch.float64), {},
            torch.as_tensor(free), torch.as_tensor(bcv))
    r8 = t_solver(gt, TConfig(**CFG3), cg_chunk=5,
                  mg_matvec_factory=_k8_factory)(*args)
    assert r8.converged and r8.total_cg_iters <= 30
    res = jax.jit(lambda w: gj.residual(w, {}))
    r_ref = np.asarray(res(jnp.asarray(r8.u.numpy()))) * free
    r_start = np.asarray(res(jnp.asarray(bcv))) * free
    assert np.linalg.norm(r_ref) <= 1e-9 * np.linalg.norm(r_start)
    assert np.array_equal(r8.u.numpy()[free == 0], bcv[free == 0])


def _jax_k8_factory(g):
    """The port's plain K8 spelled in jnp for the reference's solver:
    interior nodes in the pre-summed order, the others per incident
    cell."""
    consts = K3.StencilConsts(g.nx, g.ny, g.nz, K3._cell_matrix(g, E3, NU))

    def mv(x):
        x32 = x.astype(jnp.float32)
        shape = x32.shape[-3:]
        p = jnp.pad(x32, ((0, 0), (1, 1), (1, 1), (1, 1)))

        def shifted(delta):
            return [p[(b,) + tuple(slice(1 + o, 1 + o + s)
                                   for o, s in zip(delta, shape))]
                    for b in range(3)]

        def mask(nn, size, c, dim):
            i = np.arange(size) + c
            view = [1, 1, 1]
            view[dim] = size
            return jnp.asarray(((i >= 0) & (i < nn)).astype(np.float32)
                               .reshape(view))

        mz = {c: mask(g.nz, shape[0], c, 0) for c in (-1, 0)}
        my = {c: mask(g.ny, shape[1], c, 1) for c in (-1, 0)}
        mx = {c: mask(g.nx, shape[2], c, 2) for c in (-1, 0)}
        acc = [None] * 3
        for delta, chi, K in consts.terms:
            xb = shifted(delta)
            m = mz[chi[0]] * my[chi[1]] * mx[chi[2]]
            for b in range(3):
                for a in range(3):
                    if float(K[a, b]) != 0.0:
                        t = float(K[a, b]) * (m * xb[b])
                        acc[a] = t if acc[a] is None else acc[a] + t
        inner = [None] * 3
        for d, b, a in K3.INTERIOR_ENTRIES:
            t = float(consts.S[d, a, b]) * shifted(K3.DELTAS[d])[b]
            inner[a] = t if inner[a] is None else inner[a] + t
        m_in = np.ones(shape, bool)
        for dim, size in enumerate(shape):
            i = np.arange(size)
            view = [1, 1, 1]
            view[dim] = size
            m_in &= ((i >= 1) & (i <= size - 2)).reshape(view)
        return jnp.where(jnp.asarray(m_in)[None], jnp.stack(inner),
                         jnp.stack(acc)).astype(x.dtype)

    return mv


@pytest.mark.slow
def test_grid_solver_3d_mg_k8_matches_reference_solve():
    """The same 3D solve through the reference's make_grid_solver with the
    same K8 (in jnp) as its factory: same Newton count, same chunked CG
    total, u rel <= 1e-9. Slow: the reference compiles for > 2 minutes."""
    nx, ny, nz = 12, 8, 8
    gj, free, bcv = _bar3d(nx, ny, nz, JGrid3D, j_forms)
    gt, _, _ = _bar3d(nx, ny, nz, TGrid3D, t_forms)
    rj = j_solver(gj, JConfig(**CFG3), cg_chunk=5,
                  mg_matvec_factory=_jax_k8_factory)(
        jnp.zeros(free.shape), {}, jnp.asarray(free), jnp.asarray(bcv))
    rt = t_solver(gt, TConfig(**CFG3), cg_chunk=5,
                  mg_matvec_factory=_k8_factory)(
        torch.zeros(free.shape, dtype=torch.float64), {},
        torch.as_tensor(free), torch.as_tensor(bcv))
    _same_solve(rj, rt)


def test_unported_structured_paths_raise():
    (_gj, gt), *_ = _problem2d(4)
    with pytest.raises(NotImplementedError, match="distribution"):
        DistStructuredGrid2D(gt, 8)
