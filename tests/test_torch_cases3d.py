"""BASELINE configs 3 and 4 in tpufem_torch against tpufem (CPU, float64):
``cases/elasticity3d`` (the pulled bar, matrix-free Chebyshev-CG on hexes
and tets; the assembled operator on hexes) and ``cases/neohookean`` (3D
hexes and 2D triangles, Newton on the assembled ELL Jacobian), each with
the reference test's own checks (tests/test_cases3d.py:16-63).

Tolerances: the same Newton count, |d total_cg_iters| <= newton_iters,
u rel <= 1e-9. Each reference run happens once (module-scoped fixtures);
most of its time is the reference compiling its solver (the hex
matrix-free one alone: about a minute)."""

import numpy as np
import pytest
import torch

import tpufem.cases.elasticity3d as j_e3d
import tpufem.cases.neohookean as j_nh
import tpufem_torch.cases.elasticity3d as t_e3d
import tpufem_torch.cases.neohookean as t_nh
from tpufem.mesh.mesh import CellType as JCellType
from tpufem_torch.cases.compare import compare_fields
from tpufem_torch.mesh.mesh import CellType
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

F64 = dict(device="cpu", dtype=torch.float64)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def assert_same_solve(t, j):
    assert bool(t.converged) and bool(j.converged)
    assert t.newton_iters == int(j.newton_iters)
    assert abs(t.total_cg_iters - int(j.total_cg_iters)) <= t.newton_iters
    assert rel(t.u.numpy(), j.u) <= 1e-9


@pytest.fixture(scope="module")
def e3d_hex():
    """n = 4 hexes, the reference's defaults (matrix-free, Chebyshev,
    cg_rtol 1e-10)."""
    return (t_e3d.run(t_e3d.Elasticity3DConfig(n=4), **F64),
            j_e3d.run(j_e3d.Elasticity3DConfig(n=4)))


@pytest.fixture(scope="module")
def e3d_tet():
    return (t_e3d.run(t_e3d.Elasticity3DConfig(
                n=4, cell_type=CellType.tetra), **F64),
            j_e3d.run(j_e3d.Elasticity3DConfig(
                n=4, cell_type=JCellType.tetra)))


def check_pulled_bar(res, V, imposed):
    """tests/test_cases3d.py:16-27: BC faces respected, u_x bounded."""
    uu = res.u.numpy().reshape(-1, 3)
    left = np.abs(V.dof_coords[:, 0]) < 1e-12
    right = np.abs(V.dof_coords[:, 0] - 1) < 1e-12
    np.testing.assert_allclose(uu[left], 0.0, atol=1e-12)
    np.testing.assert_allclose(uu[right, 0], imposed, atol=1e-12)
    assert uu[:, 0].min() > -1e-3 and uu[:, 0].max() <= imposed + 1e-12


def test_elasticity3d_hex_matrix_free_matches_reference(e3d_hex):
    (t, tV, tmesh), (j, jV, _) = e3d_hex
    assert_same_solve(t, j)
    np.testing.assert_array_equal(tV.dof_coords, jV.dof_coords)
    assert tmesh.cell_type == CellType.hexahedron and tV.n_dofs == 375
    check_pulled_bar(t, tV, 0.01)
    assert t.phase_s["lambda_max"] > 0.0  # Chebyshev took its estimate


def test_elasticity3d_tet_matches_reference(e3d_tet):
    (t, tV, _), (j, _, _) = e3d_tet
    assert_same_solve(t, j)
    check_pulled_bar(t, tV, 0.01)


def test_elasticity3d_assembled_equals_matrix_free(e3d_hex):
    """``matrix_free=False`` (the ELL Jacobian, the port's ``--matrix``)
    matches the reference's assembled run, and solves the same bar as the
    matrix-free solve: same Newton count, CG within the rule, u rel <=
    1e-9 against each."""
    t, tV, _ = t_e3d.run(t_e3d.Elasticity3DConfig(n=4, matrix_free=False),
                         **F64)
    j, _, _ = j_e3d.run(j_e3d.Elasticity3DConfig(n=4, matrix_free=False))
    assert_same_solve(t, j)
    mf = e3d_hex[0][0]
    assert t.converged and t.newton_iters == mf.newton_iters
    assert abs(t.total_cg_iters - mf.total_cg_iters) <= t.newton_iters
    assert rel(t.u.numpy(), mf.u.numpy()) <= 1e-9


def test_elasticity3d_hex_vs_tet(e3d_hex, e3d_tet):
    """tests/test_cases3d.py:30-47 on the port's runs: the same nodes, two
    discretizations, an O(h^2) gap."""
    (th, Vh, _), (tt, Vt, _) = e3d_hex[0], e3d_tet[0]
    cmp = compare_fields(Vh.dof_coords, th.u.numpy().reshape(-1, 3),
                         Vt.dof_coords, tt.u.numpy().reshape(-1, 3))
    assert cmp.linf_per_component.max() < 2e-3


@pytest.mark.parametrize("dim,n,stretch", [(3, 4, 0.2), (2, 6, 0.1)])
def test_neohookean_matches_reference(dim, n, stretch):
    """tests/test_cases3d.py:50-63: converged, genuinely nonlinear (3D),
    the pulled face where it was put."""
    t, tV, _ = t_nh.run(t_nh.NeoHookeanConfig(n=n, dim=dim,
                                              stretch=stretch), **F64)
    j, _, _ = j_nh.run(j_nh.NeoHookeanConfig(n=n, dim=dim, stretch=stretch))
    assert_same_solve(t, j)
    if dim == 3:
        assert t.newton_iters >= 2
        uu = t.u.numpy().reshape(-1, 3)
        right = np.abs(tV.dof_coords[:, 0] - 1) < 1e-12
        np.testing.assert_allclose(uu[right, 0], 0.2, atol=1e-12)
    assert t.phase_s["tangent"] > 0.0 and t.phase_s["lambda_max"] == 0.0


def test_cases_default_to_the_card():
    """``run`` without ``device=`` runs on CUDA, and raises without it."""
    for mod, cfg in ((t_e3d, t_e3d.Elasticity3DConfig(n=1)),
                     (t_nh, t_nh.NeoHookeanConfig(n=1))):
        if torch.cuda.is_available():
            assert mod.run(cfg, dtype=torch.float64)[0].u.is_cuda
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                mod.run(cfg)
