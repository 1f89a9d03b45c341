"""tpufem_torch host preprocessing against tpufem's: meshes, dofmaps,
boundary conditions, the glibc random stream and the lane plan must be
EXACTLY equal (they are copies of the same NumPy code; the port's lane
plan is also checked with its native host library switched off, against
the reference built with it)."""

import dataclasses

import numpy as np
import pytest
import torch

import tpufem.cases.mechanic2d as j_m2d
import tpufem.cases.polycrystal as j_poly
import tpufem.lane.plan as j_plan
import tpufem.mesh as j_mesh
import tpufem.spaces as j_spaces
import tpufem.spaces.bc as j_bc
import tpufem.utils as j_utils
import tpufem_torch.cases.mechanic2d as t_m2d
import tpufem_torch.cases.polycrystal as t_poly
import tpufem_torch.lane.plan as t_plan
import tpufem_torch.mesh as t_mesh
import tpufem_torch.spaces as t_spaces
import tpufem_torch.spaces.bc as t_bc
import tpufem_torch.utils as t_utils
from tpufem_torch.utils.convert import (lane_plan_fields,
                                        lane_plan_from_numpy, to_torch)
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _assert_same(a, b, name):
    if a is None or b is None:
        assert a is None and b is None, name
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{name}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), name
    else:
        assert a == b, name


def _assert_plans_equal(pt, pj):
    names = [f.name for f in dataclasses.fields(t_plan.LanePlan)]
    assert names == [f.name for f in dataclasses.fields(j_plan.LanePlan)]
    for nm in names:
        _assert_same(getattr(pt, nm), getattr(pj, nm), nm)


def _meshes(kind):
    if kind == "square":
        return t_mesh.unit_square(40), j_mesh.unit_square(40), 8
    return (t_poly.generate_polycrystal(32, n_grains=12),
            j_poly.generate_polycrystal(32, n_grains=12), 16)


@pytest.mark.parametrize("kind", ["square", "polycrystal"])
def test_mesh_and_dofmaps_equal(kind):
    mt, mj, _ = _meshes(kind)
    assert np.array_equal(mt.x, mj.x)
    assert np.array_equal(mt.cells, mj.cells)
    assert mt.cell_type == mj.cell_type
    if kind == "polycrystal":
        assert np.array_equal(mt.cell_tags, mj.cell_tags)
    for deg, bs in ((1, 2), (1, 1), (0, 1)):
        Vt = t_spaces.FunctionSpace.create(mt, deg, bs=bs)
        Vj = j_spaces.FunctionSpace.create(mj, deg, bs=bs)
        assert Vt.n_dofs == Vj.n_dofs
        assert np.array_equal(Vt.dofmap, Vj.dofmap)
        assert np.array_equal(Vt.vector_dofmap(), Vj.vector_dofmap())
        assert np.array_equal(Vt.dof_coords, Vj.dof_coords)


def test_combine_bcs_equal():
    mt, mj, _ = _meshes("square")
    out = []
    for sp, bc, mesh in ((t_spaces, t_bc, mt), (j_spaces, j_bc, mj)):
        V = sp.FunctionSpace.create(mesh, 1, bs=2)
        left = bc.locate_dofs_geometrical(
            V, lambda x: np.abs(x[:, 0]) < 1e-12)
        right = bc.locate_dofs_geometrical(
            V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
        bcs = [sp.DirichletBC(V, left, [0.0, 0.0]),
               sp.DirichletBC(V, right, [0.01, 0.0])]
        out.append(bc.combine_bcs(bcs, V.n_dofs))
    for a, b in zip(*out):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_glibc_rand_and_young_modulus_equal():
    rt, rj = t_utils.GlibcRand(6575), j_utils.GlibcRand(6575)
    assert [rt.rand() for _ in range(500)] == [rj.rand() for _ in range(500)]
    for ecst in (False, True):
        assert np.array_equal(t_m2d.young_modulus_range(ecst),
                              j_m2d.young_modulus_range(ecst))
    x = np.random.default_rng(0).random((50, 2))
    assert np.array_equal(t_m2d.volumetric_load(x), j_m2d.volumetric_load(x))


def test_damage_seeds_and_adjacency_equal():
    import tpufem.cases.damage as j_dmg
    import tpufem_torch.cases.damage as t_dmg

    mt, mj, _ = _meshes("polycrystal")
    st = t_poly.damage_seed_nodes(mt, n_chains=30)
    sj = j_poly.damage_seed_nodes(mj, n_chains=30)
    assert len(st) and np.array_equal(st, sj)
    nt, _, wt = t_dmg.node_adjacency_ell(mt)
    nj, _, wj = j_dmg.node_adjacency_ell(mj)
    assert np.array_equal(nt, nj) and np.array_equal(wt, wj)
    d0 = np.zeros(mt.n_nodes)
    d0[st] = 1.0
    host = t_dmg.smooth_damage(mt, d0, iterations=4, backend="host")
    dev = t_dmg.smooth_damage(mt, d0, iterations=4, backend="device",
                              device="cpu", dtype=torch.float64)
    ref = np.asarray(j_dmg.smooth_damage(mj, d0, iterations=4,
                                         backend="host"))
    assert np.array_equal(host, ref)
    # the device loop adds the neighbours in the same left-to-right order
    assert np.array_equal(dev.numpy(), ref)


@pytest.mark.parametrize("kind", ["square", "polycrystal"])
@pytest.mark.parametrize("native_lib", [True, False])
def test_lane_plan_equal(kind, native_lib, monkeypatch):
    import tpufem_torch.native as t_native

    if native_lib:
        if not t_native.available():
            pytest.skip("no C++ compiler: native host library unavailable")
    else:  # force every NumPy fallback of the port
        monkeypatch.setattr(t_native, "_lib", None)
        monkeypatch.setattr(t_native, "_build_failed", True)
        assert not t_native.available()
    mt, mj, wg_own = _meshes(kind)
    pt = t_plan.build_lane_plan(mt.x, mt.cells, wg_own=wg_own)
    pj = j_plan.build_lane_plan(mj.x, mj.cells, wg_own=wg_own)
    _assert_plans_equal(pt, pj)
    assert pt.owned_mask.sum() == mt.n_nodes
    assert (pt.cell_order >= 0).sum() == mt.n_cells


def test_plan_hand_over_round_trip():
    _, mj, wg_own = _meshes("polycrystal")
    pj = j_plan.build_lane_plan(mj.x, mj.cells, wg_own=wg_own)
    pt = lane_plan_from_numpy(lane_plan_fields(pj))
    assert isinstance(pt, t_plan.LanePlan)
    _assert_plans_equal(pt, pj)
    u = np.random.default_rng(1).standard_normal(mj.n_nodes * 2)
    assert np.array_equal(pt.to_lane(u, 2), pj.to_lane(u, 2))
    assert np.array_equal(pt.from_lane(pt.to_lane(u, 2), 2), u)
    with pytest.raises(KeyError):
        lane_plan_from_numpy({"not_a_field": 1})
    t = to_torch(u, device="cpu", dtype=torch.float64)
    assert t.dtype == torch.float64 and np.array_equal(t.numpy(), u)
