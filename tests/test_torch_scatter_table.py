"""K2 ``lane_scatter_cm``'s inverse table (``kernels.scatter_cm_table``)
and the kernel's walk of it, on the CPU: the table against a brute-force
loop, the walk in the kernel's order (``scatter_cm_table_walk_plain``)
exactly equal to ``lane_scatter_cm_plain`` on random and real lane plans,
the launch geometry (every output written once), and the engine handing
its table to K2. Host-only and cheap: no JAX, no solve."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpufem_torch.lane import kernels as tk
from tpufem_torch.lane.plan import build_lane_plan
from tpufem_torch.mesh import box, unit_square
from tpufem_torch.spaces import FunctionSpace

torch.set_num_threads(1)

L = 128


def _idx(rng, T, V, K, k_out, p_missing, idt):
    idx = rng.integers(0, k_out, size=(T, V, K, L))
    idx[rng.random(idx.shape) < p_missing] = -1
    return idx.astype(idt)


def _brute(idx, k_out):
    """The table by a loop over (t, j, v, k): per column, the slots of its
    real entries row by row, ascending e within a row."""
    T, V, K, _ = idx.shape
    per = {}
    for t in range(T):
        for j in range(L):
            rows = [[] for _ in range(k_out)]
            for v in range(V):
                for k in range(K):
                    r = int(idx[t, v, k, j])
                    if 0 <= r < k_out:
                        rows[r].append(v * K + k)
            per[t, j] = rows
    return per


def _check_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a, b)


@pytest.mark.parametrize("T,V,K,k_out,p_missing,idt", [
    (3, 3, 8, 16, 0.2, np.int8),  # a P1 triangle plan's shapes, int8
    (2, 27, 8, 40, 0.55, np.int32),  # Q2's V * K = 216: int16 slots
    (2, 4, 12, 33, 0.0, np.int32),  # no padding
    (2, 3, 4, 1, 0.5, np.int8),  # one output row
    (2, 3, 5, 9, 1.0, np.int8),  # every entry padding
])
def test_table_matches_brute_force(T, V, K, k_out, p_missing, idt):
    rng = np.random.default_rng(11)
    idx = _idx(rng, T, V, K, k_out, p_missing, idt)
    idx[0, 0, 0, :4] = k_out + 3 if idt == np.int32 else 127  # outside
    tab = tk.scatter_cm_table(torch.from_numpy(idx), k_out)
    assert tab.slots.dtype == (torch.int8 if V * K <= 127 else torch.int16)
    assert tab.off.dtype == tab.slots.dtype
    assert (tab.V, tab.K, tab.k_out) == (V, K, k_out)
    per = _brute(idx, k_out)
    most = max(sum(len(r) for r in rows) for rows in per.values())
    assert tab.slots.shape == (T, max(most, 1), L)
    assert tab.off.shape == (T, k_out + 1, L)
    slots, off = tab.slots.numpy().astype(int), tab.off.numpy().astype(int)
    for (t, j), rows in per.items():
        flat = [e for r in rows for e in r]
        assert off[t, 0, j] == 0
        assert list(np.diff(off[t, :, j])) == [len(r) for r in rows]
        assert list(slots[t, :len(flat), j]) == flat
        assert (slots[t, len(flat):, j] == 0).all()  # unused: 0
    assert tab.nbytes == slots.size * tab.slots.element_size() + \
        off.size * tab.off.element_size()
    # the same from an array
    tab2 = tk.scatter_cm_table(idx, k_out)
    _check_equal(tab2.slots, tab.slots)
    _check_equal(tab2.off, tab.off)


def _walk_case(rng, kind, idt):
    """(idx, k_out, C) of an edge table."""
    if kind == "heavy_padding":
        return _idx(rng, 3, 3, 16, 24, 0.85, idt), 24, 2
    if kind == "all_padding_bin":
        idx = _idx(rng, 3, 4, 8, 20, 0.3, idt)
        idx[1] = -1
        return idx, 20, 3
    if kind == "k_out_1":
        return _idx(rng, 2, 3, 8, 1, 0.4, idt), 1, 2
    if kind == "row_of_23":
        # one row of one column gets 23 sources (a P1-tet plan's most)
        idx = _idx(rng, 2, 4, 24, 30, 0.3, idt)
        idx[1, :, :, 5] = rng.integers(1, 30, size=(4, 24))
        idx[1, 0, :23, 5] = 0
        idx[1, 1:, :, 5][idx[1, 1:, :, 5] == 0] = 1
        return idx, 30, 3
    if kind == "five_channels":
        return _idx(rng, 2, 3, 8, 12, 0.3, idt), 12, 5
    raise AssertionError(kind)


@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("idt", [np.int8, np.int32])
@pytest.mark.parametrize("kind", ["heavy_padding", "all_padding_bin",
                                  "k_out_1", "row_of_23", "five_channels"])
def test_walk_equals_plain(kind, idt, vdt):
    rng = np.random.default_rng(12)
    idx, k_out, C = _walk_case(rng, kind, idt)
    T, V, K, _ = idx.shape
    tab = tk.scatter_cm_table(idx, k_out)
    if kind == "row_of_23":
        cnt = np.diff(tab.off.numpy().astype(int), axis=1)
        assert cnt.max() == 23 == cnt[1, 0, 5]
    src = torch.from_numpy(rng.standard_normal((V * C, T, K, L))).to(vdt)
    ti = torch.from_numpy(idx)
    ref = tk.lane_scatter_cm_plain(src, ti, k_out=k_out, n_ch=C)
    _check_equal(tk.scatter_cm_table_walk_plain(src, tab, n_ch=C), ref)
    # a CPU tensor takes the plain version, with or without a table
    _check_equal(tk.lane_scatter_cm(src, ti, k_out=k_out, n_ch=C,
                                    table=tab), ref)
    _check_equal(tk.lane_scatter_cm(src, ti, k_out=k_out, n_ch=C), ref)


def _plan_idx(V, wg_own):
    p = build_lane_plan(V.dof_coords, np.asarray(V.dofmap), wg_own=wg_own)
    return p.gather_idx.astype(np.int8 if p.wg < 127 else np.int32), p.wg


def _polycrystal16():
    from tpufem_torch.cases import polycrystal

    mesh = polycrystal.generate_polycrystal(16, n_grains=12)
    return FunctionSpace.create(mesh, 1, bs=2), 16


@pytest.mark.parametrize("plan", ["polycrystal_n16", "q2_box3",
                                  "p1_tet_box4"])
def test_walk_equals_plain_on_real_plans(plan):
    V, wg_own = {
        "polycrystal_n16": _polycrystal16,
        "q2_box3": lambda: (FunctionSpace.create(box(3, 3, 3), 2, bs=3),
                            32),
        "p1_tet_box4": lambda: (FunctionSpace.create(
            box(4, 4, 4, cell_type="tetra"), 1, bs=3), 32),
    }[plan]()
    idx, wg = _plan_idx(V, wg_own)
    T, nv, K, _ = idx.shape
    tab = tk.scatter_cm_table(idx, wg)
    assert tab.slots.dtype == (torch.int8 if nv * K <= 127 else torch.int16)
    rng = np.random.default_rng(13)
    for vdt in (torch.float32, torch.float64):
        src = torch.from_numpy(
            rng.standard_normal((nv * V.bs, T, K, L))).to(vdt)
        ref = tk.lane_scatter_cm_plain(src, torch.from_numpy(idx), k_out=wg,
                                       n_ch=V.bs)
        _check_equal(tk.scatter_cm_table_walk_plain(src, tab, n_ch=V.bs),
                     ref)


@settings(max_examples=25, deadline=None, database=None)
@given(T=st.integers(1, 3), V=st.integers(1, 5), K=st.integers(1, 12),
       k_out=st.integers(1, 40), C=st.integers(1, 4),
       p_missing=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 16))
def test_walk_equals_plain_on_random_shapes(T, V, K, k_out, C, p_missing,
                                            seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-2, k_out + 2, size=(T, V, K, L))
    idx[rng.random(idx.shape) < p_missing] = -1
    idx = idx.astype(np.int32)
    tab = tk.scatter_cm_table(idx, k_out)
    src = torch.from_numpy(rng.standard_normal((V * C, T, K, L)))
    ref = tk.lane_scatter_cm_plain(src, torch.from_numpy(idx), k_out=k_out,
                                   n_ch=C)
    _check_equal(tk.scatter_cm_table_walk_plain(src, tab, n_ch=C), ref)


def test_table_refuses_what_int16_cannot_hold():
    with pytest.raises(ValueError, match="32767"):
        tk.scatter_cm_table(np.zeros((1, 2, 16384, L), np.int32), 4)
    with pytest.raises(ValueError):
        tk.scatter_cm_table(np.zeros((1, 2, 4, L), np.int32), 0)
    # k_out is a sort key in int16 too
    with pytest.raises(ValueError, match="32767"):
        tk.scatter_cm_table(np.zeros((1, 2, 4, L), np.int32), 32768)
    tk.scatter_cm_table(np.zeros((1, 2, 4, L), np.int32), 32767)


def test_table_is_tied_to_the_tensor_it_was_built_from():
    """A table built from a tensor records that tensor (the only one a call
    on the card takes it with) and lies on its device; one built from an
    array records none."""
    idx = _idx(np.random.default_rng(15), 2, 3, 8, 16, 0.2, np.int8)
    ti = torch.from_numpy(idx)
    tab = tk.scatter_cm_table(ti, 16)
    assert tab.idx is ti
    assert tab.slots.device == ti.device and tab.off.device == ti.device
    assert tk.scatter_cm_table(idx, 16).idx is None


@pytest.mark.parametrize("k_out,C,V,K,vbytes", [
    (1, 1, 3, 8, 4), (16, 2, 3, 8, 4), (17, 2, 3, 8, 8),
    (40, 2, 3, 32, 4),  # the n = 1024 polycrystal plan
    (56, 2, 3, 64, 8),  # the generic r = 7 plan
    (176, 3, 27, 8, 4),  # Q2 box(40)
    (272, 3, 4, 96, 8),  # the P1-tet plan the first design banded
    (700, 3, 4, 96, 8), (33, 5, 3, 8, 4), (12, 6, 3, 8, 8),
    (31, 8, 2, 4, 4), (97, 7, 2, 4, 8)])
def test_scatter_cm_geometry_writes_each_output_once(k_out, C, V, K,
                                                     vbytes):
    """Every (row, lane) of a bin's output is written by exactly one thread
    of each channel block; the channel blocks cover C; a block has at most
    1 024 threads; the staged tile fits a block."""
    g = tk.scatter_cm_geometry(k_out, C, V, K, vbytes)
    assert (tk.scatter_cm_cover(g, k_out) == 1).all()
    assert 1 <= g["cb"] <= 3 and g["cb"] * g["channel_blocks"] == C
    assert g["block"][0] * g["block"][1] <= 1024
    assert g["smem"] <= tk.SMEM_PER_BLOCK
    assert g["smem"] == (V * g["cb"] * K * 32 * vbytes if g["staged"]
                         else 0)


@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("vbytes", [4, 8])
def test_scatter_cm_geometry_stages_every_int8_table(C, vbytes):
    """Where V * K <= 127 (int8 slots) the slab's tile always fits a
    block: the kernel has no L1 route for int8 tables."""
    for V, K in ((1, 127), (3, 42), (27, 4), (127, 1)):
        for k_out in (1, 56, 300):
            assert tk.scatter_cm_geometry(k_out, C, V, K, vbytes)["staged"]


def test_scatter_cm_geometry_refuses_empty_shapes():
    for args in ((0, 2, 3, 8, 4), (4, 0, 3, 8, 4), (4, 2, 0, 8, 4),
                 (4, 2, 3, 8, 2)):
        with pytest.raises(ValueError):
            tk.scatter_cm_geometry(*args)


def test_engine_builds_its_table_and_hands_it_to_k2(monkeypatch):
    from tpufem_torch.forms import EnergyFunctional, linear_elastic_psi
    from tpufem_torch.forms.form import Term
    from tpufem_torch.lane import LaneEngine
    from tpufem_torch.lane import engine as E

    V = FunctionSpace.create(unit_square(6), 1, bs=2)
    F = EnergyFunctional(V, [Term(lambda qp: linear_elastic_psi(
        qp.eps, 1.0e6, 0.3), 1)], device="cpu", dtype=torch.float64)
    eng = LaneEngine(F, [], wg_own=8, device="cpu", dtype=torch.float64)
    p = eng.plan
    ref = tk.scatter_cm_table(p.gather_idx, p.wg)
    _check_equal(eng.scatter_table.slots, ref.slots)
    _check_equal(eng.scatter_table.off, ref.off)
    assert eng.scatter_table.idx is eng.gather_idx
    seen = []

    def spy(src, idx, **kw):
        seen.append(kw.get("table"))
        return tk.lane_scatter_cm(src, idx, **kw)

    monkeypatch.setattr(E, "lane_scatter_cm", spy)
    rng = np.random.default_rng(14)
    ul = eng.to_lane_dev(torch.from_numpy(rng.standard_normal(V.n_dofs)))
    cc = eng.prepare_coeffs({})
    eng.residual(ul, cc)
    eng.make_tangent(ul, cc, eng.linearize(ul, cc))(ul)
    assert len(seen) >= 2 and all(t is eng.scatter_table for t in seen)
