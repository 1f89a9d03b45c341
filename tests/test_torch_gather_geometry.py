"""Host-side launch geometry and argument checks of the windowed gathers
K1 ``lane_gather_cm``, K5 ``lane_gather_weighted`` and K9 ``lane_gather``
and of the windowed scatter K11 ``lane_scatter_weighted``, whose kernels
stage each bin's window (and K11 its accumulator) in shared memory (blocks
of 32 lane columns). No kernel runs here: the kernels themselves are held
against their plain versions on the card by ``chip_smoke.py``, and the
plain versions against the Pallas kernels in ``test_torch_kernels.py`` /
``test_torch_twolevel.py`` / ``test_torch_lane_primitives.py``."""

import pytest
import torch

from tpufem_torch.lane import kernels as tk

L = 128
GEOMETRIES = {"gather_cm": tk.gather_cm_geometry,
              "gather_weighted": tk.gather_weighted_geometry}
# (kernel, T, V, K, wr, C): the n = 1024 plan's tables -- K1 (V 3, K 32,
# wg 40), K5 restriction (V 24, K 16, wr 288) and prolongation (V 4, K 40,
# wr 72) -- and small odd ones
SHAPES = [("gather_cm", 514, 3, 32, 40, 2),
          ("gather_weighted", 289, 24, 16, 288, 2),
          ("gather_weighted", 514, 4, 40, 72, 2),
          ("gather_cm", 1, 3, 1, 1, 1),
          ("gather_weighted", 1, 2, 1, 8, 4),
          ("gather_cm", 3, 3, 17, 13, 3),
          ("gather_weighted", 5, 3, 45, 126, 1),
          ("gather_weighted", 2, 24, 33, 600, 1),
          ("gather_cm", 2, 3, 33, 0, 2)]


@pytest.mark.parametrize("vbytes,ibytes", [(4, 1), (8, 4)])
@pytest.mark.parametrize("kernel,T,V,K,wr,C", SHAPES)
def test_gather_geometry_covers_every_output_once(kernel, T, V, K, wr, C,
                                                  vbytes, ibytes):
    """Blocks of 32 lane columns, one per (bin, slab): every (t, k, lane)
    output is written exactly once; the thread rows split K evenly (no pass
    of a thread row is idle) and a block holds at most 512 threads. K1
    stages its index rows; K5 stages its index and weight rows where two
    blocks still share an SM, else none. The shared memory is the window
    and the staged tables."""
    g = GEOMETRIES[kernel](C, V, wr, K, vbytes, ibytes)
    lb, ky = g["block"]
    weighted = kernel == "gather_weighted"
    staged = tk.gather_layout_bytes(C, V, wr, K, vbytes, ibytes, weighted)
    assert lb == tk.GATHER_LB == 32 and g["slabs"] * lb == L
    assert 1 <= ky <= K and lb * ky <= 512
    assert (g["rows_per_thread"] - 1) * ky < K <= g["rows_per_thread"] * ky
    assert g["tiles"] == (not weighted or 2 * (staged + tk.SMEM_RESERVED)
                          <= tk.SMEM_PER_SM)
    assert g["smem"] == tk.gather_layout_bytes(
        C, V, wr, K, vbytes, ibytes, weighted, g["tiles"])
    assert g["smem"] <= tk.SMEM_PER_BLOCK
    cover = tk.gather_cover(g, T, K)
    assert cover.shape == (T, K, L)
    assert cover.min() == 1 and cover.max() == 1


@pytest.mark.parametrize("vbytes", [4, 8])
def test_gather_geometry_fits_the_main_path(vbytes):
    """The n = 1024 windows and tables fit a block's shared memory in
    float32 and float64: K1 (40 rows, V 3, K 32, int8) and the prolongation
    (72 rows, V 4, K 40, int8) stage their tables, at 8 thread rows; the
    restriction (288 rows, V 24, K 16, int32) stages its window alone
    (73.7 / 147.5 KB: with its tables a block would hold an SM alone) and
    takes 16 thread rows."""
    k1 = tk.gather_cm_geometry(2, 3, 40, 32, vbytes, 1)
    pro = tk.gather_weighted_geometry(2, 4, 72, 40, vbytes, 1)
    res = tk.gather_weighted_geometry(2, 24, 288, 16, vbytes, 4)
    assert k1["tiles"] and pro["tiles"] and not res["tiles"]
    assert (k1["ky"], pro["ky"], res["ky"]) == (8, 8, 16)
    assert k1["smem"] == 2 * 40 * 32 * vbytes + 3 * 32 * 32
    assert pro["smem"] == 2 * 72 * 32 * vbytes + 4 * 40 * 32 * (1 + vbytes)
    assert res["smem"] == 2 * 288 * 32 * vbytes


def test_gather_geometry_raises_past_the_limit():
    """Where the window (K5) does not fit 227 KB: ValueError naming the
    shape, no fallback; where the window and the index rows (K1) do not,
    K1 stages nothing and reads global memory; K5 takes at most four
    channels; K must be at least 1."""
    # the window, C * wr rows of 128 bytes (float32) or 256 (float64), and
    # for K1 K = 4 index rows of 32 bytes (int8): the last window that
    # fits, and one row more
    for geo, wr, C, vb, ib in ((tk.gather_cm_geometry, 1815, 1, 4, 1),
                               (tk.gather_weighted_geometry, 1816, 1, 4, 1),
                               (tk.gather_weighted_geometry, 908, 1, 8, 4),
                               (tk.gather_weighted_geometry, 454, 2, 8, 1),
                               (tk.gather_cm_geometry, 907, 2, 4, 1)):
        assert geo(C, 1, wr, 4, vb, ib)["smem"] <= tk.SMEM_PER_BLOCK
        if geo is tk.gather_cm_geometry:
            assert geo(C, 1, wr, 4, vb, ib)["tiles"]
            g = geo(C, 1, wr + 1, 4, vb, ib)
            assert not g["tiles"] and g["smem"] == 0
            continue
        with pytest.raises(ValueError, match=f"wr = {wr + 1} rows"):
            geo(C, 1, wr + 1, 4, vb, ib)
    for geo in GEOMETRIES.values():
        with pytest.raises(ValueError):
            geo(2, 3, 40, 0, 4, 1)
    with pytest.raises(ValueError, match="at most 4"):
        tk.gather_weighted_geometry(5, 3, 8, 8, 4, 1)
    assert tk.gather_cm_geometry(5, 3, 8, 8, 4, 1)["smem"] == (
        5 * 8 * 32 * 4 + 3 * 8 * 32)


@pytest.mark.parametrize("vbytes,ibytes,tiles", [(8, 4, False),
                                                  (4, 4, True)])
def test_gather_cm_geometry_reads_global_memory_for_3d_windows(
        vbytes, ibytes, tiles):
    """A 3D plan's K1 shape, P1 tetrahedra at box(48) (C = 3 channels,
    V = 4, a window of wr = 272 rows, K = 184 cell rows, int32 indices):
    in float64 the window and the index rows take 303 104 bytes, more than
    a block holds, so the block reads both from global memory (no shared
    memory, about 16 thread rows); in float32 they fit and are staged.
    Either way every output is written once."""
    g = tk.gather_cm_geometry(3, 4, 272, 184, vbytes, ibytes)
    staged = tk.gather_layout_bytes(3, 4, 272, 184, vbytes, ibytes, False)
    assert (staged <= tk.SMEM_PER_BLOCK) == tiles == g["tiles"]
    assert g["smem"] == (staged if tiles else 0)
    lb, ky = g["block"]
    assert lb * ky <= 512
    assert ky == (8 if tiles else 16)
    cover = tk.gather_cover(g, 2, 184)
    assert cover.min() == 1 and cover.max() == 1


def _tables(T=3, V=2, K=5, C=2, R=24):
    g = torch.Generator().manual_seed(3)
    starts = torch.tensor([0, 8, 16], dtype=torch.int32)[:T]
    idx = torch.randint(-1, 8, (T, V, K, L), generator=g).to(torch.int8)
    wts = torch.randn((T, V, K, L), generator=g)
    return starts, idx, wts


def test_gather_wrappers_refuse_misaligned_or_strided_values():
    """The kernels copy ``values`` and ``idx`` by 16-byte asynchronous
    copies: the wrappers' host checks (run before any launch, on any
    device) refuse values or indices that are not 16-byte aligned, values
    that are not contiguous, and give the geometry for those that are."""
    starts, idx, wts = _tables()
    good = torch.zeros((2, 24, L))
    shifted = torch.zeros(2 * 24 * L + 1)[1:].view(2, 24, L)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    strided = torch.zeros((24, 2, L)).transpose(0, 1)
    checks = (lambda v: tk.check_gather_cm(v, starts, idx, wr=8, n_ch=4),
              lambda v: tk.check_gather_weighted(v, starts, idx, wts, wr=8))
    for check, geo in zip(checks, GEOMETRIES.values()):
        assert check(good) == geo(2, 2, 8, 5, 4, 1)
        with pytest.raises(ValueError, match="16-byte aligned"):
            check(shifted)
        with pytest.raises(ValueError, match="contiguous"):
            check(strided)
    idx_shifted = torch.zeros(idx.numel() + 1, dtype=torch.int8)[1:].view(
        idx.shape)
    idx_shifted.copy_(idx)
    for check in (
            lambda: tk.check_gather_cm(good, starts, idx_shifted, wr=8,
                                       n_ch=4),
            lambda: tk.check_gather_weighted(good, starts, idx_shifted, wts,
                                             wr=8)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            check()
    with pytest.raises(ValueError, match="n_ch"):
        tk.check_gather_cm(good, starts, idx, wr=8, n_ch=6)
    with pytest.raises(ValueError, match="shape"):
        tk.check_gather_weighted(good, starts, idx, wts[:, :1].contiguous(),
                                 wr=8)


# K9 lane_gather: (T, V, K, wr, C): the n = 1024 plan's K1 tables, small
# odd ones, and windows or index rows too large to stage (read from global
# memory instead)
K9_SHAPES = [(514, 3, 32, 40, 2), (1, 3, 1, 1, 1), (3, 24, 17, 13, 3),
             (5, 3, 45, 126, 2), (2, 3, 33, 0, 2), (3, 2, 3, 2000, 4),
             (2, 600, 100, 8, 1)]


@pytest.mark.parametrize("vbytes,ibytes", [(4, 1), (4, 4), (8, 1), (8, 4)])
@pytest.mark.parametrize("T,V,K,wr,C", K9_SHAPES)
def test_k9_geometry_covers_every_output_once(T, V, K, wr, C, vbytes,
                                              ibytes):
    """K9 (both modes): blocks of 32 lane columns, one per (bin, slab); the
    thread writing (t, k, lane) writes it for every channel and v, so every
    output (t, c, [v,] k, lane) is written exactly once. The block stages
    the window and the index rows where they fit a block's shared memory,
    else reads global memory (no shared memory): no shape raises."""
    g = tk.gather_geometry(C, V, wr, K, vbytes, ibytes)
    lb, ky = g["block"]
    staged = tk.gather_layout_bytes(C, V, wr, K, vbytes, ibytes, False)
    assert lb == 32 and g["slabs"] * lb == L and lb * ky <= 512
    assert (g["rows_per_thread"] - 1) * ky < K <= g["rows_per_thread"] * ky
    assert g["tiles"] == (staged <= tk.SMEM_PER_BLOCK)
    assert g["smem"] == (staged if g["tiles"] else 0)
    assert g["wr"] == wr
    cover = tk.gather_cover(g, T, K)
    assert cover.min() == 1 and cover.max() == 1


# K11 lane_scatter_weighted: (T, C, D, sk, k_out): the n = 1024 prolongation
# tables in the adjoint direction, odd ones, k_out at the first design's
# limit (float32), channel groups, and D too large to stage the tables
K11_SHAPES = [(514, 2, 4, 40, 72), (3, 2, 1, 13, 21), (2, 2, 4, 9, 1),
              (2, 3, 3, 126, 50), (1, 2, 4, 40, 454), (1, 3, 4, 40, 440),
              (1, 1, 700, 3, 5), (2, 2, 4, 0, 7), (1, 5, 2, 3000, 3),
              (1, 40, 2, 8, 6)]


@pytest.mark.parametrize("vbytes,ibytes", [(4, 1), (4, 4), (8, 1), (8, 4)])
@pytest.mark.parametrize("T,C,D,sk,k_out", K11_SHAPES)
def test_k11_geometry_covers_every_output_once(T, C, D, sk, k_out, vbytes,
                                               ibytes):
    """K11: blocks of 32 lane columns per (bin, channel group); thread row
    y adds channels y, y + ky, ... of the group, and every thread writes
    back rows of the block's slab: every output (t, c, q, lane) exactly
    once. The chunks of rc window rows cover the sk rows, equal but for
    the last. The shared memory is the accumulator and one chunk, and
    ``blocks`` of them fit an SM: two or more wherever a chunk of
    SCATTER_MIN_ROWS rows (fewer where sk is smaller) leaves room for
    two."""
    g = tk.scatter_weighted_geometry(C, D, sk, k_out, vbytes, ibytes)
    lb, ky = g["block"]
    assert lb == 32 and g["slabs"] * lb == L and lb * ky <= 512
    assert 1 <= g["cb"] <= C and g["groups"] == -(-C // g["cb"])
    assert ky == min(max(g["cb"], tk.SCATTER_KY), tk.SCATTER_KY_MAX)
    assert g["rc"] >= 1 and g["chunks"] == -(-sk // g["rc"])
    assert sk == 0 or (g["chunks"] - 1) * g["rc"] < sk
    assert g["smem"] == tk.scatter_layout_bytes(
        g["cb"], k_out, g["rc"], D, vbytes, ibytes, g["tiles"])
    assert g["smem"] <= tk.SMEM_PER_BLOCK
    nb = g["blocks"]
    assert 1 <= nb <= max(tk.SCATTER_REG_ROWS // ky, 1)
    assert nb * (g["smem"] + tk.SMEM_RESERVED) <= tk.SMEM_PER_SM
    rmin = min(max(sk, 1), tk.SCATTER_MIN_ROWS)
    least = tk.scatter_layout_bytes(1, k_out, rmin, D, vbytes, ibytes, False)
    assert nb >= 2 or 2 * (least + tk.SMEM_RESERVED) > tk.SMEM_PER_SM
    cover = tk.scatter_cover(g, T if T < 8 else 2, C, k_out)
    assert cover.min() == 1 and cover.max() == 1


@pytest.mark.parametrize("vbytes,ibytes", [(4, 1), (4, 4), (8, 1), (8, 4)])
def test_k9_k11_geometry_fits_the_main_path(vbytes, ibytes):
    """The n = 1024 shapes in every type pair: K9 at K1's tables stages
    its window and index rows at 8 thread rows; K11 at the adjoint of the
    prolongation keeps both channels in one block (the tables read once)
    with its tables staged, at 4 thread rows, in four chunks of 10 rows:
    eight blocks an SM in float32 / int8 (27 392 bytes), four in float64 /
    int32 (57 344 bytes)."""
    g9 = tk.gather_geometry(2, 3, 40, 32, vbytes, ibytes)
    assert g9["tiles"] and g9["ky"] == 8
    assert g9["smem"] == 2 * 40 * 32 * vbytes + 3 * 32 * 32 * ibytes
    g11 = tk.scatter_weighted_geometry(2, 4, 40, 72, vbytes, ibytes)
    assert g11["tiles"] and g11["cb"] == 2 and g11["groups"] == 1
    assert (g11["ky"], g11["chunks"], g11["rc"]) == (4, 4, 10)
    assert g11["blocks"] >= 4
    if (vbytes, ibytes) == (4, 1):
        assert (g11["blocks"], g11["smem"]) == (8, 27392)
    if (vbytes, ibytes) == (8, 4):
        assert (g11["blocks"], g11["smem"]) == (4, 57344)


def test_k9_k11_take_every_shape_the_first_designs_took():
    """The first K9 took any shape (no shared memory), the first K11 any C,
    D and sk with k_out * 128 values in 227 KB: each now gets a geometry,
    no ValueError. K11 raises only past that, where one channel's
    accumulator and one window row of 32 lanes leave no room."""
    for C, V, wr, K in ((1, 1, 1, 1), (64, 3, 40, 32), (4, 2, 5000, 3),
                        (2, 500, 40, 200), (2, 3, 0, 4), (2, 3, -5, 4)):
        for vb, ib in ((4, 1), (8, 4)):
            assert tk.gather_geometry(C, V, wr, K, vb, ib)["smem"] <= (
                tk.SMEM_PER_BLOCK)
    for vb in (4, 8):
        limit = tk.SMEM_PER_BLOCK // (L * vb)  # the first design's k_out
        for C in (1, 2, 9):
            for D in (0, 1, 4, 2000):
                for sk in (0, 1, 40, 5000):
                    for k_out in (1, limit):
                        for ib in (1, 4):
                            g = tk.scatter_weighted_geometry(C, D, sk, k_out,
                                                             vb, ib)
                            assert g["smem"] <= tk.SMEM_PER_BLOCK
        last = (tk.SMEM_PER_BLOCK - 32 * vb) // (32 * vb)
        assert tk.scatter_weighted_geometry(1, 4, 8, last, vb, 4)
        with pytest.raises(ValueError, match=f"k_out = {last + 1} rows"):
            tk.scatter_weighted_geometry(1, 4, 8, last + 1, vb, 4)
    with pytest.raises(ValueError):
        tk.scatter_weighted_geometry(2, 4, 8, 0, 4, 1)


def test_k9_k11_wrappers_refuse_misaligned_or_strided_inputs():
    """K9 and K11 copy the values (src), the index rows and (K11) the
    weight rows by 16-byte asynchronous copies: their host checks refuse
    any of them where it is not 16-byte aligned, and values that are not
    contiguous."""
    starts, idx, _ = _tables()
    good = torch.zeros((2, 24, L))
    shifted = torch.zeros(2 * 24 * L + 1)[1:].view(2, 24, L)
    strided = torch.zeros((24, 2, L)).transpose(0, 1)
    idx_shifted = torch.zeros(idx.numel() + 1, dtype=torch.int8)[1:].view(
        idx.shape)
    assert tk.check_gather(good, starts, idx, wr=8) == tk.gather_geometry(
        2, 2, 8, 5, 4, 1)
    for v, ix, what in ((shifted, idx, "16-byte aligned"),
                        (good, idx_shifted, "16-byte aligned"),
                        (strided, idx, "contiguous")):
        with pytest.raises(ValueError, match=what):
            tk.check_gather(v, starts, ix, wr=8)
    # K11: dest (T, D, sk, 128) = the (3, 2, 5, 128) table, k_out 6
    wts = torch.randn(idx.shape)
    kw = dict(sk=5, k_out=6, n_dest=2)
    assert tk.check_scatter_weighted(good, starts, idx, wts, **kw) == (
        tk.scatter_weighted_geometry(2, 2, 5, 6, 4, 1))
    for v, ix, what in ((shifted, idx, "16-byte aligned"),
                        (good, idx_shifted, "16-byte aligned"),
                        (strided, idx, "contiguous")):
        with pytest.raises(ValueError, match=what):
            tk.check_scatter_weighted(v, starts, ix, wts, **kw)
    wts_shifted = torch.zeros(wts.numel() + 1)[1:].view(wts.shape)
    wts_shifted.copy_(wts)
    assert wts_shifted.is_contiguous() and wts_shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk.check_scatter_weighted(good, starts, idx, wts_shifted, **kw)
    with pytest.raises(ValueError, match="n_dest"):
        tk.check_scatter_weighted(good, starts, idx, wts, sk=5, k_out=6,
                                  n_dest=3)
