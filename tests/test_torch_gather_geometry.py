"""Host-side launch geometry and argument checks of the windowed gathers
K1 ``lane_gather_cm`` and K5 ``lane_gather_weighted``, whose kernels stage
each bin's window in shared memory (blocks of 32 lane columns). No kernel
runs here: the kernels themselves are held against their plain versions
on the card by ``chip_smoke.py``, and the plain versions against the
Pallas kernels in ``test_torch_kernels.py`` / ``test_torch_twolevel.py``."""

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
    """Where the window (K5) or the window and the index rows (K1) do not
    fit 227 KB: ValueError naming the shape, no fallback; K5 takes at most
    four channels; K must be at least 1."""
    # the window, C * wr rows of 128 bytes (float32) or 256 (float64), and
    # for K1 K = 4 index rows of 32 bytes (int8): the last window that
    # fits, and one row more
    for geo, wr, C, vb, ib in ((tk.gather_cm_geometry, 1815, 1, 4, 1),
                               (tk.gather_weighted_geometry, 1816, 1, 4, 1),
                               (tk.gather_weighted_geometry, 908, 1, 8, 4),
                               (tk.gather_weighted_geometry, 454, 2, 8, 1),
                               (tk.gather_cm_geometry, 907, 2, 4, 1)):
        assert geo(C, 1, wr, 4, vb, ib)["smem"] <= tk.SMEM_PER_BLOCK
        with pytest.raises(ValueError, match=f"wr = {wr + 1} rows"):
            geo(C, 1, wr + 1, 4, vb, ib)
    for geo in GEOMETRIES.values():
        with pytest.raises(ValueError):
            geo(2, 3, 40, 0, 4, 1)
    with pytest.raises(ValueError, match="at most 4"):
        tk.gather_weighted_geometry(5, 3, 8, 8, 4, 1)
    assert tk.gather_cm_geometry(5, 3, 8, 8, 4, 1)["smem"] == (
        5 * 8 * 32 * 4 + 3 * 8 * 32)


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
