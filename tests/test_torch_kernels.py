"""tpufem_torch lane kernels: the plain PyTorch versions (what a wrapper
runs for a CPU tensor) against the JAX functions in Pallas interpret mode,
on random tables with -1 sentinels. Same inputs (numpy, seeded) through
both; results must be exactly equal -- gather and pass-update move values
without arithmetic beyond adding zeros, and the scatter adds in the same
fixed order (v-outer, k-inner) in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.lane import kernels as jk
from tpufem_torch.lane import kernels as tk
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

L = 128


def _idx(rng, shape, hi, idt, p_missing=0.2):
    idx = rng.integers(0, hi, size=shape)
    idx[rng.random(shape) < p_missing] = -1
    return idx.astype(idt)


@pytest.mark.parametrize("idt", [np.int8, np.int32])
def test_gather_cm_matches_jax(idt):
    rng = np.random.default_rng(1)
    C, T, V, K, wr = 2, 5, 3, 8, 16
    R = T * wr
    values = rng.standard_normal((C, R, L))
    starts = (np.arange(T) * wr).astype(np.int32)
    idx = _idx(rng, (T, V, K, L), wr, idt)
    ref = np.asarray(jk.lane_gather_cm(
        jnp.asarray(values), jnp.asarray(starts), jnp.asarray(idx),
        wr=wr, n_ch=C * V, interpret=True))
    got = tk.lane_gather_cm(
        torch.from_numpy(values), torch.from_numpy(starts),
        torch.from_numpy(idx), wr=wr, n_ch=C * V)
    assert got.shape == (V * C, T, K, L)
    assert np.array_equal(got.numpy(), ref)
    # sentinel entries are exact zeros
    assert (got.numpy().reshape(V, C, T, K, L)[:, 0][
        idx.transpose(1, 0, 2, 3) < 0] == 0).all()


@pytest.mark.parametrize("idt", [np.int8, np.int32])
def test_scatter_cm_matches_jax(idt):
    rng = np.random.default_rng(2)
    C, T, V, K, k_out = 2, 4, 3, 8, 16
    src = rng.standard_normal((V * C, T, K, L))
    idx = _idx(rng, (T, V, K, L), k_out, idt)
    ref = np.asarray(jk.lane_scatter_cm(
        jnp.asarray(src), jnp.asarray(idx), k_out=k_out, n_ch=C,
        interpret=True))
    got = tk.lane_scatter_cm(
        torch.from_numpy(src), torch.from_numpy(idx), k_out=k_out, n_ch=C)
    assert got.shape == (C, T, k_out, L)
    assert np.array_equal(got.numpy(), ref)


def test_scatter_is_transpose_of_gather():
    rng = np.random.default_rng(3)
    C, T, V, K, wg = 2, 3, 3, 8, 16
    idx = torch.from_numpy(_idx(rng, (T, V, K, L), wg, np.int32))
    starts = torch.arange(T, dtype=torch.int32) * wg
    x = torch.from_numpy(rng.standard_normal((C, T * wg, L)))
    y = torch.from_numpy(rng.standard_normal((V * C, T, K, L)))
    gx = tk.lane_gather_cm(x, starts, idx, wr=wg, n_ch=C * V)
    sy = tk.lane_scatter_cm(y, idx, k_out=wg, n_ch=C)
    lhs = float((gx * y).sum())
    rhs = float((x.reshape(C, T, wg, L) * sy).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("idt", [np.int8, np.int32])
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("sign", [1, -1])
def test_pass_update_matches_jax(idt, head, sign):
    rng = np.random.default_rng(4)
    C, T, wg, K, P = 2, 6, 16, 8, 3
    R = T * wg
    wrs = (8, 5, 3)
    shifts = tuple(sign * s for s in (0, 1, 127))
    values = rng.standard_normal((C, R, L))
    starts = np.stack([
        rng.integers(0, R - wrs[p] + 1, size=T) for p in range(P)
    ]).astype(np.int32)
    idx = np.stack([_idx(rng, (T, K, L), wrs[p], idt, 0.5)
                    for p in range(P)])
    ref = np.asarray(jk.lane_pass_update(
        jnp.asarray(values), jnp.asarray(starts), jnp.asarray(idx),
        wrs=wrs, wg=wg, shifts=shifts, head=head, interpret=True))
    got = tk.lane_pass_update(
        torch.from_numpy(values), torch.from_numpy(starts),
        torch.from_numpy(idx), wrs=wrs, wg=wg, shifts=shifts, head=head)
    assert got.shape == (C, T, wg, L)
    assert np.array_equal(got.numpy(), ref)
    base = values.reshape(C, T, wg, L)
    if head:  # rows past K are copied
        assert np.array_equal(got.numpy()[:, :, K:], base[:, :, K:])
    else:  # tail rows are SET: an all-sentinel entry gives an exact 0
        assert np.array_equal(got.numpy()[:, :, :wg - K], base[:, :, :wg - K])
        none = (idx < 0).all(axis=0)  # (T, K, L)
        assert (got.numpy()[:, :, wg - K:][:, none] == 0).all()


# K3's launch geometry (lane_pass_update on a CUDA tensor): the wrapper
# computes it on the host and the kernel checks its shared-memory size
OWNER_WRS = (3, 5, 7, 10, 9, 7, 16, 19, 12, 13, 14, 14, 12, 10)  # n = 1024


def _pass_layout(C, K, wt, vb, ib):
    """csrc/lane_pass_update.cu: PASS_STAGES ring stages of (index rows,
    then wt window rows for each of the block's channels)."""
    rows, cb = min(K, tk.PASS_ROWS), min(C, tk.PASS_CB)
    return tk.PASS_STAGES * (rows * L * ib + cb * wt * L * vb)


def test_pass_update_geometry_at_the_main_path():
    """The n = 1024 plan's owner-sum (K = 16) and refresh (K = 24) passes,
    float32 values and int8 indices: one unit per pass, in pass order,
    the whole window in one stage; one block per bin serves both channels;
    the staged refresh's shared memory would let three blocks share an SM
    (228 KB, 1 KB reserved per block)."""
    g = tk.pass_update_geometry(2, 16, OWNER_WRS, 4, 1)
    assert g["wt"] == 19 and g["groups"] == 1 and g["channel_blocks"] == 1
    assert g["units"] == tuple((p, 0, w) for p, w in enumerate(OWNER_WRS))
    assert g["smem"] == _pass_layout(2, 16, 19, 4, 1) == 64512
    assert 3 * (g["smem"] + tk.PASS_STATIC_SMEM + 1024) <= 228 * 1024
    r = tk.pass_update_geometry(2, 24, (16,) * 13 + (15,), 4, 1)
    assert r["wt"] == 16 and len(r["units"]) == 14
    assert r["smem"] == _pass_layout(2, 24, 16, 4, 1)


@pytest.mark.parametrize("vbytes,ibytes", [(4, 1), (4, 4), (8, 1), (8, 4)])
@pytest.mark.parametrize("C,K", [(1, 5), (2, 24), (3, 37), (2, 64)])
def test_pass_update_geometry_tiles_every_window(vbytes, ibytes, C, K):
    """Windows up to the int8 limit (126 rows): the units tile each pass's
    window [0, wr) exactly once, in pass order, no tile taller than wt;
    the layout fits the card's shared memory beside the pass starts, with
    the tallest tile that does; one block per 32 updated rows and per
    channel pair."""
    wrs = (126, 1, 0, 40, 7)
    g = tk.pass_update_geometry(C, K, wrs, vbytes, ibytes)
    wt, units = g["wt"], g["units"]
    assert [u[0] for u in units] == sorted(u[0] for u in units)
    for p, w in enumerate(wrs):
        tiles = [(a, n) for q, a, n in units if q == p]
        assert [a for a, _ in tiles] == list(range(0, w, wt))
        assert sum(n for _, n in tiles) == w
        assert all(1 <= n <= wt for _, n in tiles)
    room = tk.SMEM_PER_BLOCK - tk.PASS_STATIC_SMEM
    assert g["smem"] == _pass_layout(C, K, wt, vbytes, ibytes) <= room
    assert wt == 126 or _pass_layout(C, K, wt + 1, vbytes, ibytes) > room
    assert g["groups"] == -(-K // tk.PASS_ROWS)
    assert g["channel_blocks"] == -(-C // tk.PASS_CB)


def test_pass_update_geometry_raises_where_the_kernel_cannot_launch():
    """More tiles than the kernel takes, more passes than it takes, or no
    row: ValueError (the wrapper raises before any launch)."""
    with pytest.raises(ValueError, match="tiles"):
        tk.pass_update_geometry(2, 32, (126,) * 64, 8, 4)
    with pytest.raises(ValueError, match="passes"):
        tk.pass_update_geometry(2, 16, (4,) * (tk.PASS_MAX + 1), 4, 1)
    with pytest.raises(ValueError):
        tk.pass_update_geometry(2, 0, (4,), 4, 1)


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    rng = np.random.default_rng(5)
    tk.reset_launch_counts()
    idx = torch.from_numpy(_idx(rng, (2, 3, 8, L), 8, np.int8))
    x = torch.from_numpy(rng.standard_normal((2, 16, L)))
    tk.lane_gather_cm(x, torch.tensor([0, 8], dtype=torch.int32), idx,
                      wr=8, n_ch=6)
    law = tk.FusedLaw("linear_elastic", 0.3, E=1.0e6)
    geom = torch.from_numpy(rng.standard_normal((2, 7, 8, L)))
    out = tk.lane_fused_elem((x,), torch.tensor([0, 8], dtype=torch.int32),
                             idx, (geom,), law, wr=8, nv=3)
    assert out.shape == (2, 2, 8, L)
    wts = torch.from_numpy(rng.standard_normal((2, 3, 8, L)))
    out = tk.lane_gather_weighted(x, torch.tensor([0, 8], dtype=torch.int32),
                                  idx, wts, wr=8)
    assert out.shape == (2, 2, 8, L)
    assert tk.launch_counts() == {
        "lane_gather_cm": 0, "lane_scatter_cm": 0, "lane_pass_update": 0,
        "lane_fused_elem": 0, "lane_gather_weighted": 0, "lane_gather": 0,
        "lane_scatter": 0, "lane_scatter_weighted": 0}


def test_kernel_sources_present():
    """Every wrapper has its CUDA source in the package, built for sm_90a."""
    import os

    from tpufem_torch.lane import _build

    names = {os.path.basename(p) for p in _build.sources()}
    assert {"lane_gather_cm.cu", "lane_scatter_cm.cu",
            "lane_pass_update.cu", "lane_fused_elem.cu",
            "lane_gather_weighted.cu"} <= names
    assert any("sm_90a" in f for f in _build.ARCH_FLAGS)
