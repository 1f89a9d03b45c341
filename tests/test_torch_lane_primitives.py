"""K9 ``lane_gather``, K10 ``lane_scatter`` and K11 ``lane_scatter_weighted``
of tpufem_torch against the Pallas kernels of tpufem (interpret mode, CPU,
float64, the same numpy inputs through both).

The shapes are those of tests/test_lane.py's primitive test (C = 2 value
rows of 128 lanes, T = 4 bins, windows of 16 / 24 rows), with int8 and
int32 indices, about a third of them -1, and in the ``tail`` cases a
window that ends on the last row of the values. On the CPU the port's
wrappers take their plain versions because the tensors lie there.

Tolerances: exactly equal for the gather without ``sum_v`` (values are
moved, not computed) and for both scatters (the port adds in the Pallas
order: r ascending, and for K11 r outer, d inner, each product rounded
first); rel <= 1e-14 for the gather with ``sum_v`` (the port sums over v
ascending, the Pallas body over window rows with a count per row)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.lane import kernels as jk
from tpufem_torch.lane import kernels as tk
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

L = 128
C, T = 2, 4
IDT = {"int32": np.int32, "int8": np.int8}


def _starts(tail, R, wr):
    """Window starts every wr rows; with ``tail`` the last window ends on
    the last row of the values."""
    s = np.arange(T, dtype=np.int32) * wr
    if tail:
        s[-1] = R - wr
    return s


def _idx(rng, shape, hi, idt):
    return rng.integers(-1, hi, shape).astype(IDT[idt])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("tail", [False, True], ids=["inner", "tail"])
@pytest.mark.parametrize("sum_v", [False, True], ids=["per_v", "sum_v"])
@pytest.mark.parametrize("idt", ["int32", "int8"])
def test_lane_gather_plain_matches_pallas(idt, sum_v, tail):
    R, V, K, wr = 72, 3, 8, 16
    rng = np.random.default_rng(10 + 2 * sum_v + tail)
    vals = rng.standard_normal((C, R, L))
    starts = _starts(tail, R, wr)
    idx = _idx(rng, (T, V, K, L), wr, idt)
    ref = np.asarray(jk.lane_gather(
        jnp.asarray(vals), jnp.asarray(starts), jnp.asarray(idx), wr=wr,
        sum_v=sum_v, interpret=True))
    got = tk.lane_gather(_t(vals), _t(starts), _t(idx), wr=wr,
                         sum_v=sum_v).numpy()
    assert got.shape == ref.shape
    if sum_v:
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel <= 1e-14, rel
        per_v = tk.lane_gather_plain(_t(vals), _t(starts), _t(idx), wr=wr)
        assert np.array_equal(got, per_v.numpy().sum(axis=2))
    else:
        assert np.array_equal(got, ref)
        # every -1 entry reads 0, every other one its window value
        t, v, k, j = np.nonzero(idx >= 0)
        row = starts[t] + idx[t, v, k, j]
        assert np.array_equal(got[t, :, v, k, j], vals[:, row, j].T)
        assert (got.transpose(0, 2, 3, 4, 1)[idx < 0] == 0).all()


@pytest.mark.parametrize("tail", [False, True], ids=["inner", "tail"])
@pytest.mark.parametrize("idt", ["int32", "int8"])
def test_lane_scatter_plain_matches_pallas(idt, tail):
    S, sk, k_out = 100, 24, 16
    rng = np.random.default_rng(20 + tail)
    src = rng.standard_normal((C, S, L))
    starts = _starts(tail, S, sk)
    didx = _idx(rng, (T, sk, L), k_out, idt)
    ref = np.asarray(jk.lane_scatter(
        jnp.asarray(src), jnp.asarray(starts), jnp.asarray(didx), sk=sk,
        k_out=k_out, interpret=True))
    got = tk.lane_scatter(_t(src), _t(starts), _t(didx), sk=sk,
                          k_out=k_out).numpy()
    assert got.shape == ref.shape == (T, C, k_out, L)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("tail", [False, True], ids=["inner", "tail"])
@pytest.mark.parametrize("idt", ["int32", "int8"])
def test_lane_scatter_weighted_plain_matches_pallas(idt, tail):
    S, D, sk, k_out = 100, 3, 24, 16
    rng = np.random.default_rng(30 + tail)
    src = rng.standard_normal((C, S, L))
    starts = _starts(tail, S, sk)
    didx = _idx(rng, (T, D, sk, L), k_out, idt)
    wts = rng.random((T, D, sk, L))
    ref = np.asarray(jk.lane_scatter_weighted(
        jnp.asarray(src), jnp.asarray(starts), jnp.asarray(didx),
        jnp.asarray(wts), sk=sk, k_out=k_out, n_dest=D, interpret=True))
    got = tk.lane_scatter_weighted(_t(src), _t(starts), _t(didx), _t(wts),
                                   sk=sk, k_out=k_out, n_dest=D).numpy()
    assert got.shape == ref.shape == (T, C, k_out, L)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("idt", ["int32", "int8"])
def test_lane_scatter_weighted_is_the_adjoint_of_k5(idt):
    """K11 on K5's tables (src = K5's output layout, one window per bin)
    is K5's transpose: <K5(x), y> = <x, K11(y)> with K11's bin windows
    placed at K5's window starts (rows past the values read nothing in
    K5, so they are dropped here too)."""
    R, V, K, wr = 72, 4, 40, 16
    rng = np.random.default_rng(40)
    x = _t(rng.standard_normal((C, R, L)))
    starts = _t(_starts(True, R, wr))
    idx = _t(_idx(rng, (T, V, K, L), wr, idt))
    wts = _t(rng.random((T, V, K, L)))
    y = _t(rng.standard_normal((T, C, K, L)))
    lhs = float(torch.sum(tk.lane_gather_weighted(x, starts, idx, wts,
                                                  wr=wr) * y))
    src = y.permute(1, 0, 2, 3).reshape(C, T * K, L).contiguous()
    bin_starts = _t(np.arange(T, dtype=np.int32) * K)
    back = tk.lane_scatter_weighted(src, bin_starts, idx, wts, sk=K,
                                    k_out=wr, n_dest=V)  # (T, C, wr, L)
    rows = starts.to(torch.int64).view(T, 1) + torch.arange(wr)
    win = x[:, rows.clamp(max=R - 1)].permute(1, 0, 2, 3)  # (T, C, wr, L)
    win = torch.where((rows < R).view(T, 1, wr, 1), win, 0.0)
    rhs = float(torch.sum(win * back))
    assert abs(lhs - rhs) <= 1e-13 * abs(lhs), (lhs, rhs)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(50)
    tk.reset_launch_counts()
    vals = _t(rng.standard_normal((C, 40, L)))
    starts = _t(_starts(False, 40, 8))
    idx = _t(_idx(rng, (T, 3, 8, L), 8, "int8"))
    for sum_v in (False, True):
        assert torch.equal(
            tk.lane_gather(vals, starts, idx, wr=8, sum_v=sum_v),
            tk.lane_gather_plain(vals, starts, idx, wr=8, sum_v=sum_v))
    didx = _t(_idx(rng, (T, 8, L), 5, "int32"))
    assert torch.equal(tk.lane_scatter(vals, starts, didx, sk=8, k_out=5),
                       tk.lane_scatter_plain(vals, starts, didx, sk=8,
                                             k_out=5))
    wts = _t(rng.random((T, 3, 8, L)))
    assert torch.equal(
        tk.lane_scatter_weighted(vals, starts, idx, wts, sk=8, k_out=8,
                                 n_dest=3),
        tk.lane_scatter_weighted_plain(vals, starts, idx, wts, sk=8,
                                       k_out=8, n_dest=3))
    assert set(tk.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="sk"):
        tk.lane_scatter(vals, starts, didx, sk=7, k_out=5)
    with pytest.raises(ValueError, match="n_dest"):
        tk.lane_scatter_weighted(vals, starts, idx, wts, sk=8, k_out=8,
                                 n_dest=2)
