"""Kernels of the lane-partitioned layout: CUDA for Hopper, each beside its
plain PyTorch version.

Three primitives cover every irregular movement of the staged lane
pipeline (gather to cells, scatter-add to bin partials, copy owner-sum
and refresh):

- :func:`lane_gather_cm`   -- out[v*C+c,t,k,j] = values[c, starts[t]+idx[t,v,k,j], j]
- :func:`lane_scatter_cm`  -- out[c,t,r,j] = sum_{v,k: idx[t,v,k,j]==r} src[v*C+c,t,k,j]
- :func:`lane_pass_update` -- all owner-sum / refresh passes + bin-block update

Each wrapper takes the same arguments as its counterpart in
``tpufem/lane/kernels.py``. For a CUDA tensor it launches the kernel
built from ``tpufem_torch/csrc/<name>.cu`` (on PyTorch's current stream,
outputs allocated here with ``torch.empty``) or raises; it adds one to
its ``launches`` attribute exactly where it launches. For a CPU tensor --
and only because the tensor lies on the CPU -- it runs the plain version
(``<name>_plain``), which is also what the kernels are held against on
the card. Index value -1 (or anything outside the window) means "no
entry" and contributes 0.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tpufem_torch.lane import _build

N_LANES = 128

_VT = {torch.float32: 0, torch.float64: 1}
_IT = {torch.int8: 0, torch.int32: 1}


def _check(name, t, *, device, dtypes=None, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {sorted(map(str, dtypes))}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {code}")


def reset_launch_counts() -> None:
    for fn in (lane_gather_cm, lane_scatter_cm, lane_pass_update):
        fn.launches = 0


def launch_counts() -> dict:
    return {
        fn.__name__: fn.launches
        for fn in (lane_gather_cm, lane_scatter_cm, lane_pass_update)
    }


# -- K1: gather ---------------------------------------------------------------


def lane_gather_cm_plain(values, starts, idx, *, wr: int, n_ch: int):
    """Plain version of :func:`lane_gather_cm` (advanced indexing)."""
    C, R, L = values.shape
    T, V, K, _ = idx.shape
    assert n_ch == C * V
    ii = idx.to(torch.int64)
    valid = (ii >= 0) & (ii < wr)
    rows = starts.to(torch.int64).view(T, 1, 1, 1) + ii.clamp(min=0)
    rows = rows.clamp(max=R - 1)
    lane = torch.arange(L, device=values.device)
    g = values[:, rows, lane]  # (C, T, V, K, L)
    g = torch.where(valid, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return g.permute(2, 0, 1, 3, 4).reshape(V * C, T, K, L)


def lane_gather_cm(values, starts, idx, *, wr: int, n_ch: int):
    """Cells-minor windowed gather.

    values (C, R, 128); starts (T,) int32 window row-starts; idx
    (T, V, K, 128) int8/int32 in [-1, wr). Returns (V*C, T, K, 128) with
    dof row v*C+c leading, so the (nd, M) cells-minor view the physics
    works on is a free reshape.
    """
    if values.device.type != "cuda":
        return lane_gather_cm_plain(values, starts, idx, wr=wr, n_ch=n_ch)
    dev = values.device
    _check("values", values, device=dev, dtypes=_VT)
    C, R, L = values.shape
    _check("idx", idx, device=dev, dtypes=_IT)
    T, V, K, L2 = idx.shape
    if L != N_LANES or L2 != N_LANES or n_ch != C * V:
        raise ValueError("lane_gather_cm: bad lane width or n_ch")
    _check("starts", starts, device=dev, dtypes=(torch.int32,), shape=(T,))
    out = torch.empty((V * C, T, K, L), dtype=values.dtype, device=dev)
    lib = _build.load()
    code = lib.lane_gather_cm(
        _VT[values.dtype], _IT[idx.dtype], values.data_ptr(),
        starts.data_ptr(), idx.data_ptr(), out.data_ptr(),
        C, R, T, V, K, int(wr), _stream(dev),
    )
    _raise_on(code, "lane_gather_cm")
    lane_gather_cm.launches += 1
    return out


# -- K2: scatter --------------------------------------------------------------


def lane_scatter_cm_plain(src, idx, *, k_out: int, n_ch: int):
    """Plain version of :func:`lane_scatter_cm`: one ``scatter_add_`` per
    (v, k), v-outer and k-inner -- every call has at most one source per
    destination, so the sum order is exactly the kernel's."""
    ND, T, K, L = src.shape
    _, V, _, _ = idx.shape
    C = ND // V
    assert n_ch == C
    ii = idx.to(torch.int64)
    ii = torch.where((ii >= 0) & (ii < k_out), ii,
                     torch.full_like(ii, k_out))  # dump row
    out = torch.zeros((C, T, k_out + 1, L), dtype=src.dtype,
                      device=src.device)
    for v in range(V):
        sv = src[v * C:(v + 1) * C]  # (C, T, K, L)
        for k in range(K):
            dest = ii[:, v, k, :].view(1, T, 1, L).expand(C, T, 1, L)
            out.scatter_add_(2, dest, sv[:, :, k:k + 1, :])
    return out[:, :, :k_out, :].contiguous()


def lane_scatter_cm(src, idx, *, k_out: int, n_ch: int):
    """Cells-minor bin scatter: src (V*C, T, K, 128) element vectors (dof
    row v*C+c), idx = the SAME (T, V, K, 128) gather table. Returns bin
    partials (C, T, k_out, 128), channel-leading."""
    if src.device.type != "cuda":
        return lane_scatter_cm_plain(src, idx, k_out=k_out, n_ch=n_ch)
    dev = src.device
    _check("src", src, device=dev, dtypes=_VT)
    _check("idx", idx, device=dev, dtypes=_IT)
    ND, T, K, L = src.shape
    T2, V, K2, L2 = idx.shape
    if (L != N_LANES or L2 != N_LANES or T2 != T or K2 != K
            or ND != V * n_ch):
        raise ValueError("lane_scatter_cm: src/idx shapes do not match")
    C = n_ch
    out = torch.empty((C, T, k_out, L), dtype=src.dtype, device=dev)
    lib = _build.load()
    code = lib.lane_scatter_cm(
        _VT[src.dtype], _IT[idx.dtype], src.data_ptr(), idx.data_ptr(),
        out.data_ptr(), C, T, V, K, int(k_out), _stream(dev),
    )
    _raise_on(code, "lane_scatter_cm")
    lane_scatter_cm.launches += 1
    return out


# -- K3: owner-sum / refresh passes -------------------------------------------


def lane_pass_update_plain(values, starts, idx, *, wrs: Sequence[int],
                           wg: int, shifts: Sequence[int], head: bool):
    """Plain version of :func:`lane_pass_update`."""
    C, R, L = values.shape
    P, T, K, _ = idx.shape
    assert len(shifts) == P and len(wrs) == P and R == T * wg
    lane = torch.arange(L, device=values.device)
    acc = torch.zeros((C, T, K, L), dtype=values.dtype, device=values.device)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    for p in range(P):
        ii = idx[p].to(torch.int64)  # (T, K, L)
        valid = (ii >= 0) & (ii < int(wrs[p]))
        rows = starts[p].to(torch.int64).view(T, 1, 1) + ii.clamp(min=0)
        rows = rows.clamp(max=R - 1)
        src_lane = (lane - int(shifts[p])) % L
        g = values[:, rows, src_lane]  # (C, T, K, L)
        acc = acc + torch.where(valid, g, zero)
    out = values.reshape(C, T, wg, L).clone()
    if head:
        out[:, :, :K] = out[:, :, :K] + acc
    else:
        out[:, :, wg - K:] = acc
    return out


def lane_pass_update(values, starts, idx, *, wrs: Sequence[int], wg: int,
                     shifts: Sequence[int], head: bool):
    """All owner-sum (resp. refresh) passes in ONE kernel, fused with the
    bin-block update. Per pass p and bin t:

      acc[c,k,j] = sum_p values[c, starts[p,t] + idx[p,t,k,j],
                                (j - shifts[p]) mod 128]

    ``head=True`` (owner-sum) ADDS acc into the first K rows of each wg
    window; ``head=False`` (refresh) SETS the last K rows to acc.

    values (C, R=T*wg, 128); starts (P, T) int32; idx (P, T, K, 128) in
    [-1, wrs[p]); shifts / wrs: P lane shifts and per-pass window
    heights. Returns a new (C, T, wg, 128) tensor -- reshape to
    (C, R, 128) is free.
    """
    if values.device.type != "cuda":
        return lane_pass_update_plain(values, starts, idx, wrs=wrs, wg=wg,
                                      shifts=shifts, head=head)
    dev = values.device
    _check("values", values, device=dev, dtypes=_VT)
    _check("idx", idx, device=dev, dtypes=_IT)
    C, R, L = values.shape
    P, T, K, L2 = idx.shape
    if (L != N_LANES or L2 != N_LANES or R != T * wg or len(shifts) != P
            or len(wrs) != P or K > wg):
        raise ValueError("lane_pass_update: shapes do not match")
    _check("starts", starts, device=dev, dtypes=(torch.int32,), shape=(P, T))
    out = torch.empty((C, T, wg, L), dtype=values.dtype, device=dev)
    arr = ctypes.c_int * P
    lib = _build.load()
    code = lib.lane_pass_update(
        _VT[values.dtype], _IT[idx.dtype], values.data_ptr(),
        starts.data_ptr(), idx.data_ptr(), out.data_ptr(),
        arr(*[int(s) for s in shifts]), arr(*[int(w) for w in wrs]),
        C, T, P, K, int(wg), int(bool(head)), _stream(dev),
    )
    _raise_on(code, "lane_pass_update")
    lane_pass_update.launches += 1
    return out


reset_launch_counts()
