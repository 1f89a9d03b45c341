"""Kernels of the lane-partitioned layout: CUDA for Hopper, each beside its
plain PyTorch version.

Three primitives cover every irregular movement of the staged lane
pipeline (gather to cells, scatter-add to bin partials, copy owner-sum
and refresh), a fourth fuses the first two around the element physics,
and a fifth moves vectors between the lane layout and the two-level
preconditioner's coarse lattice:

- :func:`lane_gather_cm`   -- out[v*C+c,t,k,j] = values[c, starts[t]+idx[t,v,k,j], j]
- :func:`lane_scatter_cm`  -- out[c,t,r,j] = sum_{v,k: idx[t,v,k,j]==r} src[v*C+c,t,k,j]
- :func:`lane_pass_update` -- all owner-sum / refresh passes + bin-block update
- :func:`lane_fused_elem`  -- gather -> element gradient / Hessian-vector
  product of a hand-written law (:class:`FusedLaw`) -> scatter, in one pass
- :func:`lane_gather_weighted` -- out[t,c,k,j] = sum_v wts[t,v,k,j] *
  values[c, starts[t]+idx[t,v,k,j], j]

Three more primitives of the reference have no caller on any path of
either package (the reference's tests call two of them); they are ported
with their public signatures so that every kernel of the reference has
its counterpart:

- :func:`lane_gather`  -- out[t,c,v,k,j] = values[c, starts[t]+idx[t,v,k,j], j]
  (or summed over v)
- :func:`lane_scatter` -- out[t,c,q,j] = sum_{r: dest_idx[t,r,j]==q}
  src[c, starts[t]+r, j]
- :func:`lane_scatter_weighted` -- out[t,c,q,j] = sum_{(d,r):
  dest_idx[t,d,r,j]==q} wts[t,d,r,j] * src[c, starts[t]+r, j], the
  transpose of :func:`lane_gather_weighted`

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
import dataclasses
import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from tpufem_torch.forms.potentials import (asym_damage_stress_components,
                                           asym_damage_stress_jvp_components)

from tpufem_torch.lane import _build

N_LANES = 128
# dynamic shared memory one block may use on the H100 (227 KB)
SMEM_PER_BLOCK = 232448

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


def _pad16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _check_aligned(name, *tensors):
    """The kernels that stage their inputs by 16-byte asynchronous copies
    need 16-byte aligned data (a fresh allocation always is)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _raise_on(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {code}")


def _wrappers():
    return (lane_gather_cm, lane_scatter_cm, lane_pass_update,
            lane_fused_elem, lane_gather_weighted, lane_gather, lane_scatter,
            lane_scatter_weighted)


def reset_launch_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


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

    values (C, R, 128) and idx 16-byte aligned; starts (T,) int32 window
    row-starts (>= 0); idx (T, V, K, 128) int8/int32 in [-1, wr). Returns
    (V*C, T, K, 128) with dof row v*C+c leading, so the (nd, M)
    cells-minor view the physics works on is a free reshape. The launch
    geometry is :func:`gather_cm_geometry`'s.
    """
    if values.device.type != "cuda":
        return lane_gather_cm_plain(values, starts, idx, wr=wr, n_ch=n_ch)
    geo = check_gather_cm(values, starts, idx, wr=wr, n_ch=n_ch)
    dev = values.device
    C, R, L = values.shape
    T, V, K, _ = idx.shape
    out = torch.empty((V * C, T, K, L), dtype=values.dtype, device=dev)
    lib = _build.load()
    code = lib.lane_gather_cm(
        _VT[values.dtype], _IT[idx.dtype], values.data_ptr(),
        starts.data_ptr(), idx.data_ptr(), out.data_ptr(),
        C, R, T, V, K, int(wr), geo["ky"], geo["smem"], _stream(dev),
    )
    _raise_on(code, "lane_gather_cm")
    lane_gather_cm.launches += 1
    return out


# -- K1 / K5: the bin's window and tables staged in shared memory -------------

# the constants of csrc/lane_gather_cm.cu and csrc/lane_gather_weighted.cu
GATHER_LB = 32  # lane columns of a block: a slab of a bin
GATHER_KY = 8  # thread rows of a block that stages its tables ...
GATHER_KY_REGS = 16  # ... and of one that loads them into registers (K5)
SMEM_PER_SM = 233472  # shared memory an SM shares among its blocks (228 KB)
SMEM_RESERVED = 1024  # what the card keeps of it for each block


def gather_layout_bytes(C: int, V: int, wr: int, K: int, vbytes: int,
                        ibytes: int, weighted: bool, tiles: bool = True) -> int:
    """Shared memory of one block of the windowed gathers: the window (C
    channels x wr rows x GATHER_LB values) and, where the block stages its
    tables (``tiles``), its index rows (V x K x GATHER_LB) and, for the
    weighted gather, their weights
    (csrc/lane_gather_{cm,weighted}.cu:*_smem_bytes)."""
    tile = V * K * GATHER_LB if tiles else 0
    return (C * wr * GATHER_LB * vbytes + _pad16(tile * ibytes)
            + (tile * vbytes if weighted else 0))


def _window_geometry(name: str, C: int, V: int, wr: int, K: int,
                     vbytes: int, ibytes: int, weighted: bool,
                     direct: bool = False) -> dict:
    if (C < 1 or V < 0 or K < 1 or wr < 0 or vbytes not in (4, 8)
            or ibytes not in (1, 4)):
        raise ValueError(f"{name}: C = {C}, K = {K} (>= 1), V = {V}, "
                         f"wr = {wr} (>= 0), {vbytes}-byte values, "
                         f"{ibytes}-byte indices")
    staged = gather_layout_bytes(C, V, wr, K, vbytes, ibytes, weighted)
    # the weighted gather stages its tables where two blocks still share an
    # SM, else loads them into registers; the gathers always stage them
    tiles = not weighted or 2 * (staged + SMEM_RESERVED) <= SMEM_PER_SM
    smem = gather_layout_bytes(C, V, wr, K, vbytes, ibytes, weighted, tiles)
    if smem > SMEM_PER_BLOCK and direct:
        # K9 reads the window and the tables from global memory instead
        tiles, smem = False, 0
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"{name}: the window of C = {C} channels x wr = {wr} rows"
            f"{'' if weighted else f' and the V = {V} x K = {K} index rows'}"
            f" of {GATHER_LB} lanes, {vbytes}-byte values and {ibytes}-byte"
            f" indices, take {smem} bytes; a block holds {SMEM_PER_BLOCK} "
            "bytes of shared memory")
    passes = -(-K // (GATHER_KY if tiles else GATHER_KY_REGS))
    ky = -(-K // passes)
    return dict(block=(GATHER_LB, ky), ky=ky, tiles=tiles,
                rows_per_thread=passes, slabs=N_LANES // GATHER_LB,
                smem=smem)


@functools.lru_cache(maxsize=64)
def gather_cm_geometry(C: int, V: int, wr: int, K: int, vbytes: int,
                       ibytes: int) -> dict:
    """Launch geometry of :func:`lane_gather_cm`'s kernel for C channels,
    V cells' vertices, a window of ``wr`` rows, K cell rows and the value /
    index element sizes in bytes. The grid is bins x ``slabs`` blocks, the
    slabs of a bin neighbours: a block serves one bin and GATHER_LB of its
    lane columns, with ``block`` = (GATHER_LB, ``ky``) threads, and stages
    the window and the index rows of its slab, ``smem`` bytes
    (:func:`gather_layout_bytes`). Thread (x, y) writes rows y, y + ky, ...
    of column x (``rows_per_thread`` at most), ``ky`` about GATHER_KY,
    spread evenly over the K rows. ``ValueError`` where the window and the
    index rows do not fit a block's shared memory."""
    return _window_geometry("lane_gather_cm", C, V, wr, K, vbytes, ibytes,
                            False)


@functools.lru_cache(maxsize=64)
def gather_weighted_geometry(C: int, V: int, wr: int, K: int, vbytes: int,
                             ibytes: int) -> dict:
    """Launch geometry of :func:`lane_gather_weighted`'s kernel, laid out
    as :func:`gather_cm_geometry`'s (C <= 4 channels). Where the window and
    the index and weight rows leave room for two blocks an SM, the block
    stages them all (``tiles``, about GATHER_KY thread rows); else it
    stages the window alone and loads the tables into registers, where
    more threads keep more loads in flight (about GATHER_KY_REGS thread
    rows). ``ValueError`` where the window does not fit a block's shared
    memory."""
    if C > 4:
        raise ValueError(f"lane_gather_weighted: C = {C} channels, the "
                         "kernel takes at most 4")
    return _window_geometry("lane_gather_weighted", C, V, wr, K, vbytes,
                            ibytes, True)


def gather_cover(geo: dict, T: int, K: int):
    """How many times the kernel of ``geo`` (:func:`gather_cm_geometry`,
    :func:`gather_weighted_geometry`) writes each output (t, k, lane) of T
    bins of K rows: block (t, s), thread (x, y) writes lane s * lb + x of
    rows y, y + ky, ... below K."""
    lb, ky = geo["block"]
    counts = np.zeros((T, K, N_LANES), np.int64)
    for s in range(geo["slabs"]):
        for y in range(ky):
            for k in range(y, K, ky):
                counts[:, k, s * lb:(s + 1) * lb] += 1
    return counts


def _check_window_args(name, values, starts, idx, min_rows=1):
    dev = values.device
    _check("values", values, device=dev, dtypes=_VT)
    C, R, L = values.shape
    _check("idx", idx, device=dev, dtypes=_IT)
    T, V, K, L2 = idx.shape
    if L != N_LANES or L2 != N_LANES or R < min_rows:
        raise ValueError(f"{name}: bad lane width or no rows")
    _check("starts", starts, device=dev, dtypes=(torch.int32,), shape=(T,))
    # the kernel stages the window and the index rows by 16-byte
    # asynchronous copies
    _check_aligned(name, values, idx)
    return C, V, K


def check_gather_cm(values, starts, idx, *, wr: int, n_ch: int) -> dict:
    """The host-side checks of :func:`lane_gather_cm` (device, dtypes,
    shapes, contiguity, 16-byte alignment of ``values`` and ``idx``);
    returns the launch geometry. Raises ``ValueError`` / ``TypeError``."""
    C, V, K = _check_window_args("lane_gather_cm", values, starts, idx)
    if n_ch != C * V:
        raise ValueError(f"lane_gather_cm: n_ch = {n_ch}, expected {C * V}")
    return gather_cm_geometry(C, V, int(wr), K, values.element_size(),
                              idx.element_size())


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
    """Plain version of :func:`lane_pass_update`: every pass gathered at
    once, then added pass by pass, p ascending -- the kernel's order."""
    C, R, L = values.shape
    P, T, K, _ = idx.shape
    assert len(shifts) == P and len(wrs) == P and R == T * wg
    dev = values.device
    ii = idx.to(torch.int64)  # (P, T, K, L)
    wr = torch.as_tensor([int(w) for w in wrs], device=dev).view(P, 1, 1, 1)
    valid = (ii >= 0) & (ii < wr)
    rows = starts.to(torch.int64).view(P, T, 1, 1) + ii.clamp(min=0)
    rows = rows.clamp(max=R - 1)
    sh = torch.as_tensor([int(s) for s in shifts], device=dev).view(P, 1)
    src_lane = (torch.arange(L, device=dev) - sh) % L  # (P, L)
    g = values[:, rows, src_lane.view(P, 1, 1, L)]  # (C, P, T, K, L)
    g = torch.where(valid, g, torch.zeros((), dtype=g.dtype, device=dev))
    acc = torch.zeros((C, T, K, L), dtype=values.dtype, device=dev)
    for p in range(P):
        acc = acc + g[:, p]
    out = values.reshape(C, T, wg, L).clone()
    if head:
        out[:, :, :K] = out[:, :, :K] + acc
    else:
        out[:, :, wg - K:] = acc
    return out


# the constants of csrc/lane_pass_update.cu
PASS_MAX = 64  # passes
PASS_MAX_UNITS = 256  # staged units (pass tiles)
PASS_ROWS = 32  # updated rows per block: 4 thread rows x 8 rows each
PASS_CB = 2  # channels per block
PASS_STAGES = 3  # ring depth, in units
PASS_STATIC_SMEM = 4 * PASS_MAX  # the block's pass starts


def pass_smem_bytes(C: int, K: int, wt: int, vbytes: int,
                    ibytes: int) -> int:
    """Shared memory of one block of the pass kernel: PASS_STAGES ring
    stages, each the index rows of a unit (min(K, PASS_ROWS) rows of 128)
    and its ``wt`` window rows of 128 columns for each of min(C, PASS_CB)
    channels (csrc/lane_pass_update.cu:pass_stage_bytes)."""
    rows, cb = min(K, PASS_ROWS), min(C, PASS_CB)
    return PASS_STAGES * (rows * N_LANES * ibytes
                          + cb * wt * N_LANES * vbytes)


def pass_update_geometry(C: int, K: int, wrs: Tuple[int, ...], vbytes: int,
                         ibytes: int) -> dict:
    """Launch geometry of :func:`lane_pass_update`'s kernel for C channels,
    K updated rows, the passes' window heights ``wrs`` and the value / index
    element sizes in bytes.

    A block serves one bin, up to PASS_ROWS updated rows of it and
    PASS_CB channels (``grid`` = (bins, ``groups``, channel pairs)). Its
    work is a list of ``units``, (pass, first window row, rows) in pass
    order: one per pass, or one per tile of at most ``wt`` rows where a
    pass's window is taller than a ring stage can hold; ``wt`` is the
    tallest tile whose :func:`pass_smem_bytes` (``smem``) fits the card's
    shared memory beside the pass starts. That is the refresh's kernel;
    the owner-sum's (``head=True``) reads the passes straight from global
    memory and takes only the window heights from the units. Raises
    ``ValueError`` where not even one row fits or the unit list is longer
    than the kernel takes."""
    if C < 1 or K < 1 or len(wrs) > PASS_MAX:
        raise ValueError(f"lane_pass_update: C = {C}, K = {K} (>= 1), "
                         f"{len(wrs)} passes (<= {PASS_MAX})")
    room = SMEM_PER_BLOCK - PASS_STATIC_SMEM
    wt = max(list(wrs) + [1])
    while wt >= 1 and pass_smem_bytes(C, K, wt, vbytes, ibytes) > room:
        wt -= 1
    if wt < 1:
        raise ValueError(f"lane_pass_update: {min(K, PASS_ROWS)} index "
                         f"rows of {ibytes} bytes leave no room for a "
                         "window row")
    units = tuple((p, a, min(wt, w - a)) for p, w in enumerate(wrs)
                  for a in range(0, w, wt))
    if len(units) > PASS_MAX_UNITS:
        raise ValueError(f"lane_pass_update: {len(units)} window tiles of "
                         f"{wt} rows, the kernel takes {PASS_MAX_UNITS}")
    return dict(wt=wt, units=units, groups=-(-K // PASS_ROWS),
                channel_blocks=-(-C // PASS_CB),
                smem=pass_smem_bytes(C, K, wt, vbytes, ibytes))


@functools.lru_cache(maxsize=64)
def _pass_update_args(C, K, wrs, shifts, vbytes, ibytes):
    """The geometry and the ctypes arrays of one K3 launch (cached: the
    engine repeats two call shapes per solve, each thousands of times)."""
    g = pass_update_geometry(C, K, wrs, vbytes, ibytes)
    flat = [x for unit in g["units"] for x in unit]
    return (g, (ctypes.c_int * len(shifts))(*shifts),
            (ctypes.c_int * max(len(flat), 1))(*flat))


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
    (C, R, 128) is free. The launch geometry is
    :func:`pass_update_geometry`'s.
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
    _check_aligned("lane_pass_update", values, idx)
    g, sh, units = _pass_update_args(
        C, K, tuple(int(w) for w in wrs), tuple(int(s) for s in shifts),
        values.element_size(), idx.element_size())
    out = torch.empty((C, T, wg, L), dtype=values.dtype, device=dev)
    lib = _build.load()
    code = lib.lane_pass_update(
        _VT[values.dtype], _IT[idx.dtype], values.data_ptr(),
        starts.data_ptr(), idx.data_ptr(), out.data_ptr(), sh, units,
        len(g["units"]), g["wt"], g["smem"], C, T, P, K, int(wg),
        int(bool(head)), _stream(dev),
    )
    _raise_on(code, "lane_pass_update")
    lane_pass_update.launches += 1
    return out


# -- K4: fused gather -> element physics -> scatter ---------------------------

_LAWS = {"linear_elastic": 0, "asym_damage": 1}

# a per-cell scalar of a law: a constant, or (first row, row count) of the
# coefficient block, averaged over its rows (P1: the cell's 3 dofs; P0: 1)
CellScalar = Union[float, Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class FusedLaw:
    """A constitutive law whose P1-triangle element physics the fused
    kernel has written by hand (``csrc/lane_fused_elem.cu``) -- what the
    port passes where the reference passes a traced ``elem_fn``.

    ``name``: ``"asym_damage"`` (forms.potentials.asym_damage_psi) or
    ``"linear_elastic"`` (linear_elastic_psi; ``d`` is not read). ``E``
    and ``d`` say where Young's modulus and the damage come from, ``nu``
    is the Poisson ratio."""

    name: str
    nu: float
    E: CellScalar
    d: CellScalar = 0.0

    def __post_init__(self):
        if self.name not in _LAWS:
            raise ValueError(f"no hand-written law {self.name!r}; "
                             f"have {sorted(_LAWS)}")

    def lame_factors(self):
        """(klam, kmu) with lam = E * klam, mu = E * kmu."""
        nu = float(self.nu)
        return (nu / ((1.0 + nu) * (1.0 - 2.0 * nu)),
                1.0 / (2.0 * (1.0 + nu)))

    def rows_needed(self) -> int:
        """Rows of the coefficient block the law reads (0: none)."""
        srcs = (self.E, self.d) if self.name == "asym_damage" else (self.E,)
        return max([s[0] + s[1] for s in srcs if isinstance(s, tuple)] + [0])


def _cell_scalar(src: CellScalar, cd, like):
    if isinstance(src, tuple):
        off, n = src
        acc = cd[off]
        for i in range(1, n):
            acc = acc + cd[off + i]
        return acc if n == 1 else acc * (1.0 / n)
    return torch.as_tensor(float(src), dtype=like.dtype, device=like.device)


def fused_elem_vectors(law: FusedLaw, u_blocks, cds):
    """The hand-written element physics on tensors: ``u_blocks`` a tuple
    of one or two (6, ...) dof blocks (row v*2+c), ``cds`` = (geometry
    rows (7, ...), [coefficient rows (Dc, ...)]); returns the element
    vectors (6, ...) -- gradient of the cell energy for one state,
    Hessian-vector product for two. The CUDA kernel repeats these
    operations in this order."""
    geom = cds[0]
    cd = cds[1] if len(cds) > 1 else None
    dN = [[geom[v * 2 + d] for d in range(2)] for v in range(3)]
    w = geom[6]

    def strain(u):
        g = [[u[c] * dN[0][d] + u[2 + c] * dN[1][d] + u[4 + c] * dN[2][d]
              for d in range(2)] for c in range(2)]
        return g[0][0], g[1][1], 0.5 * (g[0][1] + g[1][0])

    klam, kmu = law.lame_factors()
    E = _cell_scalar(law.E, cd, w)
    lam, mu = E * klam, E * kmu
    e = strain(u_blocks[0])
    if law.name == "asym_damage":
        d = _cell_scalar(law.d, cd, w)
        if len(u_blocks) == 1:
            s11, s22, s12 = asym_damage_stress_components(*e, d, lam, mu)
        else:
            s11, s22, s12 = asym_damage_stress_jvp_components(
                *e, *strain(u_blocks[1]), d, lam, mu)
    else:
        t11, t22, t12 = e if len(u_blocks) == 1 else strain(u_blocks[1])
        vol = lam * (t11 + t22)
        s11 = vol + 2.0 * mu * t11
        s22 = vol + 2.0 * mu * t22
        s12 = 2.0 * mu * t12
    rows = []
    for v in range(3):
        rows.append(w * (s11 * dN[v][0] + s12 * dN[v][1]))
        rows.append(w * (s12 * dN[v][0] + s22 * dN[v][1]))
    return torch.stack(rows)


def _check_fused_shapes(values, idx, cell_data, law, nv):
    C, R, L = values[0].shape
    T, V, K, L2 = idx.shape
    if len(values) not in (1, 2) or any(v.shape != values[0].shape
                                        for v in values):
        raise ValueError("lane_fused_elem: one or two states of one shape")
    if C != 2 or V != 3 or nv != 3 or L != N_LANES or L2 != N_LANES:
        raise NotImplementedError(
            "lane_fused_elem has hand-written physics for the P1 triangle "
            "with two displacement components only (C = 2, nv = 3)")
    if not 1 <= len(cell_data) <= 2 or tuple(cell_data[0].shape) != (
            T, 7, K, L):
        raise ValueError("lane_fused_elem: cell_data[0] must be the "
                         f"(T, 7, K, 128) geometry rows, T={T}, K={K}")
    Dc = 0
    if len(cell_data) == 2:
        Dc = cell_data[1].shape[1]
        if tuple(cell_data[1].shape) != (T, Dc, K, L):
            raise ValueError("lane_fused_elem: cell_data[1] must be "
                             "(T, Dc, K, 128) coefficient rows")
    if law.rows_needed() > Dc:
        raise ValueError(f"lane_fused_elem: {law} reads "
                         f"{law.rows_needed()} coefficient rows, got {Dc}")
    return C, R, T, K, Dc


def lane_fused_elem_plain(values, starts, idx, cell_data, law: FusedLaw, *,
                          wr: int, nv: int):
    """Plain version of :func:`lane_fused_elem`: the plain gather, the
    physics of :func:`fused_elem_vectors`, and one ``scatter_add_`` per
    (k, v), k-outer and v-inner -- every call has at most one source per
    destination, so the sum order is exactly the kernel's."""
    values, cell_data = tuple(values), tuple(cell_data)
    C, _R, T, K, _Dc = _check_fused_shapes(values, idx, cell_data, law, nv)
    L = N_LANES
    u_blocks = tuple(
        lane_gather_cm_plain(v, starts, idx, wr=wr, n_ch=C * nv)
        for v in values)  # each (nv*C, T, K, L)
    ev = fused_elem_vectors(
        law, u_blocks, tuple(cd.permute(1, 0, 2, 3) for cd in cell_data))
    ii = idx.to(torch.int64)
    ii = torch.where((ii >= 0) & (ii < wr), ii,
                     torch.full_like(ii, wr))  # dump row
    out = torch.zeros((C, T, wr + 1, L), dtype=ev.dtype, device=ev.device)
    for k in range(K):
        for v in range(nv):
            dest = ii[:, v, k, :].view(1, T, 1, L).expand(C, T, 1, L)
            out.scatter_add_(2, dest, ev[v * C:(v + 1) * C, :, k:k + 1, :])
    return out[:, :, :wr, :].contiguous().permute(1, 0, 2, 3)


# block layouts csrc/lane_fused_elem.cu instantiates, (lane columns,
# thread rows = cells of a round, ring depth in rounds), in order of
# preference: the first whose shared memory fits is taken
FUSED_CONFIGS = ((32, 4, 3), (16, 4, 3))


def fused_layout_bytes(lb, ky, stages, n_states, wr, dn, vbytes, ibytes):
    """Shared memory of one block of the fused kernel, the layout of
    csrc/lane_fused_elem.cu:fused_layout: for its ``lb`` columns the
    (2, wr) accumulator and the states' (2, wr) windows; ``stages`` rounds
    of cell data (3 index, 7 geometry and ``dn`` coefficient rows of ``ky``
    cells); two rounds of staged element vectors (6 values) and window
    rows (3, int16)."""
    return (_pad16(2 * wr * lb * vbytes)
            + _pad16(n_states * 2 * wr * lb * vbytes)
            + _pad16(stages * (7 + dn) * ky * lb * vbytes)
            + _pad16(stages * 3 * ky * lb * ibytes)
            + _pad16(2 * ky * 6 * lb * vbytes)
            + _pad16(2 * ky * 3 * lb * 2))


@functools.lru_cache(maxsize=64)
def fused_elem_geometry(n_states: int, wr: int, dn: int, vbytes: int,
                        ibytes: int,
                        configs: Tuple[Tuple[int, int, int], ...]
                        = FUSED_CONFIGS) -> dict:
    """Launch geometry of :func:`lane_fused_elem`'s kernel for
    ``n_states`` states, a window of ``wr`` rows, ``dn`` staged
    coefficient rows and the value / index element sizes in bytes: the
    first of ``configs`` whose :func:`fused_layout_bytes` fits the card's
    227 KB. A block takes ``lb`` of the 128 lane columns of one bin
    (``grid`` = (bins, 128 / lb)) and ``ky`` cells a round (``ky`` x ``lb``
    threads). ``ValueError`` where no configuration fits."""
    if wr < 1 or wr > 32767 or n_states not in (1, 2):
        raise ValueError(f"lane_fused_elem: wr = {wr}, {n_states} states")
    for lb, ky, stages in configs:
        smem = fused_layout_bytes(lb, ky, stages, n_states, wr, dn, vbytes,
                                  ibytes)
        if smem <= SMEM_PER_BLOCK:
            return dict(lb=lb, ky=ky, stages=stages, smem=smem,
                        grid_y=N_LANES // lb, threads=ky * lb)
    raise ValueError(
        f"lane_fused_elem: a window of {wr} rows with {n_states} state(s) "
        f"does not fit {SMEM_PER_BLOCK} bytes of shared memory in any block "
        f"layout of {configs}")


def lane_fused_elem(values, starts, idx, cell_data, law: FusedLaw, *,
                    wr: int, nv: int):
    """Fused gather -> element function -> bin scatter, one pass over the
    cell data: neither the gathered dofs nor the element vectors touch
    global memory.

    values: tuple of state tensors, each (C, R, 128) -- ``(u,)`` gives the
      element gradient (residual), ``(u, v)`` the Hessian-vector product
      (tangent action). All share ``starts`` / ``idx``.
    starts (T,) int32 window row starts; idx (T, nv, K, 128) in [-1, wr).
    cell_data: ``(geometry,)`` or ``(geometry, coefficients)``: the
      (T, 7, K, 128) rows dN[v][d] at v*2+d then the weight, and the
      (T, Dc, K, 128) coefficient rows ``law`` points into.
    law: the hand-written physics (:class:`FusedLaw`) -- the reference
      traces an ``elem_fn`` into its kernel here.

    Returns the (T, C, wr, 128) bin partials
      out[t,c,r,j] = sum_{k,v: idx[t,v,k,j]==r} ev[v*C+c, k, j]
    as a view of channel-leading (C, T, wr, 128) storage, so
    ``out.permute(1, 0, 2, 3)`` is contiguous and free.
    """
    values, cell_data = tuple(values), tuple(cell_data)
    if values[0].device.type != "cuda":
        return lane_fused_elem_plain(values, starts, idx, cell_data, law,
                                     wr=wr, nv=nv)
    dev = values[0].device
    vdt = values[0].dtype
    for i, v in enumerate(values):
        _check(f"values[{i}]", v, device=dev, dtypes=(vdt,))
    _check("values[0]", values[0], device=dev, dtypes=_VT)
    _check("idx", idx, device=dev, dtypes=_IT)
    for i, cd in enumerate(cell_data):
        _check(f"cell_data[{i}]", cd, device=dev, dtypes=(vdt,))
    C, R, T, K, Dc = _check_fused_shapes(values, idx, cell_data, law, nv)
    _check("starts", starts, device=dev, dtypes=(torch.int32,), shape=(T,))

    def src(s):  # (offset, rows, constant) of a CellScalar
        return (s[0], s[1], 0.0) if isinstance(s, tuple) else (0, 0, float(s))

    _check_aligned("lane_fused_elem", *values, idx, *cell_data)
    dn = law.rows_needed()
    g = fused_elem_geometry(len(values), int(wr), dn, values[0].element_size(),
                            idx.element_size(), FUSED_CONFIGS)
    klam, kmu = law.lame_factors()
    out = torch.empty((C, T, wr, N_LANES), dtype=vdt, device=dev)
    lib = _build.load()
    code = lib.lane_fused_elem(
        _VT[vdt], _IT[idx.dtype], _LAWS[law.name], len(values),
        values[0].data_ptr(),
        values[1].data_ptr() if len(values) == 2 else None,
        starts.data_ptr(), idx.data_ptr(), cell_data[0].data_ptr(),
        cell_data[1].data_ptr() if Dc else None, out.data_ptr(),
        R, T, K, int(wr), Dc,
        *(src(law.d) if law.name == "asym_damage" else (0, 0, 0.0)),
        *src(law.E), klam, kmu, g["lb"], g["ky"], g["stages"], dn,
        g["smem"], _stream(dev),
    )
    _raise_on(code, "lane_fused_elem")
    lane_fused_elem.launches += 1
    return out.permute(1, 0, 2, 3)


# -- K5: weighted gather-sum (two-level transfers) -----------------------------


def lane_gather_weighted_plain(values, starts, idx, wts, *, wr: int):
    """Plain version of :func:`lane_gather_weighted`: one gather and one
    multiply-add per v, v ascending -- the kernel's order of additions."""
    C, R, L = values.shape
    T, V, K, _ = idx.shape
    ii = idx.to(torch.int64)
    rows = starts.to(torch.int64).view(T, 1, 1, 1) + ii.clamp(min=0)
    valid = (ii >= 0) & (ii < wr) & (rows < R)
    rows = rows.clamp(max=R - 1)
    lane = torch.arange(L, device=values.device)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    out = torch.zeros((C, T, K, L), dtype=values.dtype, device=values.device)
    for v in range(V):
        g = values[:, rows[:, v], lane]  # (C, T, K, L)
        out = out + torch.where(valid[:, v], wts[:, v] * g, zero)
    return out.permute(1, 0, 2, 3)


def lane_gather_weighted(values, starts, idx, wts, *, wr: int):
    """Weighted windowed gather-sum, the restriction / prolongation
    primitive of the two-level preconditioner:

      out[t, c, k, j] = sum_v wts[t,v,k,j] * values[c, starts[t]+idx[t,v,k,j], j]

    values (C, R, 128) with C <= 4 and idx 16-byte aligned; starts (T,) int32
    (>= 0); idx (T, V, K, 128) int8/int32 in [-1, wr) (a row at or past R
    adds nothing); wts (T, V, K, 128) of the values' dtype. Returns
    (T, C, K, 128) as a view of channel-leading (C, T, K, 128) storage, so
    ``out.permute(1, 0, 2, 3)`` is contiguous and free. The launch
    geometry is :func:`gather_weighted_geometry`'s.
    """
    if values.device.type != "cuda":
        return lane_gather_weighted_plain(values, starts, idx, wts, wr=wr)
    geo = check_gather_weighted(values, starts, idx, wts, wr=wr)
    dev = values.device
    C, R, L = values.shape
    T, V, K, _ = idx.shape
    out = torch.empty((C, T, K, L), dtype=values.dtype, device=dev)
    lib = _build.load()
    code = lib.lane_gather_weighted(
        _VT[values.dtype], _IT[idx.dtype], values.data_ptr(),
        starts.data_ptr(), idx.data_ptr(), wts.data_ptr(), out.data_ptr(),
        C, R, T, V, K, int(wr), geo["ky"], int(geo["tiles"]), geo["smem"],
        _stream(dev),
    )
    _raise_on(code, "lane_gather_weighted")
    lane_gather_weighted.launches += 1
    return out.permute(1, 0, 2, 3)


def check_gather_weighted(values, starts, idx, wts, *, wr: int) -> dict:
    """The host-side checks of :func:`lane_gather_weighted` (device,
    dtypes, shapes, contiguity, 16-byte alignment of ``values`` and
    ``idx``); returns the launch geometry. Raises ``ValueError`` /
    ``TypeError``."""
    C, V, K = _check_window_args("lane_gather_weighted", values, starts,
                                 idx)
    _check("wts", wts, device=values.device, dtypes=(values.dtype,),
           shape=idx.shape)
    return gather_weighted_geometry(C, V, int(wr), K, values.element_size(),
                                    idx.element_size())


# -- K9: gather, channel-major output ------------------------------------------


def lane_gather_plain(values, starts, idx, *, wr: int, sum_v: bool = False):
    """Plain version of :func:`lane_gather`: advanced indexing, and with
    ``sum_v`` one add per v, v ascending -- the kernel's order."""
    C, R, L = values.shape
    T, V, K, _ = idx.shape
    ii = idx.to(torch.int64)
    rows = starts.to(torch.int64).view(T, 1, 1, 1) + ii.clamp(min=0)
    valid = (ii >= 0) & (ii < wr) & (rows < R)
    lane = torch.arange(L, device=values.device)
    g = values[:, rows.clamp(max=R - 1), lane]  # (C, T, V, K, L)
    g = torch.where(valid, g, torch.zeros((), dtype=g.dtype, device=g.device))
    if not sum_v:
        return g.permute(1, 0, 2, 3, 4).contiguous()
    out = torch.zeros((C, T, K, L), dtype=values.dtype, device=values.device)
    for v in range(V):
        out = out + g[:, :, v]
    return out.permute(1, 0, 2, 3).contiguous()


def lane_gather(values, starts, idx, *, wr: int, sum_v: bool = False):
    """Windowed per-lane gather:

      out[t, c, v, k, j] = values[c, starts[t] + idx[t,v,k,j], j]

    values (C, R, 128) and idx 16-byte aligned; starts (T,) int32 window
    row starts (>= 0); idx (T, V, K, 128) int8/int32 in [-1, wr) (a row at
    or past R gives 0). Returns (T, C, V, K, 128), or (T, C, K, 128)
    summed over v when ``sum_v``. The sum runs over v ascending in kernel
    and plain version alike; the reference sums window rows ascending
    (each row's value times its count of hits), so the two agree to
    rounding, not bitwise. The launch geometry is
    :func:`gather_geometry`'s.
    """
    if values.device.type != "cuda":
        return lane_gather_plain(values, starts, idx, wr=wr, sum_v=sum_v)
    geo = check_gather(values, starts, idx, wr=wr)
    dev = values.device
    C, R, L = values.shape
    T, V, K, _ = idx.shape
    shape = (T, C, K, L) if sum_v else (T, C, V, K, L)
    out = torch.empty(shape, dtype=values.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load()
    code = lib.lane_gather(
        _VT[values.dtype], _IT[idx.dtype], values.data_ptr(),
        starts.data_ptr(), idx.data_ptr(), out.data_ptr(),
        C, R, T, V, K, geo["wr"], int(bool(sum_v)), geo["ky"],
        int(geo["tiles"]), geo["smem"], _stream(dev),
    )
    _raise_on(code, "lane_gather")
    lane_gather.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def gather_geometry(C: int, V: int, wr: int, K: int, vbytes: int,
                    ibytes: int) -> dict:
    """Launch geometry of :func:`lane_gather`'s kernel (K9), laid out as
    :func:`gather_cm_geometry`'s: blocks of GATHER_LB lane columns of one
    bin, thread (x, y) writing rows y, y + ky, ... of column x for every
    channel and v. Where the window and the index rows fit a block's
    shared memory the block stages them (``tiles``); else it reads both
    straight from global memory (``smem`` 0), so that every shape gets a
    geometry (C, K >= 1). ``wr`` <= 0 gives an empty window (no index is
    valid); the geometry carries the ``wr`` the kernel takes."""
    wr = max(wr, 0)
    return dict(_window_geometry("lane_gather", C, V, wr, K, vbytes, ibytes,
                                 False, direct=True), wr=wr)


def check_gather(values, starts, idx, *, wr: int) -> dict:
    """The host-side checks of :func:`lane_gather` (device, dtypes,
    shapes, contiguity, 16-byte alignment of ``values`` and ``idx``);
    returns the launch geometry. Raises ``ValueError`` / ``TypeError``."""
    C, V, K = _check_window_args("lane_gather", values, starts, idx,
                                 min_rows=0)
    # (an empty output launches nothing)
    return gather_geometry(max(C, 1), V, int(wr), max(K, 1),
                           values.element_size(), idx.element_size())


# -- K10 / K11: windowed scatter-adds ------------------------------------------


def _scatter_rows_plain(src, starts, dest_idx, wts, *, sk, k_out):
    """The plain scatter-add of K10 (``wts`` None) and K11: one
    ``scatter_add_`` per (r, d), r outer and d inner -- each call has at
    most one source per destination, so the order of additions is exactly
    the kernels'."""
    C, S, L = src.shape
    T, D = dest_idx.shape[:2]
    ii = dest_idx.to(torch.int64)
    rows = starts.to(torch.int64).view(T, 1) + torch.arange(
        sk, device=src.device)  # (T, sk)
    ok = (ii >= 0) & (ii < k_out) & (rows < S).view(T, 1, sk, 1)
    ii = torch.where(ok, ii, torch.full_like(ii, k_out))  # dump row
    vals = src[:, rows.clamp(max=S - 1)].permute(1, 0, 2, 3)  # (T, C, sk, L)
    out = torch.zeros((T, C, k_out + 1, L), dtype=src.dtype,
                      device=src.device)
    for r in range(sk):
        v = vals[:, :, r:r + 1]  # (T, C, 1, L)
        for d in range(D):
            dest = ii[:, d, r].view(T, 1, 1, L).expand(T, C, 1, L)
            add = v if wts is None else wts[:, d, r].view(T, 1, 1, L) * v
            out.scatter_add_(2, dest, add)
    return out[:, :, :k_out].contiguous()


def lane_scatter_plain(src, starts, dest_idx, *, sk: int, k_out: int):
    """Plain version of :func:`lane_scatter` (r ascending)."""
    if dest_idx.shape[1] != sk:
        raise ValueError(f"lane_scatter: dest_idx has {dest_idx.shape[1]} "
                         f"rows, sk = {sk}")
    return _scatter_rows_plain(src, starts, dest_idx[:, None], None, sk=sk,
                               k_out=k_out)


def lane_scatter(src, starts, dest_idx, *, sk: int, k_out: int):
    """Windowed per-lane scatter-add (the transpose of :func:`lane_gather`
    for one v):

      out[t, c, q, j] = sum_{r: dest_idx[t,r,j]==q} src[c, starts[t]+r, j]

    src (C, S, 128); starts (T,) int32 source-window row starts (>= 0);
    dest_idx (T, sk, 128) int8/int32 in [-1, k_out). Returns
    (T, C, k_out, 128). Rows are added r ascending, the reference's order:
    kernel, plain version and reference agree bitwise.
    """
    if src.device.type != "cuda":
        return lane_scatter_plain(src, starts, dest_idx, sk=sk, k_out=k_out)
    dev = src.device
    _check("src", src, device=dev, dtypes=_VT)
    C, S, L = src.shape
    _check("dest_idx", dest_idx, device=dev, dtypes=_IT)
    T, SK, L2 = dest_idx.shape
    if L != N_LANES or L2 != N_LANES or SK != sk:
        raise ValueError("lane_scatter: bad lane width or dest_idx rows != sk")
    _check("starts", starts, device=dev, dtypes=(torch.int32,), shape=(T,))
    out = torch.empty((T, C, k_out, L), dtype=src.dtype, device=dev)
    lib = _build.load()
    code = lib.lane_scatter(
        _VT[src.dtype], _IT[dest_idx.dtype], src.data_ptr(),
        starts.data_ptr(), dest_idx.data_ptr(), out.data_ptr(),
        C, S, T, int(sk), int(k_out), _stream(dev),
    )
    _raise_on(code, "lane_scatter")
    lane_scatter.launches += 1
    return out


def lane_scatter_weighted_plain(src, starts, dest_idx, wts, *, sk: int,
                                k_out: int, n_dest: int):
    """Plain version of :func:`lane_scatter_weighted` (r outer, d inner,
    each product rounded before its add)."""
    if tuple(dest_idx.shape[1:3]) != (n_dest, sk):
        raise ValueError("lane_scatter_weighted: dest_idx must be "
                         f"(T, n_dest={n_dest}, sk={sk}, 128)")
    return _scatter_rows_plain(src, starts, dest_idx, wts, sk=sk,
                               k_out=k_out)


def lane_scatter_weighted(src, starts, dest_idx, wts, *, sk: int, k_out: int,
                          n_dest: int):
    """Weighted multi-destination scatter-add, the transpose of
    :func:`lane_gather_weighted`:

      out[t, c, q, j] += wts[t,d,r,j] * src[c, starts[t]+r, j]
        for every (d, r) with dest_idx[t,d,r,j] == q

    src (C, S, 128), dest_idx and wts 16-byte aligned; starts (T,) int32
    (>= 0); dest_idx (T, n_dest, sk, 128) int8/int32 in [-1, k_out) (a
    source row at or past S adds nothing); wts of that shape in the src's
    dtype. Returns (T, C, k_out, 128). Products are added r outer, d inner,
    the reference's order: kernel, plain version and reference agree
    bitwise. The launch geometry is :func:`scatter_weighted_geometry`'s.
    """
    if src.device.type != "cuda":
        return lane_scatter_weighted_plain(src, starts, dest_idx, wts, sk=sk,
                                           k_out=k_out, n_dest=n_dest)
    geo = check_scatter_weighted(src, starts, dest_idx, wts, sk=sk,
                                 k_out=k_out, n_dest=n_dest)
    dev = src.device
    C, S, L = src.shape
    T, D = dest_idx.shape[:2]
    out = torch.empty((T, C, k_out, L), dtype=src.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load()
    code = lib.lane_scatter_weighted(
        _VT[src.dtype], _IT[dest_idx.dtype], src.data_ptr(),
        starts.data_ptr(), dest_idx.data_ptr(), wts.data_ptr(),
        out.data_ptr(), C, S, T, D, int(sk), int(k_out), geo["ky"],
        geo["cb"], geo["rc"], int(geo["tiles"]), geo["smem"], _stream(dev),
    )
    _raise_on(code, "lane_scatter_weighted")
    lane_scatter_weighted.launches += 1
    return out


# the constants of csrc/lane_scatter_weighted.cu
SCATTER_KY = 4  # thread rows of a block at least (the copies) ...
SCATTER_KY_MAX = 16  # ... and at most: one a channel of its group between
SCATTER_MIN_ROWS = 8  # window rows of a chunk at least (where sk has them)
# blocks of ky thread rows an SM's registers hold: 32 // ky (ptxas gives
# the kernel at most 64 registers a thread)
SCATTER_REG_ROWS = 32


def scatter_layout_bytes(cb: int, k_out: int, rc: int, D: int, vbytes: int,
                         ibytes: int, tiles: bool = True) -> int:
    """Shared memory of one block of :func:`lane_scatter_weighted`'s kernel
    (csrc/lane_scatter_weighted.cu:gs_smem_bytes): the accumulator (``cb``
    channels x ``k_out`` rows x GATHER_LB values), a chunk of ``rc`` window
    rows of those channels and, where the tables are staged (``tiles``),
    the chunk's D x rc index and weight rows."""
    lb = GATHER_LB
    return (cb * k_out * lb * vbytes + cb * rc * lb * vbytes
            + (D * rc * lb * (ibytes + vbytes) if tiles else 0))


@functools.lru_cache(maxsize=64)
def scatter_weighted_geometry(C: int, D: int, sk: int, k_out: int,
                              vbytes: int, ibytes: int) -> dict:
    """Launch geometry of :func:`lane_scatter_weighted`'s kernel for C
    channels, D destinations a source row, a window of ``sk`` rows,
    ``k_out`` output rows and the value / index element sizes in bytes.

    A block serves one bin, GATHER_LB lane columns and a group of ``cb``
    channels (grid: bins x ``slabs`` x ``groups``), with ``block`` =
    (GATHER_LB, ``ky``) threads, ``ky`` = cb within [SCATTER_KY,
    SCATTER_KY_MAX]; thread row y adds channels y, y + ky, ... of the
    group, and every thread copies and writes back. It keeps its (cb,
    k_out) accumulator in shared memory and walks the window in ``chunks``
    of ``rc`` rows, staging each chunk's window rows and, where ``tiles``,
    its index and weight rows (:func:`scatter_layout_bytes`, ``smem``).
    Each block's walk is serial, so the layout is chosen for ``blocks`` an
    SM: in this order, the tables staged with every channel in one block
    (tables read once), fewer channels a block, the tables not staged --
    the first that holds two blocks an SM with SCATTER_MIN_ROWS rows a
    chunk (fewer where sk is smaller), then one block of one row; then
    the chunk height that keeps the most blocks an SM (shared memory, and
    registers: SCATTER_REG_ROWS // ky blocks), the most rows among those,
    chunks of equal size. ``ValueError`` where not even one channel and
    one row fit a block."""
    if (C < 1 or D < 0 or sk < 0 or k_out < 1 or vbytes not in (4, 8)
            or ibytes not in (1, 4)):
        raise ValueError(f"lane_scatter_weighted: C = {C}, k_out = {k_out} "
                         f"(>= 1), D = {D}, sk = {sk} (>= 0), {vbytes}-byte "
                         f"values, {ibytes}-byte indices")
    lb = GATHER_LB
    rows = max(sk, 1)
    for need, rmin in ((2, min(rows, SCATTER_MIN_ROWS)), (1, 1)):
        for tiles in (True, False):
            for cb in range(C, 0, -1):
                ky = min(max(cb, SCATTER_KY), SCATTER_KY_MAX)
                fixed = scatter_layout_bytes(cb, k_out, 0, D, vbytes, ibytes)
                row = scatter_layout_bytes(cb, 0, 1, D, vbytes, ibytes, tiles)

                def blocks(rc):
                    return min(max(SCATTER_REG_ROWS // ky, 1),
                               SMEM_PER_SM // (fixed + rc * row
                                               + SMEM_RESERVED))

                if (fixed + rmin * row > SMEM_PER_BLOCK
                        or blocks(rmin) < need):
                    continue
                nb = blocks(rmin)
                rc = min(rows, (SMEM_PER_BLOCK - fixed) // row,
                         (SMEM_PER_SM // nb - SMEM_RESERVED - fixed) // row)
                chunks = -(-rows // rc)
                rc = -(-rows // chunks)
                return dict(block=(lb, ky), ky=ky, cb=cb, groups=-(-C // cb),
                            rc=rc, chunks=-(-sk // rc), tiles=tiles,
                            blocks=nb, slabs=N_LANES // lb,
                            smem=fixed + rc * row)
    raise ValueError(
        f"lane_scatter_weighted: an accumulator of k_out = {k_out} rows and "
        f"a window row of {GATHER_LB} lanes and {vbytes}-byte values do not "
        f"fit {SMEM_PER_BLOCK} bytes of shared memory")


def scatter_cover(geo: dict, T: int, C: int, k_out: int):
    """How many times the kernel of ``geo`` (:func:`scatter_weighted_geometry`)
    writes each output (t, c, q, lane) of T bins: block (t, g, s), thread
    (x, y) writes lane s * lb + x of the rows i = y, y + ky, ... of the
    block's (cb, k_out) slab, channel g * cb + i // k_out (below C), row
    q = i % k_out."""
    lb, ky = geo["block"]
    cb = geo["cb"]
    counts = np.zeros((T, C, k_out, N_LANES), np.int64)
    for g in range(geo["groups"]):
        cg = min(cb, C - g * cb)  # the channels of the last group
        for s in range(geo["slabs"]):
            for y in range(ky):
                for i in range(y, cg * k_out, ky):
                    counts[:, g * cb + i // k_out, i % k_out,
                           s * lb:(s + 1) * lb] += 1
    return counts


def check_scatter_weighted(src, starts, dest_idx, wts, *, sk: int, k_out: int,
                           n_dest: int) -> dict:
    """The host-side checks of :func:`lane_scatter_weighted` (device,
    dtypes, shapes, contiguity, 16-byte alignment of ``src``,
    ``dest_idx`` and ``wts``); returns the launch geometry. Raises
    ``ValueError`` / ``TypeError``."""
    dev = src.device
    _check("src", src, device=dev, dtypes=_VT)
    C, S, L = src.shape
    _check("dest_idx", dest_idx, device=dev, dtypes=_IT)
    T, D, SK, L2 = dest_idx.shape
    _check("wts", wts, device=dev, dtypes=(src.dtype,), shape=dest_idx.shape)
    if L != N_LANES or L2 != N_LANES or SK != sk or D != n_dest:
        raise ValueError("lane_scatter_weighted: bad lane width, or "
                         "dest_idx not (T, n_dest, sk, 128)")
    _check("starts", starts, device=dev, dtypes=(torch.int32,), shape=(T,))
    # the kernel stages the window, the index and the weight rows by
    # 16-byte asynchronous copies
    _check_aligned("lane_scatter_weighted", src, dest_idx, wts)
    # (an empty output launches nothing)
    return scatter_weighted_geometry(max(C, 1), D, int(sk),
                                     max(int(k_out), 1), src.element_size(),
                                     dest_idx.element_size())


reset_launch_counts()
