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
from typing import Sequence, Tuple, Union

import torch

from tpufem_torch.forms.potentials import (asym_damage_stress_components,
                                           asym_damage_stress_jvp_components)

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

    klam, kmu = law.lame_factors()
    out = torch.empty((C, T, wr, N_LANES), dtype=vdt, device=dev)
    lib = _build.load()
    code = lib.lane_fused_elem(
        _VT[vdt], _IT[idx.dtype], _LAWS[law.name], len(values),
        values[0].data_ptr(),
        values[1].data_ptr() if len(values) == 2 else None,
        starts.data_ptr(), idx.data_ptr(), cell_data[0].data_ptr(),
        cell_data[1].data_ptr() if Dc else None, out.data_ptr(),
        R, T, K, int(wr), Dc, *src(law.d), *src(law.E), klam, kmu,
        _stream(dev),
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

    values (C, R, 128) with C <= 4; starts (T,) int32; idx (T, V, K, 128)
    int8/int32 in [-1, wr); wts (T, V, K, 128) of the values' dtype.
    Returns (T, C, K, 128) as a view of channel-leading (C, T, K, 128)
    storage, so ``out.permute(1, 0, 2, 3)`` is contiguous and free.
    """
    if values.device.type != "cuda":
        return lane_gather_weighted_plain(values, starts, idx, wts, wr=wr)
    dev = values.device
    _check("values", values, device=dev, dtypes=_VT)
    C, R, L = values.shape
    _check("idx", idx, device=dev, dtypes=_IT)
    T, V, K, L2 = idx.shape
    _check("wts", wts, device=dev, dtypes=(values.dtype,), shape=idx.shape)
    if L != N_LANES or L2 != N_LANES or not 1 <= C <= 4:
        raise ValueError("lane_gather_weighted: bad lane width or C > 4")
    _check("starts", starts, device=dev, dtypes=(torch.int32,), shape=(T,))
    out = torch.empty((C, T, K, L), dtype=values.dtype, device=dev)
    lib = _build.load()
    code = lib.lane_gather_weighted(
        _VT[values.dtype], _IT[idx.dtype], values.data_ptr(),
        starts.data_ptr(), idx.data_ptr(), wts.data_ptr(), out.data_ptr(),
        C, R, T, V, K, int(wr), _stream(dev),
    )
    _raise_on(code, "lane_gather_weighted")
    lane_gather_weighted.launches += 1
    return out.permute(1, 0, 2, 3)


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

    values (C, R, 128); starts (T,) int32 window row starts (>= 0); idx
    (T, V, K, 128) int8/int32 in [-1, wr). Returns (T, C, V, K, 128), or
    (T, C, K, 128) summed over v when ``sum_v``. The sum runs over v
    ascending in kernel and plain version alike; the reference sums window
    rows ascending (each row's value times its count of hits), so the two
    agree to rounding, not bitwise.
    """
    if values.device.type != "cuda":
        return lane_gather_plain(values, starts, idx, wr=wr, sum_v=sum_v)
    dev = values.device
    _check("values", values, device=dev, dtypes=_VT)
    C, R, L = values.shape
    _check("idx", idx, device=dev, dtypes=_IT)
    T, V, K, L2 = idx.shape
    if L != N_LANES or L2 != N_LANES:
        raise ValueError("lane_gather: bad lane width")
    _check("starts", starts, device=dev, dtypes=(torch.int32,), shape=(T,))
    shape = (T, C, K, L) if sum_v else (T, C, V, K, L)
    out = torch.empty(shape, dtype=values.dtype, device=dev)
    lib = _build.load()
    code = lib.lane_gather(
        _VT[values.dtype], _IT[idx.dtype], values.data_ptr(),
        starts.data_ptr(), idx.data_ptr(), out.data_ptr(),
        C, R, T, V, K, int(wr), int(bool(sum_v)), _stream(dev),
    )
    _raise_on(code, "lane_gather")
    lane_gather.launches += 1
    return out


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

    src (C, S, 128); starts (T,) int32 (>= 0); dest_idx (T, n_dest, sk,
    128) int8/int32 in [-1, k_out); wts of that shape in the src's dtype.
    Returns (T, C, k_out, 128). Products are added r outer, d inner, the
    reference's order: kernel, plain version and reference agree bitwise.
    """
    if src.device.type != "cuda":
        return lane_scatter_weighted_plain(src, starts, dest_idx, wts, sk=sk,
                                           k_out=k_out, n_dest=n_dest)
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
    out = torch.empty((T, C, k_out, L), dtype=src.dtype, device=dev)
    lib = _build.load()
    code = lib.lane_scatter_weighted(
        _VT[src.dtype], _IT[dest_idx.dtype], src.data_ptr(),
        starts.data_ptr(), dest_idx.data_ptr(), wts.data_ptr(),
        out.data_ptr(), C, S, T, D, int(sk), int(k_out), _stream(dev),
    )
    _raise_on(code, "lane_scatter_weighted")
    lane_scatter_weighted.launches += 1
    return out


reset_launch_counts()
