"""ctypes bridge to the native host runtime
(``tpufem_torch/csrc/tpufem_native.cpp``, the port's own copy of the
source).

Builds the shared library on first use with the system compiler, into
``tpufem_torch/build/``, and falls back to NumPy implementations when
no compiler is available, so the package stays importable everywhere.
All of this is host preprocessing (mesh entities, lane planning, damage
smoothing); the device compute path is PyTorch/CUDA and never touches
it (SA-AMG's aggregation, ``amg_aggregate``, is host set-up too). Only
the entry points the port's modules call are bound.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "tpufem_native.cpp")
_SO = os.path.join(_PKG, "build", "libtpufem_native.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if os.environ.get("TPUFEM_TORCH_NO_NATIVE"):
            # test hook: force every NumPy fallback path
            _build_failed = True
            return None
        try:
            if not os.path.exists(_SO) or os.path.getmtime(
                _SO
            ) < os.path.getmtime(_SRC):
                os.makedirs(os.path.dirname(_SO), exist_ok=True)
                subprocess.run(
                    [
                        "g++", "-O3", "-march=native", "-std=c++17",
                        "-shared", "-fPIC", _SRC, "-o", _SO,
                    ],
                    check=True,
                    capture_output=True,
                )
            lib = ctypes.CDLL(_SO)
            lib.unique_entities.restype = ctypes.c_int64
            lib.gather_plan.restype = ctypes.c_int64
            lib.lane_balance.restype = ctypes.c_int64
            lib.lane_copies.restype = ctypes.c_int64
            lib.rank_by_key.restype = None
            lib.lane_gather_fill.restype = None
            lib.damage_smooth.restype = None
            lib.rcm_ordering.restype = None
            lib.morton_order.restype = None
            lib.amg_aggregate.restype = ctypes.c_int64
            lib.amg_aggregate.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            _lib = lib
        except Exception:
            _build_failed = True
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def unique_entities(cand: np.ndarray):
    """Sort-unique rows of a vertex-sorted (n, nv) int32 array.
    Returns (unique (nu, nv), inverse (n,))."""
    lib = _load()
    cand = np.ascontiguousarray(cand, dtype=np.int32)
    n, nv = cand.shape
    if lib is None or n == 0:
        uniq, inverse = np.unique(cand, axis=0, return_inverse=True)
        return uniq.astype(np.int32), inverse.astype(np.int64).ravel()
    out_e = np.empty((n, nv), dtype=np.int32)
    out_inv = np.empty(n, dtype=np.int64)
    nu = lib.unique_entities(
        _ptr(cand, ctypes.c_int32), ctypes.c_int64(n), ctypes.c_int64(nv),
        _ptr(out_e, ctypes.c_int32), _ptr(out_inv, ctypes.c_int64),
    )
    return out_e[:nu].copy(), out_inv


def gather_plan(targets: np.ndarray, n_targets: int):
    """Transposed scatter plan: returns (K, n_targets) int32 table with
    pad == len(targets). See GatherSumPlan."""
    lib = _load()
    targets = np.ascontiguousarray(targets, dtype=np.int64).ravel()
    n_src = targets.shape[0]
    if lib is None or n_src == 0:
        return None  # caller falls back to NumPy
    counts = np.bincount(targets, minlength=n_targets)
    K = int(counts.max()) if n_src else 1
    out = np.empty((max(K, 1), n_targets), dtype=np.int32)
    got = lib.gather_plan(
        _ptr(targets, ctypes.c_int64), ctypes.c_int64(n_src),
        ctypes.c_int64(n_targets), _ptr(out, ctypes.c_int32),
        ctypes.c_int64(max(K, 1)),
    )
    assert got == K, (got, K)
    return out


def amg_aggregate(indptr: np.ndarray, indices: np.ndarray,
                  data: np.ndarray):
    """Greedy Vanek aggregation on a symmetric CSR strength graph
    (zero diagonal removed). Returns (agg (n,), n_agg) or None if the
    native library is unavailable (caller falls back to NumPy)."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float64)
    n = len(indptr) - 1
    if len(indices) != indptr[-1] or len(data) != len(indices):
        raise ValueError("amg_aggregate: indptr, indices and data disagree")
    out = np.empty(n, dtype=np.int64)
    n_agg = lib.amg_aggregate(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_double), n, _ptr(out, ctypes.c_int64),
    )
    return out, int(n_agg)


def lane_balance(cand: np.ndarray, n_keys: int, target0: int):
    """Capacity-balanced cell->home-bin choice for the lane planner.
    ``cand`` is the (nc, nv) int64 candidate-bin-key table; returns the
    chosen candidate index per cell (nc,) int64, or None if the native
    library is unavailable (caller falls back to NumPy)."""
    lib = _load()
    if lib is None:
        return None
    cand = np.ascontiguousarray(cand, dtype=np.int64)
    nc, nv = cand.shape
    out = np.empty(nc, dtype=np.int64)
    if nc:
        lib.lane_balance(
            _ptr(cand, ctypes.c_int64), ctypes.c_int64(nc),
            ctypes.c_int64(nv), ctypes.c_int64(int(n_keys)),
            ctypes.c_int64(int(target0)), _ptr(out, ctypes.c_int64),
        )
    return out


def lane_copies(cells, cell_key, node_key, row_in_bin, wg_own: int):
    """Copies stage of the lane planner in one native pass: dedup
    (cell-bin, node) pairs, rank copies within bins, and emit the
    per-(cell, vertex) gather offsets. Returns (off (nc, nv), ubin,
    unode, urank, max_copies_per_bin) or None without the library."""
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    cell_key = np.ascontiguousarray(cell_key, dtype=np.int64)
    node_key = np.ascontiguousarray(node_key, dtype=np.int64)
    row_in_bin = np.ascontiguousarray(row_in_bin, dtype=np.int64)
    nc, nv = cells.shape
    cap = max(nc * nv, 1)
    off = np.empty(nc * nv, dtype=np.int64)
    ubin = np.empty(cap, dtype=np.int64)
    unode = np.empty(cap, dtype=np.int64)
    urank = np.empty(cap, dtype=np.int64)
    meta = np.zeros(1, dtype=np.int64)
    nu = 0
    if nc:
        nu = lib.lane_copies(
            _ptr(cells, ctypes.c_int64), _ptr(cell_key, ctypes.c_int64),
            _ptr(node_key, ctypes.c_int64),
            _ptr(row_in_bin, ctypes.c_int64),
            ctypes.c_int64(nc), ctypes.c_int64(nv),
            ctypes.c_int64(len(node_key)), ctypes.c_int64(int(wg_own)),
            _ptr(off, ctypes.c_int64), _ptr(ubin, ctypes.c_int64),
            _ptr(unode, ctypes.c_int64), _ptr(urank, ctypes.c_int64),
            _ptr(meta, ctypes.c_int64),
        )
    return (off.reshape(nc, nv), ubin[:nu].copy(), unode[:nu].copy(),
            urank[:nu].copy(), int(meta[0]))


def rank_by_key(keys: np.ndarray, n_keys: int):
    """Stable within-key rank (counting sort), or None without the
    native library."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    out = np.empty(len(keys), dtype=np.int64)
    if len(keys):
        lib.rank_by_key(
            _ptr(keys, ctypes.c_int64), ctypes.c_int64(len(keys)),
            ctypes.c_int64(int(n_keys)), _ptr(out, ctypes.c_int64),
        )
    return out


def lane_gather_fill(g, j, cpos, off, kc: int, G: int):
    """One-pass fill of (gather_idx, cell_order) for the lane planner;
    returns None without the native library."""
    lib = _load()
    if lib is None:
        return None
    g = np.ascontiguousarray(g, dtype=np.int64)
    j = np.ascontiguousarray(j, dtype=np.int64)
    cpos = np.ascontiguousarray(cpos, dtype=np.int64)
    off = np.ascontiguousarray(off, dtype=np.int64)
    nc, nv = off.shape
    gather_idx = np.full((G, nv, kc, 128), -1, dtype=np.int32)
    cell_order = np.full(G * kc * 128, -1, dtype=np.int64)
    if nc:
        lib.lane_gather_fill(
            _ptr(g, ctypes.c_int64), _ptr(j, ctypes.c_int64),
            _ptr(cpos, ctypes.c_int64), _ptr(off, ctypes.c_int64),
            ctypes.c_int64(nc), ctypes.c_int64(nv),
            ctypes.c_int64(int(kc)),
            _ptr(gather_idx, ctypes.c_int32),
            _ptr(cell_order, ctypes.c_int64),
        )
    return gather_idx, cell_order


def rcm_ordering(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (perm[new] = old)."""
    lib = _load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    n = len(indptr) - 1
    if lib is None:
        return _rcm_numpy(indptr, indices, n)
    out = np.empty(n, dtype=np.int32)
    lib.rcm_ordering(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        ctypes.c_int64(n), _ptr(out, ctypes.c_int32),
    )
    return out


def _rcm_numpy(indptr, indices, n):
    """NumPy RCM (the library sorts equal-degree neighbours with an
    unstable sort, so the two orders may differ; both are RCM orders)."""
    visited = np.zeros(n, dtype=bool)
    deg = np.diff(indptr)
    order = []
    while len(order) < n:
        unv = np.nonzero(~visited)[0]
        start = unv[np.argmin(deg[unv])]
        queue = [int(start)]
        visited[start] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            nbrs = [
                int(w)
                for w in indices[indptr[v]: indptr[v + 1]]
                if not visited[w]
            ]
            for w in nbrs:
                visited[w] = True
            nbrs.sort(key=lambda w: deg[w])
            queue.extend(nbrs)
    return np.array(order[::-1], dtype=np.int32)


def morton_order(coords: np.ndarray) -> np.ndarray:
    """Morton (Z-curve) order of points in up to 3 dimensions; returns
    order (rank -> point index). 20 bits a coordinate, ties by index."""
    lib = _load()
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    n, dim = coords.shape
    if lib is None:
        return _morton_numpy(coords)
    out = np.empty(n, dtype=np.int64)
    lib.morton_order(_ptr(coords, ctypes.c_double), ctypes.c_int64(n),
                     ctypes.c_int64(dim), _ptr(out, ctypes.c_int64))
    return out


def _morton_numpy(coords: np.ndarray, bits: int = 20) -> np.ndarray:
    """The library's ``morton_order`` in NumPy, code for code."""
    mins = coords.min(axis=0)
    span = coords.max(axis=0) - mins
    safe = np.where(span > 0, span, 1.0)
    x = np.where(span > 0, (coords - mins) / safe, 0.0)
    q = (x * float((1 << bits) - 1)).astype(np.uint64)
    code = np.zeros(len(coords), dtype=np.uint64)
    dim = coords.shape[1]
    for b in range(bits):
        for d in range(dim):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * dim + d)
    return np.argsort(code, kind="stable").astype(np.int64)


def damage_smooth(nb: np.ndarray, inv_deg: np.ndarray, d: np.ndarray,
                  iterations: int, thresh: float = 0.01):
    """Native two-half-step damage smoothing over the sentinel-padded
    ELL neighbor table (the reference loop of FEniCSx/...cc:414-473).
    Returns the smoothed (n,) f64 array, or None if the native library
    is unavailable (caller falls back to the NumPy twin)."""
    lib = _load()
    if lib is None:
        return None
    nb = np.ascontiguousarray(nb, dtype=np.int32)
    inv_deg = np.ascontiguousarray(inv_deg, dtype=np.float64)
    out = np.array(d, dtype=np.float64, copy=True, order="C")
    n, k = nb.shape
    lib.damage_smooth(
        _ptr(nb, ctypes.c_int32), ctypes.c_int64(n), ctypes.c_int64(k),
        _ptr(inv_deg, ctypes.c_double), _ptr(out, ctypes.c_double),
        ctypes.c_int64(iterations), ctypes.c_double(thresh),
    )
    return out
