"""Host-side NumPy helpers for large-mesh preprocessing.

The naive ``x[cells]`` row-gather materializes an (nc, nv, gdim)
array-of-structs and any subsequent transpose/reduction walks it with
hostile strides — measured ~6x slower than component-wise 1D gathers at
2M cells on the target host (same pathology the lane engine's geometry
build hit; see lane/engine.py). These helpers do the per-(vertex,
component) 1D gathers directly into the destination layout.
"""

from __future__ import annotations

import numpy as np


def cells_minor_coords(x: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Per-cell vertex coordinates in cells-minor layout: (nv, gdim, nc).

    Equivalent to ``np.ascontiguousarray(x[cells].transpose(1, 2, 0))``
    without the array-of-structs intermediate.
    """
    nc, nv = cells.shape
    gdim = x.shape[1]
    xT = [np.ascontiguousarray(x[:, d]) for d in range(gdim)]
    out = np.empty((nv, gdim, nc), dtype=x.dtype)
    for v in range(nv):
        col = cells[:, v]
        for d in range(gdim):
            out[v, d] = xT[d][col]
    return out


def cell_centroids(x: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Cell centroids (nc, gdim) == ``x[cells].mean(axis=1)`` without the
    (nc, nv, gdim) intermediate."""
    nc, nv = cells.shape
    gdim = x.shape[1]
    out = np.empty((nc, gdim), dtype=np.promote_types(x.dtype, np.float64))
    xT = [np.ascontiguousarray(x[:, d]) for d in range(gdim)]
    for d in range(gdim):
        acc = xT[d][cells[:, 0]].astype(out.dtype)
        for v in range(1, nv):
            acc += xT[d][cells[:, v]]
        out[:, d] = acc
    out /= nv
    return out
