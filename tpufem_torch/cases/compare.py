"""Cross-implementation comparison harness (the reference's IN_COMP).

Reimplements the validation machinery of MFEM/mechanic2d/
asym_elasto_damage_model.cc:1662-1758 (OUT_COMP binary dump + IN_COMP
re-read) and FEniCSx/...cc:1037-1169 (sorted-coordinate matching +
per-component L2 displacement error + summed element energy error).
Acceptance levels from the study: AD-vs-hand ≈ 1e-15, FEniCSx-vs-MFEM ≈
solver tolerance (doc.tex:2215-2257).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def dump_displacements(path: str, coords: np.ndarray, u: np.ndarray) -> None:
    """OUT_COMP-style binary dump: (x, y[, z], u components) per node
    (MFEM/...cc:1671-1687 writes x,y,ux,uy doubles)."""
    arr = np.concatenate(
        [np.asarray(coords, np.float64), np.asarray(u, np.float64)], axis=1
    )
    with open(path, "wb") as fh:
        np.array([arr.shape[0], arr.shape[1]], dtype=np.int64).tofile(fh)
        arr.tofile(fh)


def load_displacements(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as fh:
        n, m = np.fromfile(fh, dtype=np.int64, count=2)
        arr = np.fromfile(fh, dtype=np.float64).reshape(n, m)
    gdim = m // 2
    return arr[:, :gdim], arr[:, gdim:]


def match_by_coordinates(
    coords_a: np.ndarray, coords_b: np.ndarray, tol: float = 1e-10
) -> np.ndarray:
    """For each row of coords_a find the matching row of coords_b, by
    lexicographic sort + binary search — the FEniCSx IN_COMP matching
    strategy (sorted-coordinate search, FEniCSx/...cc:1064-1123).

    Returns idx such that coords_b[idx] ≈ coords_a; raises if any point
    has no match within tol.
    """
    a = np.asarray(coords_a, np.float64)
    b = np.asarray(coords_b, np.float64)
    order = np.lexsort(b.T[::-1])
    b_sorted = b[order]
    # search on first coordinate, then scan the tied block
    idx = np.empty(len(a), dtype=np.int64)
    first = b_sorted[:, 0]
    lo = np.searchsorted(first, a[:, 0] - tol, side="left")
    hi = np.searchsorted(first, a[:, 0] + tol, side="right")
    for i in range(len(a)):
        block = b_sorted[lo[i] : hi[i]]
        if len(block) == 0:
            raise ValueError(f"no coordinate match for point {a[i]}")
        d = np.abs(block - a[i]).max(axis=1)
        j = np.argmin(d)
        if d[j] > tol:
            raise ValueError(f"no coordinate match for point {a[i]} (min {d[j]})")
        idx[i] = order[lo[i] + j]
    return idx


@dataclasses.dataclass
class ComparisonResult:
    l2_per_component: np.ndarray  # (bs,) L2 norms of the difference
    linf_per_component: np.ndarray
    energy_error: float  # |sum E_a - sum E_b| over elements (if given)

    def __str__(self):  # pragma: no cover
        comps = ", ".join(
            f"L2[{i}]={v:.6e}" for i, v in enumerate(self.l2_per_component)
        )
        return f"{comps}, EE={self.energy_error:.6e}"


def compare_fields(
    coords_a: np.ndarray,
    u_a: np.ndarray,
    coords_b: np.ndarray,
    u_b: np.ndarray,
    energy_a: np.ndarray = None,
    energy_b: np.ndarray = None,
    tol: float = 1e-10,
) -> ComparisonResult:
    """Per-component L2/Linf displacement error after coordinate matching,
    plus summed element-energy-density error (the IN_COMP report,
    FEniCSx/...cc:1124-1169)."""
    idx = match_by_coordinates(coords_a, coords_b, tol)
    diff = np.asarray(u_a) - np.asarray(u_b)[idx]
    l2 = np.sqrt((diff**2).sum(axis=0))
    linf = np.abs(diff).max(axis=0)
    ee = 0.0
    if energy_a is not None and energy_b is not None:
        ee = float(abs(np.sum(energy_a) - np.sum(energy_b)))
    return ComparisonResult(
        l2_per_component=l2, linf_per_component=linf, energy_error=ee
    )
