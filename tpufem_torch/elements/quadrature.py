"""Gauss quadrature rules on reference cells.

Weights include the reference-cell measure (triangle area 1/2, tet volume
1/6, quad/hex volume 1). The reference workload forces degree-1 quadrature
on the stiffness term (``asym_ufl.py:78-79`` Measure metadata; MFEM ip1,
MFEM/...cc:1151-1153) and default degree on the load term — we expose the
same choice through the ``degree`` argument.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from tpufem_torch.mesh.mesh import CellType


def _gauss_legendre_01(n: int):
    """n-point Gauss-Legendre on [0,1]."""
    pts, wts = np.polynomial.legendre.leggauss(n)
    return 0.5 * (pts + 1.0), 0.5 * wts


@lru_cache(maxsize=None)
def quadrature(cell_type: str, degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (points (nq, dim), weights (nq,)) exact for ``degree``."""
    if cell_type == CellType.interval:
        n = max(1, (degree + 2) // 2)
        p, w = _gauss_legendre_01(n)
        return p[:, None], w

    if cell_type == CellType.triangle:
        if degree <= 1:
            return (np.array([[1.0 / 3.0, 1.0 / 3.0]]), np.array([0.5]))
        if degree == 2:
            # 3-point midpoint-of-edges rule, degree 2
            return (
                np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
                np.array([1 / 6, 1 / 6, 1 / 6]),
            )
        if degree == 3:
            return (
                np.array(
                    [[1 / 3, 1 / 3], [0.6, 0.2], [0.2, 0.6], [0.2, 0.2]]
                ),
                np.array([-27 / 96, 25 / 96, 25 / 96, 25 / 96]),
            )
        if degree <= 5:
            a1 = 0.0597158717897698
            b1 = 0.4701420641051151
            a2 = 0.7974269853530873
            b2 = 0.1012865073234563
            w1 = 0.1323941527885062
            w2 = 0.1259391805448271
            pts = np.array(
                [
                    [1 / 3, 1 / 3],
                    [a1, b1], [b1, a1], [b1, b1],
                    [a2, b2], [b2, a2], [b2, b2],
                ]
            )
            wts = np.array([0.225, w1, w1, w1, w2, w2, w2]) * 0.5
            return pts, wts
        # collapsed tensor product (Duffy) for high degree
        n = (degree + 2) // 2 + 1
        p, w = _gauss_legendre_01(n)
        X, Y = np.meshgrid(p, p, indexing="ij")
        W = np.outer(w, w)
        x = X.ravel()
        y = (Y * (1 - X)).ravel()
        wt = (W * (1 - X)).ravel()
        return np.stack([x, y], axis=1), wt

    if cell_type == CellType.tetra:
        if degree <= 1:
            return (np.array([[0.25, 0.25, 0.25]]), np.array([1.0 / 6.0]))
        if degree == 2:
            a = 0.5854101966249685
            b = 0.1381966011250105
            pts = np.array(
                [[a, b, b], [b, a, b], [b, b, a], [b, b, b]]
            )
            return pts, np.full(4, 1.0 / 24.0)
        # Duffy collapse
        n = (degree + 2) // 2 + 1
        p, w = _gauss_legendre_01(n)
        X, Y, Z = np.meshgrid(p, p, p, indexing="ij")
        W = np.einsum("i,j,k->ijk", w, w, w)
        x = X
        y = Y * (1 - X)
        z = Z * (1 - X) * (1 - Y * 0 + 0) * (1 - Y)  # z in remaining simplex
        jac = (1 - X) * (1 - X) * (1 - Y)
        pts = np.stack([x.ravel(), (y).ravel(), (z).ravel()], axis=1)
        return pts, (W * jac).ravel()

    if cell_type == CellType.quad:
        n = max(1, (degree + 2) // 2)
        p, w = _gauss_legendre_01(n)
        X, Y = np.meshgrid(p, p, indexing="ij")
        W = np.outer(w, w)
        return np.stack([X.ravel(), Y.ravel()], axis=1), W.ravel()

    if cell_type == CellType.hexahedron:
        n = max(1, (degree + 2) // 2)
        p, w = _gauss_legendre_01(n)
        X, Y, Z = np.meshgrid(p, p, p, indexing="ij")
        W = np.einsum("i,j,k->ijk", w, w, w)
        return (
            np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1),
            W.ravel(),
        )

    raise ValueError(cell_type)
