"""Structured mesh generators (unit square / rectangle / box).

Equivalent of dolfinx ``create_rectangle`` (used for scale studies,
doc.tex:486) and mfem's inline meshes. Used by tests and by the 1M+/10M-DoF
benchmark configurations (BASELINE.json configs 2/3/5) where no mesh file
is needed.
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.config import INDEX_DTYPE
from tpufem_torch.mesh.mesh import CellType, Mesh


def rectangle(nx: int, ny: int, *, cell_type: str = CellType.triangle,
              x0=(0.0, 0.0), x1=(1.0, 1.0), diagonal: str = "right") -> Mesh:
    """Structured nx×ny grid of triangles or quads on [x0, x1]."""
    xs = np.linspace(x0[0], x1[0], nx + 1)
    ys = np.linspace(x0[1], x1[1], ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return j * (nx + 1) + i

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    i = i.ravel()
    j = j.ravel()
    v00 = vid(i, j)
    v10 = vid(i + 1, j)
    v01 = vid(i, j + 1)
    v11 = vid(i + 1, j + 1)

    if cell_type == CellType.quad:
        cells = np.stack([v00, v10, v01, v11], axis=1)
    elif cell_type == CellType.triangle:
        if diagonal == "right":
            t0 = np.stack([v00, v10, v11], axis=1)
            t1 = np.stack([v00, v11, v01], axis=1)
        else:
            t0 = np.stack([v00, v10, v01], axis=1)
            t1 = np.stack([v10, v11, v01], axis=1)
        cells = np.concatenate([t0, t1], axis=0)
    else:
        raise ValueError(cell_type)

    return Mesh(
        x=pts,
        cells=cells.astype(INDEX_DTYPE),
        cell_type=cell_type,
        cell_tags=np.zeros(len(cells), dtype=INDEX_DTYPE),
    )


def unit_square(n: int, *, cell_type: str = CellType.triangle) -> Mesh:
    return rectangle(n, n, cell_type=cell_type)


def box(nx: int, ny: int, nz: int, *, cell_type: str = CellType.hexahedron,
        x0=(0.0, 0.0, 0.0), x1=(1.0, 1.0, 1.0)) -> Mesh:
    """Structured box of hexahedra or tetrahedra (6 tets per hex)."""
    xs = np.linspace(x0[0], x1[0], nx + 1)
    ys = np.linspace(x0[1], x1[1], ny + 1)
    zs = np.linspace(x0[2], x1[2], nz + 1)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (k * (ny + 1) + j) * (nx + 1) + i

    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    c = [vid(i + di, j + dj, k + dk)
         for dk in (0, 1) for dj in (0, 1) for di in (0, 1)]
    # tensor vertex order: x fastest, then y, then z
    hexes = np.stack(c, axis=1)

    if cell_type == CellType.hexahedron:
        cells = hexes
    elif cell_type == CellType.tetra:
        # Kuhn triangulation: 6 tets per hex, conforming across faces
        # (uses the main diagonal 0-7 of the tensor-ordered hex)
        idx = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
               (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)]
        cells = np.concatenate([hexes[:, list(t)] for t in idx], axis=0)
    else:
        raise ValueError(cell_type)

    return Mesh(
        x=pts,
        cells=cells.astype(INDEX_DTYPE),
        cell_type=cell_type,
        cell_tags=np.zeros(len(cells), dtype=INDEX_DTYPE),
    )
