"""Lagrange element tabulation: P1/P2 simplex, Q1/Q2 tensor cells.

The dof layout follows the dolfinx/basix convention used by the reference:
vertex dofs first (in cell-vertex order), then edge dofs (in cell-edge
order), so P1 dofmap == the cell array itself — the property the damage
construction relies on ("Lagrange1 scalar dof and nodes are linked
appropriately", FEniCSx/mechanic2d/asym_elasto_damage_model.cc:326).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable

import numpy as np

from tpufem_torch.mesh.mesh import CELL_EDGES, CELL_INFO, CellType


@dataclasses.dataclass(frozen=True)
class Element:
    """A scalar Lagrange element on a reference cell."""

    cell_type: str
    degree: int
    ndof: int
    # dof entity layout: list of (entity_dim, entity_local_index) per dof
    entity_dofs: tuple
    # callables (reference coords (n, dim)) -> (n, ndof) / (n, ndof, dim)
    _tab: Callable = dataclasses.field(repr=False, compare=False, default=None)
    _tab_grad: Callable = dataclasses.field(repr=False, compare=False, default=None)

    def tabulate(self, pts: np.ndarray) -> np.ndarray:
        """Shape functions at reference points: (npts, ndof)."""
        return self._tab(np.atleast_2d(pts))

    def tabulate_grad(self, pts: np.ndarray) -> np.ndarray:
        """Reference gradients at points: (npts, ndof, dim)."""
        return self._tab_grad(np.atleast_2d(pts))

    @property
    def dim(self) -> int:
        return CELL_INFO[self.cell_type]["dim"]


def _p1_simplex(cell_type: str) -> Element:
    dim = CELL_INFO[cell_type]["dim"]
    nv = dim + 1

    def tab(p):
        lam0 = 1.0 - p.sum(axis=1)
        return np.concatenate([lam0[:, None], p], axis=1)

    def tab_grad(p):
        g = np.zeros((len(p), nv, dim))
        g[:, 0, :] = -1.0
        for i in range(dim):
            g[:, 1 + i, i] = 1.0
        return g

    return Element(
        cell_type=cell_type,
        degree=1,
        ndof=nv,
        entity_dofs=tuple((0, i) for i in range(nv)),
        _tab=tab,
        _tab_grad=tab_grad,
    )


def _p2_triangle() -> Element:
    # dofs: 3 vertices then 3 edge midpoints, edge k opposite vertex k
    def bary(p):
        l0 = 1.0 - p[:, 0] - p[:, 1]
        return l0, p[:, 0], p[:, 1]

    def tab(p):
        l0, l1, l2 = bary(p)
        return np.stack(
            [
                l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                4 * l1 * l2, 4 * l0 * l2, 4 * l0 * l1,
            ],
            axis=1,
        )

    def tab_grad(p):
        l0, l1, l2 = bary(p)
        dl = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2)
        n = len(p)
        g = np.zeros((n, 6, 2))
        for i, li in enumerate((l0, l1, l2)):
            g[:, i, :] = (4 * li - 1)[:, None] * dl[i]
        # edge dofs 4*la*lb for (a,b) = (1,2),(0,2),(0,1)
        pairs = ((1, 2), (0, 2), (0, 1))
        ls = (l0, l1, l2)
        for k, (a, b) in enumerate(pairs):
            g[:, 3 + k, :] = 4 * (
                ls[a][:, None] * dl[b] + ls[b][:, None] * dl[a]
            )
        return g

    return Element(
        cell_type=CellType.triangle,
        degree=2,
        ndof=6,
        entity_dofs=tuple([(0, i) for i in range(3)] + [(1, i) for i in range(3)]),
        _tab=tab,
        _tab_grad=tab_grad,
    )


def _p2_tetra() -> Element:
    # dofs: 4 vertices then 6 edge midpoints in CELL_EDGES order
    edges = CELL_EDGES[CellType.tetra]

    def bary(p):
        l0 = 1.0 - p.sum(axis=1)
        return [l0, p[:, 0], p[:, 1], p[:, 2]]

    def tab(p):
        ls = bary(p)
        cols = [li * (2 * li - 1) for li in ls]
        cols += [4 * ls[a] * ls[b] for (a, b) in edges]
        return np.stack(cols, axis=1)

    def tab_grad(p):
        ls = bary(p)
        dl = np.array(
            [[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]]
        )
        n = len(p)
        g = np.zeros((n, 10, 3))
        for i in range(4):
            g[:, i, :] = (4 * ls[i] - 1)[:, None] * dl[i]
        for k, (a, b) in enumerate(edges):
            g[:, 4 + k, :] = 4 * (
                ls[a][:, None] * dl[b] + ls[b][:, None] * dl[a]
            )
        return g

    return Element(
        cell_type=CellType.tetra,
        degree=2,
        ndof=10,
        entity_dofs=tuple([(0, i) for i in range(4)] + [(1, i) for i in range(6)]),
        _tab=tab,
        _tab_grad=tab_grad,
    )


def _q1_tensor(cell_type: str) -> Element:
    dim = CELL_INFO[cell_type]["dim"]
    nv = 2**dim

    def tab(p):
        out = np.ones((len(p), nv))
        for d in range(dim):
            bit = (np.arange(nv) >> d) & 1  # tensor order: x fastest
            out *= np.where(bit[None, :] == 1, p[:, d : d + 1], 1 - p[:, d : d + 1])
        return out

    def tab_grad(p):
        n = len(p)
        # product over dims with the derivative taken on axis dd
        g = np.zeros((n, nv, dim))
        for dd in range(dim):
            prod = np.ones((n, nv))
            for d in range(dim):
                bit = (np.arange(nv) >> d) & 1
                if d == dd:
                    prod *= np.where(bit[None, :] == 1, 1.0, -1.0)
                else:
                    prod *= np.where(
                        bit[None, :] == 1, p[:, d : d + 1], 1 - p[:, d : d + 1]
                    )
            g[:, :, dd] = prod
        return g

    return Element(
        cell_type=cell_type,
        degree=1,
        ndof=nv,
        entity_dofs=tuple((0, i) for i in range(nv)),
        _tab=tab,
        _tab_grad=tab_grad,
    )


def _q2_quad() -> Element:
    """9-node biquadratic quad: 4 vertices + 4 edge midpoints + center.

    Edge dof order follows CELL_EDGES[quad] = ((0,1),(0,2),(1,3),(2,3))
    with tensor vertex order 0=(0,0) 1=(1,0) 2=(0,1) 3=(1,1).
    """

    def l1d(x):
        # quadratic 1D nodal basis at nodes {0, 1, 1/2}
        return (
            2.0 * (x - 0.5) * (x - 1.0),  # node 0
            2.0 * x * (x - 0.5),          # node 1
            4.0 * x * (1.0 - x),          # midpoint
        )

    def dl1d(x):
        return (4.0 * x - 3.0, 4.0 * x - 1.0, 4.0 - 8.0 * x)

    # dof -> (ix, iy) into the 1D basis triplet (0, 1, m=2)
    layout = [
        (0, 0), (1, 0), (0, 1), (1, 1),  # vertices
        (2, 0), (0, 2), (1, 2), (2, 1),  # edges (0,1),(0,2),(1,3),(2,3)
        (2, 2),  # center
    ]

    def tab(p):
        lx = np.stack(l1d(p[:, 0]), axis=1)  # (n, 3)
        ly = np.stack(l1d(p[:, 1]), axis=1)
        return np.stack([lx[:, i] * ly[:, j] for i, j in layout], axis=1)

    def tab_grad(p):
        lx = np.stack(l1d(p[:, 0]), axis=1)
        ly = np.stack(l1d(p[:, 1]), axis=1)
        dx = np.stack(dl1d(p[:, 0]), axis=1)
        dy = np.stack(dl1d(p[:, 1]), axis=1)
        g = np.zeros((len(p), 9, 2))
        for k, (i, j) in enumerate(layout):
            g[:, k, 0] = dx[:, i] * ly[:, j]
            g[:, k, 1] = lx[:, i] * dy[:, j]
        return g

    return Element(
        cell_type=CellType.quad,
        degree=2,
        ndof=9,
        entity_dofs=tuple(
            [(0, i) for i in range(4)] + [(1, i) for i in range(4)] + [(2, 0)]
        ),
        _tab=tab,
        _tab_grad=tab_grad,
    )


def _q2_hex() -> Element:
    """27-node triquadratic hexahedron: 8 vertices + 12 edge midpoints +
    6 face centers + 1 body center (MFEM/...cc:1104-1113's quadratic
    H1 collection analog in 3D). Edge order follows CELL_EDGES[hex],
    face order CELL_INFO[hex]['facets']."""

    def l1d(x):
        return (
            2.0 * (x - 0.5) * (x - 1.0),
            2.0 * x * (x - 0.5),
            4.0 * x * (1.0 - x),
        )

    def dl1d(x):
        return (4.0 * x - 3.0, 4.0 * x - 1.0, 4.0 - 8.0 * x)

    m = 2  # midpoint index into the 1D triplet
    layout = [
        # vertices, tensor order (x fastest, then y, then z)
        (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
        (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1),
        # edges, CELL_EDGES[hex] order:
        # (0,1) (2,3) (4,5) (6,7)  (0,2) (1,3) (4,6) (5,7)
        # (0,4) (1,5) (2,6) (3,7)
        (m, 0, 0), (m, 1, 0), (m, 0, 1), (m, 1, 1),
        (0, m, 0), (1, m, 0), (0, m, 1), (1, m, 1),
        (0, 0, m), (1, 0, m), (0, 1, m), (1, 1, m),
        # faces, CELL_INFO[hex]['facets'] order: z=0, z=1, y=0, y=1,
        # x=0, x=1
        (m, m, 0), (m, m, 1), (m, 0, m), (m, 1, m), (0, m, m), (1, m, m),
        # body center
        (m, m, m),
    ]

    def tab(p):
        lx = np.stack(l1d(p[:, 0]), axis=1)
        ly = np.stack(l1d(p[:, 1]), axis=1)
        lz = np.stack(l1d(p[:, 2]), axis=1)
        return np.stack(
            [lx[:, i] * ly[:, j] * lz[:, k] for i, j, k in layout], axis=1
        )

    def tab_grad(p):
        lx = np.stack(l1d(p[:, 0]), axis=1)
        ly = np.stack(l1d(p[:, 1]), axis=1)
        lz = np.stack(l1d(p[:, 2]), axis=1)
        dx = np.stack(dl1d(p[:, 0]), axis=1)
        dy = np.stack(dl1d(p[:, 1]), axis=1)
        dz = np.stack(dl1d(p[:, 2]), axis=1)
        g = np.zeros((len(p), 27, 3))
        for n, (i, j, k) in enumerate(layout):
            g[:, n, 0] = dx[:, i] * ly[:, j] * lz[:, k]
            g[:, n, 1] = lx[:, i] * dy[:, j] * lz[:, k]
            g[:, n, 2] = lx[:, i] * ly[:, j] * dz[:, k]
        return g

    return Element(
        cell_type=CellType.hexahedron,
        degree=2,
        ndof=27,
        entity_dofs=tuple(
            [(0, i) for i in range(8)]
            + [(1, i) for i in range(12)]
            + [(2, i) for i in range(6)]
            + [(3, 0)]
        ),
        _tab=tab,
        _tab_grad=tab_grad,
    )


@lru_cache(maxsize=None)
def element(cell_type: str, degree: int) -> Element:
    """Factory: Lagrange element of given degree on cell_type."""
    if cell_type in (CellType.triangle, CellType.tetra, CellType.interval):
        if degree == 1:
            return _p1_simplex(cell_type)
        if degree == 2 and cell_type == CellType.triangle:
            return _p2_triangle()
        if degree == 2 and cell_type == CellType.tetra:
            return _p2_tetra()
    if cell_type in (CellType.quad, CellType.hexahedron):
        if degree == 1:
            return _q1_tensor(cell_type)
        if degree == 2 and cell_type == CellType.quad:
            return _q2_quad()
        if degree == 2 and cell_type == CellType.hexahedron:
            return _q2_hex()
    if degree == 0:
        # DG0: single dof at centroid (used for strain/stress output,
        # FEniCSx/...cc:918-923 creates a discontinuous degree-0 space)
        dim = CELL_INFO[cell_type]["dim"]

        def tab(p):
            return np.ones((len(p), 1))

        def tab_grad(p):
            return np.zeros((len(p), 1, dim))

        return Element(
            cell_type=cell_type, degree=0, ndof=1,
            entity_dofs=((dim, 0),), _tab=tab, _tab_grad=tab_grad,
        )
    raise NotImplementedError(f"{cell_type} degree {degree}")
