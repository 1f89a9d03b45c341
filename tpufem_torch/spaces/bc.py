"""Dirichlet boundary conditions: dof location + BC container.

Mirrors the reference's BC pipeline (FEniCSx/mechanic2d/
asym_elasto_damage_model.cc:620-669): ``locate_entities_boundary`` with a
coordinate predicate → ``locate_dofs_topological`` → ``DirichletBC``; and
MFEM's attribute-driven ``GetEssentialTrueDofs`` (MFEM/...cc:1338-1415).
Application semantics (identity-row "method 3", doc.tex:1670-1741) live
in tpufem.assemble.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np

from tpufem_torch.config import INDEX_DTYPE
from tpufem_torch.mesh.topology import build_entities, locate_entities_boundary
from tpufem_torch.spaces.space import FunctionSpace


def locate_dofs_geometrical(
    space: FunctionSpace, marker: Callable[[np.ndarray], np.ndarray]
) -> np.ndarray:
    """Scalar (node-level) dofs whose coordinates satisfy marker."""
    mask = np.asarray(marker(space.dof_coords), dtype=bool)
    return np.nonzero(mask)[0].astype(INDEX_DTYPE)


def locate_dofs_topological(
    space: FunctionSpace, dim: int, entities: np.ndarray
) -> np.ndarray:
    """Scalar dofs attached to the given mesh entities (vertices of the
    entities, plus edge dofs for P2 when dim>=1).

    Equivalent of ``dolfinx::fem::locate_dofs_topological``
    (FEniCSx/...cc:637-638).
    """
    mesh = space.mesh
    ents, _ = build_entities(mesh, dim)
    sel = ents[np.asarray(entities, dtype=np.int64)]
    dofs = set(np.unique(sel).tolist())
    if space.element.degree >= 2 and dim >= 1:
        # add edge dofs lying on the entities: for dim==1 the entities are
        # edges; match them into the edge table
        edges, _ = build_entities(mesh, 1)
        if dim == 1:
            edge_ids = np.asarray(entities, dtype=np.int64)
        else:
            # facets of dim 2 (P2 tet faces): collect edges whose both
            # vertices lie on tagged facets
            vset = np.zeros(mesh.n_nodes, dtype=bool)
            vset[np.unique(sel)] = True
            edge_ids = np.nonzero(vset[edges].all(axis=1))[0]
        dofs |= set((mesh.n_nodes + edge_ids).tolist())
    return np.array(sorted(dofs), dtype=INDEX_DTYPE)


@dataclasses.dataclass
class DirichletBC:
    """Constrain (a subset of components of) scalar dofs to given values.

    ``dofs``: node-level dof indices. ``value``: scalar/vector constant or
    per-dof array. ``components``: which vector components are constrained
    (default: all). Expanded flat (byVDIM) indices via ``flat_dofs()``.
    """

    space: FunctionSpace
    dofs: np.ndarray
    value: Union[float, Sequence[float], np.ndarray]
    components: Optional[Sequence[int]] = None

    def flat_dofs(self) -> np.ndarray:
        bs = self.space.bs
        comps = (
            np.arange(bs)
            if self.components is None
            else np.asarray(self.components, dtype=np.int64)
        )
        flat = (self.dofs[:, None] * bs + comps[None, :]).reshape(-1)
        return flat.astype(INDEX_DTYPE)

    def flat_values(self) -> np.ndarray:
        bs = self.space.bs
        comps = (
            np.arange(bs)
            if self.components is None
            else np.asarray(self.components, dtype=np.int64)
        )
        v = np.asarray(self.value, dtype=np.float64)
        n = len(self.dofs)
        if v.ndim == 0:
            vals = np.full((n, len(comps)), float(v))
        elif v.ndim == 1 and v.shape[0] == bs:
            vals = np.broadcast_to(v[comps], (n, len(comps)))
        elif v.ndim == 1 and v.shape[0] == len(comps):
            vals = np.broadcast_to(v, (n, len(comps)))
        elif v.ndim == 2:
            vals = v[:, comps]
        else:
            raise ValueError(f"bad bc value shape {v.shape}")
        return np.ascontiguousarray(vals).reshape(-1)


def combine_bcs(bcs: Sequence[DirichletBC], n_dofs: int):
    """Merge BC list into (sorted flat dof array, value array, bool mask).

    Later BCs win on overlap (matching dolfinx's set_bc application
    order).
    """
    vals = np.zeros(n_dofs, dtype=np.float64)
    mask = np.zeros(n_dofs, dtype=bool)
    for bc in bcs:
        fd = bc.flat_dofs()
        fv = bc.flat_values()
        vals[fd] = fv
        mask[fd] = True
    dofs = np.nonzero(mask)[0].astype(INDEX_DTYPE)
    return dofs, vals[dofs], mask
