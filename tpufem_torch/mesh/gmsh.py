"""gmsh 2.2 ASCII reader producing a Mesh with cell/facet tags (pure
NumPy, a copy of ``tpufem.mesh.gmsh``).

Equivalent of the reference mesh-ingest path: the reference
converts Neper gmsh 2.2 files to XDMF with ``gmsh_to_xdmf_neper_dam.py``
(dolfinx gmshio) then reads them with ``XDMFFile::read_mesh/read_meshtags``
(FEniCSx/mechanic2d/asym_elasto_damage_model.cc:152-164); MFEM reads the
gmsh file directly (MFEM/...cc:1020). We read the gmsh file directly on
host into SoA NumPy arrays. The bundled debug mesh
``common/data/square.msh`` (62 nodes, gmsh 2.2) exercises every section
this reader supports.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from tpufem_torch.config import INDEX_DTYPE
from tpufem_torch.mesh.mesh import CellType, Mesh, MeshTags

# gmsh element type id -> (cell type, n nodes)
_GMSH_TYPES = {
    15: (CellType.point, 1),
    1: (CellType.interval, 2),
    2: (CellType.triangle, 3),
    3: (CellType.quad, 4),
    4: (CellType.tetra, 4),
    5: (CellType.hexahedron, 8),
}

# gmsh hexahedron vertex order -> tensor order (x fastest)
_HEX_PERM = np.array([0, 1, 3, 2, 4, 5, 7, 6], dtype=np.int64)
# gmsh quad (ccw loop) -> tensor order
_QUAD_PERM = np.array([0, 1, 3, 2], dtype=np.int64)


def read_gmsh(path: str) -> Mesh:
    """Read a gmsh 2.2 ASCII file.

    The highest-dimensional element block becomes the cells (with the
    first tag — the physical tag — as ``cell_tags``); lower-dimensional
    tagged elements become ``entity_tags`` per dimension, matching the
    cell/facet MeshTags pair the reference reads (FEniCSx/...cc:159-162).
    """
    with open(path) as fh:
        lines = fh.read().splitlines()

    i = 0
    n = len(lines)
    nodes = None
    node_ids = None
    elems_by_type: Dict[str, List[List[int]]] = {}
    tags_by_type: Dict[str, List[int]] = {}

    while i < n:
        line = lines[i].strip()
        if line == "$MeshFormat":
            version = lines[i + 1].split()[0]
            if not version.startswith("2."):
                raise ValueError(f"only gmsh 2.x ASCII supported, got {version}")
            i += 3
        elif line == "$Nodes":
            count = int(lines[i + 1])
            # vectorized parse (1M+-node meshes; the per-line loop costs
            # ~30 s there): one big split + reshape
            blob = " ".join(lines[i + 2 : i + 2 + count])
            arr = np.array(blob.split(), dtype=np.float64).reshape(count, 4)
            node_ids = arr[:, 0].astype(np.int64)
            nodes = arr[:, 1:4]
            i += 2 + count + 1
        elif line == "$Elements":
            count = int(lines[i + 1])
            data = lines[i + 2 : i + 2 + count]
            # vectorized parse: group lines by token count, then one C
            # split+reshape per group (mixed element types handled by a
            # per-type sub-select; ntags is uniform per type in practice)
            from collections import defaultdict

            widths = defaultdict(list)
            for s in data:
                widths[len(s.split())].append(s)
            for w1, grp in widths.items():
                arr = np.array(" ".join(grp).split(), dtype=np.int64)
                arr = arr.reshape(len(grp), w1)
                for et in np.unique(arr[:, 1]):
                    if int(et) not in _GMSH_TYPES:
                        continue
                    rows = arr[arr[:, 1] == et]
                    ctype, nv = _GMSH_TYPES[int(et)]
                    ntags = int(rows[0, 2])
                    phys = (
                        rows[:, 3] if ntags >= 1
                        else np.zeros(len(rows), dtype=np.int64)
                    )
                    verts = rows[:, 3 + ntags : 3 + ntags + nv]
                    elems_by_type.setdefault(ctype, []).extend(
                        verts.tolist()
                    )
                    tags_by_type.setdefault(ctype, []).extend(phys.tolist())
            i += 2 + count + 1
        else:
            i += 1

    if nodes is None or not elems_by_type:
        raise ValueError(f"no nodes/elements found in {path}")

    # gmsh node ids are 1-based but may be non-contiguous: build id->index
    id_to_idx = np.full(int(node_ids.max()) + 1, -1, dtype=np.int64)
    id_to_idx[node_ids] = np.arange(len(node_ids))

    # pick the highest-dimensional block as cells
    from tpufem_torch.mesh.mesh import CELL_INFO

    cell_type = max(elems_by_type, key=lambda t: CELL_INFO[t]["dim"])
    tdim = CELL_INFO[cell_type]["dim"]

    def to_array(ctype: str) -> np.ndarray:
        arr = np.asarray(elems_by_type[ctype], dtype=np.int64)
        arr = id_to_idx[arr]
        if ctype == CellType.hexahedron:
            arr = arr[:, _HEX_PERM]
        elif ctype == CellType.quad:
            arr = arr[:, _QUAD_PERM]
        return arr.astype(INDEX_DTYPE)

    cells = to_array(cell_type)
    cell_tags = np.asarray(tags_by_type[cell_type], dtype=INDEX_DTYPE)

    # geometric dim: drop trailing zero coordinate axes for 1D/2D meshes
    gdim = 3
    if tdim < 3 and np.allclose(nodes[:, 2], 0.0):
        gdim = 2
    x = np.ascontiguousarray(nodes[:, :gdim])

    mesh = Mesh(x=x, cells=cells, cell_type=cell_type, cell_tags=cell_tags)

    for ctype, rows in elems_by_type.items():
        dim = CELL_INFO[ctype]["dim"]
        if ctype == cell_type or dim >= tdim:
            continue
        ents = to_array(ctype)
        if dim > 0:
            ents = np.sort(ents, axis=1)  # canonical vertex order for matching
        mesh.entity_tags[dim] = MeshTags(
            dim=dim,
            entities=ents,
            values=np.asarray(tags_by_type[ctype], dtype=INDEX_DTYPE),
        )
    return mesh


_CELL_TO_GMSH = {
    CellType.interval: 1,
    CellType.triangle: 2,
    CellType.quad: 3,
    CellType.tetra: 4,
    CellType.hexahedron: 5,
}


def write_gmsh(path: str, mesh: Mesh) -> None:
    """Write a gmsh 2.2 ASCII file (cells + cell tags + tagged entities).

    The inverse of :func:`read_gmsh` — lets generated meshes (e.g. the
    synthetic polycrystal, tpufem_torch.cases.polycrystal) exercise the same
    ingest path the reference's Neper meshes take. Coordinates are written
    with 17 significant digits, so the round trip is exact (the
    reference's writer keeps 16, which moves a coordinate by up to an
    ulp), and tagged points as gmsh points (type 15)."""
    x = np.asarray(mesh.x, dtype=np.float64)
    if x.shape[1] < 3:
        x = np.concatenate(
            [x, np.zeros((len(x), 3 - x.shape[1]))], axis=1
        )
    out = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(len(x))]
    ids = np.arange(1, len(x) + 1)
    node_block = np.concatenate([ids[:, None].astype(np.float64), x], axis=1)
    out.append(
        "\n".join(
            f"{int(r[0])} {r[1]:.17g} {r[2]:.17g} {r[3]:.17g}"
            for r in node_block
        )
    )
    out += ["$EndNodes", "$Elements"]

    blocks = []
    eid = 1
    # lower-dim tagged entities first (gmsh convention)
    for dim in sorted(mesh.entity_tags):
        tags = mesh.entity_tags[dim]
        # points as gmsh type 15: the reference's writer has no type for
        # dim 0 and raises KeyError on square.msh's tagged points
        et = {0: 15, 1: 1, 2: 2}[dim] if dim <= 2 else None
        for ent, val in zip(np.asarray(tags.entities), np.asarray(tags.values)):
            verts = " ".join(str(v + 1) for v in ent)
            blocks.append(f"{eid} {et} 2 {val} {val} {verts}")
            eid += 1
    gtype = _CELL_TO_GMSH[mesh.cell_type]
    cells = np.asarray(mesh.cells)
    if mesh.cell_type == CellType.hexahedron:
        cells = cells[:, _HEX_PERM]
    elif mesh.cell_type == CellType.quad:
        cells = cells[:, _QUAD_PERM]
    ct = (
        np.asarray(mesh.cell_tags)
        if mesh.cell_tags is not None
        else np.zeros(len(cells), dtype=np.int64)
    )
    hdr = np.stack(
        [
            np.arange(eid, eid + len(cells)),
            np.full(len(cells), gtype),
            np.full(len(cells), 2),
            ct,
            ct,
        ],
        axis=1,
    )
    body = np.concatenate([hdr, cells + 1], axis=1)
    blocks.append("\n".join(" ".join(map(str, r)) for r in body))
    out.append(str(eid - 1 + len(cells)))
    out.append("\n".join(blocks))
    out += ["$EndElements", ""]
    with open(path, "w") as fh:
        fh.write("\n".join(out))
