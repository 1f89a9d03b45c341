"""Uniform and local (marked-cell) refinement with tag transfer.

Equivalent of dolfinx ``refinement::plaza::refine`` + cell/facet meshtag
transfer (FEniCSx/mechanic2d/asym_elasto_damage_model.cc:166-186) and
mfem ``ParMesh::UniformRefinement`` (MFEM/...cc:1038). The reference
workload only applies the uniform (all-red) case (MAX_REFINE
applications); :func:`refine_marked` covers the local-refinement half of
the plaza contract — conforming simplex refinement of a marked cell
subset by globally-ordered longest-edge bisection (Rivara/plaza family).
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.config import INDEX_DTYPE
from tpufem_torch.mesh.mesh import CellType, Mesh, MeshTags
from tpufem_torch.mesh.topology import build_entities


def _midpoint_nodes(mesh: Mesh):
    """New node per unique edge; returns (new_x, edge_to_newnode)."""
    edges, c2e = build_entities(mesh, 1)
    mid = 0.5 * (mesh.x[edges[:, 0]] + mesh.x[edges[:, 1]])
    new_x = np.concatenate([mesh.x, mid], axis=0)
    edge_to_new = (mesh.n_nodes + np.arange(edges.shape[0])).astype(INDEX_DTYPE)
    return new_x, edges, c2e, edge_to_new


def refine_uniform(mesh: Mesh) -> Mesh:
    """One level of uniform refinement. Cell tags propagate to children;
    tagged edges (entity_tags[1]) are split into two tagged children —
    the meshtag transfer of FEniCSx/...cc:171-176."""
    if mesh.cell_type == CellType.triangle:
        return _refine_triangle(mesh)
    if mesh.cell_type == CellType.quad:
        return _refine_quad(mesh)
    if mesh.cell_type == CellType.tetra:
        return _refine_tetra(mesh)
    if mesh.cell_type == CellType.hexahedron:
        return _refine_hex(mesh)
    raise NotImplementedError(mesh.cell_type)


def _transfer_edge_tags(mesh: Mesh, new_mesh: Mesh, edges, edge_to_new):
    """Tagged edge (a,b) → children (a,m) and (m,b)."""
    if 1 not in mesh.entity_tags:
        return
    tags = mesh.entity_tags[1]
    # find each tagged edge in the unique edge table
    from tpufem_torch.mesh.topology import match_tagged_entities

    idx = match_tagged_entities(mesh, 1)
    valid = idx >= 0
    idx = idx[valid]
    vals = tags.values[valid]
    a = edges[idx, 0]
    b = edges[idx, 1]
    m = edge_to_new[idx]
    child = np.concatenate(
        [np.stack([a, m], axis=1), np.stack([m, b], axis=1)], axis=0
    )
    child = np.sort(child, axis=1).astype(INDEX_DTYPE)
    new_mesh.entity_tags[1] = MeshTags(
        dim=1, entities=child, values=np.concatenate([vals, vals])
    )


def _refine_triangle(mesh: Mesh) -> Mesh:
    new_x, edges, c2e, edge_to_new = _midpoint_nodes(mesh)
    v = mesh.cells  # (nc, 3)
    # midpoint of local edge k (opposite vertex k)
    m = edge_to_new[c2e]  # (nc, 3): m0 on (1,2), m1 on (0,2), m2 on (0,1)
    children = [
        np.stack([v[:, 0], m[:, 2], m[:, 1]], axis=1),
        np.stack([v[:, 1], m[:, 0], m[:, 2]], axis=1),
        np.stack([v[:, 2], m[:, 1], m[:, 0]], axis=1),
        np.stack([m[:, 0], m[:, 1], m[:, 2]], axis=1),
    ]
    cells = np.concatenate(children, axis=0).astype(INDEX_DTYPE)
    tags = (
        np.tile(mesh.cell_tags, 4) if mesh.cell_tags is not None else None
    )
    out = Mesh(x=new_x, cells=cells, cell_type=CellType.triangle, cell_tags=tags)
    _transfer_edge_tags(mesh, out, edges, edge_to_new)
    return out


def _refine_quad(mesh: Mesh) -> Mesh:
    new_x, edges, c2e, edge_to_new = _midpoint_nodes(mesh)
    v = mesh.cells  # tensor order: 0=(0,0) 1=(1,0) 2=(0,1) 3=(1,1)
    m = edge_to_new[c2e]  # local edges (0,1),(0,2),(1,3),(2,3)
    center = new_x[v].mean(axis=1)
    cidx = (len(new_x) + np.arange(mesh.n_cells)).astype(INDEX_DTYPE)
    new_x = np.concatenate([new_x, center], axis=0)
    e01, e02, e13, e23 = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    children = [
        np.stack([v[:, 0], e01, e02, cidx], axis=1),
        np.stack([e01, v[:, 1], cidx, e13], axis=1),
        np.stack([e02, cidx, v[:, 2], e23], axis=1),
        np.stack([cidx, e13, e23, v[:, 3]], axis=1),
    ]
    cells = np.concatenate(children, axis=0).astype(INDEX_DTYPE)
    tags = np.tile(mesh.cell_tags, 4) if mesh.cell_tags is not None else None
    out = Mesh(x=new_x, cells=cells, cell_type=CellType.quad, cell_tags=tags)
    _transfer_edge_tags(mesh, out, edges, edge_to_new)
    return out


def _refine_tetra(mesh: Mesh) -> Mesh:
    """Bey's red (1:8) tetra refinement: 4 corner tets + the interior
    octahedron cut into 4 tets along the m02-m13 diagonal (Bey 1995,
    the scheme MFEM's hex/tet UniformRefinement and dolfinx's uniform
    plaza path reduce to for the all-red case)."""
    new_x, edges, c2e, edge_to_new = _midpoint_nodes(mesh)
    v = mesh.cells  # (nc, 4)
    m = edge_to_new[c2e]  # (nc, 6) in CELL_EDGES[tetra] order:
    # e0=(2,3) e1=(1,3) e2=(1,2) e3=(0,3) e4=(0,2) e5=(0,1)
    m23, m13, m12, m03, m02, m01 = (m[:, k] for k in range(6))
    children = [
        # corner tets
        np.stack([v[:, 0], m01, m02, m03], axis=1),
        np.stack([m01, v[:, 1], m12, m13], axis=1),
        np.stack([m02, m12, v[:, 2], m23], axis=1),
        np.stack([m03, m13, m23, v[:, 3]], axis=1),
        # octahedron, diagonal m02-m13
        np.stack([m01, m02, m03, m13], axis=1),
        np.stack([m01, m02, m12, m13], axis=1),
        np.stack([m02, m03, m13, m23], axis=1),
        np.stack([m02, m12, m13, m23], axis=1),
    ]
    cells = np.concatenate(children, axis=0).astype(INDEX_DTYPE)
    tags = np.tile(mesh.cell_tags, 8) if mesh.cell_tags is not None else None
    out = Mesh(x=new_x, cells=cells, cell_type=CellType.tetra, cell_tags=tags)
    _transfer_edge_tags(mesh, out, edges, edge_to_new)
    return out


def _refine_hex(mesh: Mesh) -> Mesh:
    """Uniform hex refinement via 2×2×2 trilinear subdivision per cell
    (face/center nodes deduplicated by coordinate hashing)."""
    v = mesh.cells
    x = mesh.x
    # 27 lattice points per cell in tensor order
    corners = x[v]  # (nc, 8, 3) tensor-ordered
    nc = mesh.n_cells
    grid = np.array(
        [[i, j, k] for k in (0, 1, 2) for j in (0, 1, 2) for i in (0, 1, 2)],
        dtype=np.float64,
    ) / 2.0  # (27, 3) in reference coords
    # trilinear basis at the 27 points for the 8 tensor-ordered corners
    gx, gy, gz = grid[:, 0], grid[:, 1], grid[:, 2]
    basis = np.stack(
        [
            (1 - gx) * (1 - gy) * (1 - gz), gx * (1 - gy) * (1 - gz),
            (1 - gx) * gy * (1 - gz), gx * gy * (1 - gz),
            (1 - gx) * (1 - gy) * gz, gx * (1 - gy) * gz,
            (1 - gx) * gy * gz, gx * gy * gz,
        ],
        axis=1,
    )  # (27, 8)
    pts = np.einsum("qv,cvd->cqd", basis, corners).reshape(-1, 3)
    # dedupe points (quantized) to get conforming mesh
    key = np.round(pts / (1e-12 + np.abs(pts).max()) * 1e12).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    new_x = pts[first]
    node_of = inv.reshape(nc, 27)

    def lid(i, j, k):
        return (k * 3 + j) * 3 + i

    children = []
    for dk in (0, 1):
        for dj in (0, 1):
            for di in (0, 1):
                ids = [lid(di + a, dj + b, dk + c)
                       for c in (0, 1) for b in (0, 1) for a in (0, 1)]
                children.append(node_of[:, ids])
    cells = np.concatenate(children, axis=0).astype(INDEX_DTYPE)
    tags = np.tile(mesh.cell_tags, 8) if mesh.cell_tags is not None else None
    return Mesh(x=new_x, cells=cells, cell_type=CellType.hexahedron,
                cell_tags=tags)


# ---------------------------------------------------------------------------
# local refinement (plaza-style): conforming marked-cell refinement of
# simplex meshes by longest-edge bisection in a single GLOBAL edge order
# ---------------------------------------------------------------------------


def _subdivide_template(nv: int, seq):
    """Recursive bisection of the reference simplex, symbolically.

    ``seq`` is the cell-local edge indices to split, already in global
    split order. Symbols 0..nv-1 are the original local vertices; nv+e
    is the midpoint of local edge e. In a simplex any vertex pair is an
    edge, so a marked original edge (a, b) is present in a sub-simplex
    iff both a and b still are; bisection replaces b (resp. a) by the
    midpoint, halving the volume with the parent's orientation sign.
    """
    from tpufem_torch.mesh.mesh import CELL_EDGES, CellType

    local_edges = CELL_EDGES[
        CellType.triangle if nv == 3 else CellType.tetra
    ]
    sims = [tuple(range(nv))]
    for e in seq:
        a, b = local_edges[e]
        mid = nv + e
        out = []
        for s in sims:
            if a in s and b in s:
                out.append(tuple(mid if v == b else v for v in s))
                out.append(tuple(mid if v == a else v for v in s))
            else:
                out.append(s)
        sims = out
    return sims


def refine_marked(mesh: Mesh, marked_cells) -> Mesh:
    """Conforming local refinement of the cells in ``marked_cells``
    (bool mask or index array) for triangle/tetra meshes — the local
    half of dolfinx ``refinement::plaza::refine`` (FEniCSx/...cc:166-186).

    Every edge of a marked cell is split (marked triangles become 4
    children, marked tets 8, like one uniform level); unmarked cells
    are bisected as needed to stay conforming. Closure marks the
    *refinement edge* (globally longest, ties by edge id) of any cell
    with a split edge, so repeated application keeps element quality
    bounded (Rivara). All cells bisect their split edges in one global
    edge order, which makes the induced triangulation of every shared
    face identical from both sides — conformity needs no communication
    beyond the shared order, exactly the property that lets this run
    per-partition on distributed shards.

    Cell tags propagate to children; tagged edges (entity_tags[1])
    split into two tagged children when their edge is split and are
    kept verbatim otherwise.
    """
    if mesh.cell_type not in (CellType.triangle, CellType.tetra):
        raise NotImplementedError(
            f"refine_marked supports simplex meshes, got {mesh.cell_type}"
        )
    marked_cells = np.asarray(marked_cells)
    if marked_cells.dtype != np.bool_:
        m = np.zeros(mesh.n_cells, dtype=bool)
        m[marked_cells] = True
        marked_cells = m
    if not marked_cells.any():
        return mesh

    edges, c2e = build_entities(mesh, 1)
    ne = edges.shape[0]
    elen = np.linalg.norm(mesh.x[edges[:, 1]] - mesh.x[edges[:, 0]], axis=1)
    # one global split order: longest first, ties by edge id (shared by
    # all cells, so shared faces subdivide identically from both sides)
    order = np.lexsort((np.arange(ne), -elen))
    rank = np.empty(ne, dtype=np.int64)
    rank[order] = np.arange(ne)

    split = np.zeros(ne, dtype=bool)
    split[np.unique(c2e[marked_cells].ravel())] = True

    # closure: any cell with a split edge must split its refinement
    # edge (cell-local rank minimum). Marks only grow -> terminates.
    cell_rank = rank[c2e]  # (nc, n_local_edges)
    ref_edge = c2e[np.arange(mesh.n_cells), np.argmin(cell_rank, axis=1)]
    while True:
        need = split[c2e].any(axis=1) & ~split[ref_edge]
        if not need.any():
            break
        split[ref_edge[need]] = True

    # midpoint nodes for split edges
    edge_to_new = np.full(ne, -1, dtype=np.int64)
    sidx = np.flatnonzero(split)
    edge_to_new[sidx] = mesh.n_nodes + np.arange(len(sidx))
    new_x = np.concatenate(
        [mesh.x, 0.5 * (mesh.x[edges[sidx, 0]] + mesh.x[edges[sidx, 1]])],
        axis=0,
    )

    # group cells by their split signature: the cell-local edge indices
    # of split edges, in global order
    nv = mesh.cells.shape[1]
    nle = c2e.shape[1]
    smask = split[c2e]  # (nc, nle)
    loc_sorted = np.argsort(cell_rank, axis=1)  # local edges, global order
    smask_sorted = np.take_along_axis(smask, loc_sorted, axis=1)
    # signature id: local-edge sequence padded with nle (=no-op)
    seq = np.where(smask_sorted, loc_sorted, nle)
    # stable-compact the no-ops to the right
    seq = np.take_along_axis(
        seq, np.argsort(seq == nle, kind="stable", axis=1), axis=1
    )
    sig = seq @ (np.int64(nle + 1) ** np.arange(nle)[::-1])
    uniq, inv = np.unique(sig, return_inverse=True)

    children_cells = []
    children_parent = []
    for g, s in enumerate(uniq):
        cs = np.flatnonzero(inv == g)
        gseq = [int(v) for v in seq[cs[0]] if v < nle]
        tmpl = _subdivide_template(nv, gseq)
        # symbol -> global node: vertices then midpoints
        verts = mesh.cells[cs]  # (k, nv)
        mids = edge_to_new[c2e[cs]]  # (k, nle)
        table = np.concatenate([verts, mids], axis=1)  # (k, nv+nle)
        for child in tmpl:
            children_cells.append(table[:, list(child)])
            children_parent.append(cs)
    cells = np.concatenate(children_cells, axis=0).astype(INDEX_DTYPE)
    parent = np.concatenate(children_parent, axis=0)
    tags = (
        np.asarray(mesh.cell_tags)[parent]
        if mesh.cell_tags is not None
        else None
    )
    out = Mesh(x=new_x, cells=cells, cell_type=mesh.cell_type,
               cell_tags=tags)

    # edge-tag transfer: split tagged edges -> two tagged children;
    # unsplit tagged edges persist verbatim
    if 1 in mesh.entity_tags:
        from tpufem_torch.mesh.topology import match_tagged_entities

        etags = mesh.entity_tags[1]
        idx = match_tagged_entities(mesh, 1)
        valid = idx >= 0
        idx = idx[valid]
        vals = etags.values[valid]
        is_split = split[idx]
        a, b = edges[idx, 0], edges[idx, 1]
        m = edge_to_new[idx]
        kept = np.stack([a[~is_split], b[~is_split]], axis=1)
        ch1 = np.stack([a[is_split], m[is_split]], axis=1)
        ch2 = np.stack([m[is_split], b[is_split]], axis=1)
        ents = np.sort(
            np.concatenate([kept, ch1, ch2], axis=0), axis=1
        ).astype(INDEX_DTYPE)
        out.entity_tags[1] = MeshTags(
            dim=1,
            entities=ents,
            values=np.concatenate(
                [vals[~is_split], vals[is_split], vals[is_split]]
            ),
        )
    return out
