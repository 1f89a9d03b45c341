"""Damage field construction + neighbor smoothing.

Reimplements the reference's one custom distributed algorithm
(doc.tex:601-642; C++ loops at FEniCSx/mechanic2d/
asym_elasto_damage_model.cc:315-473; MFEM table walk MFEM/...cc:
1155-1315; SciPy CSR form asym_elasto_damage_model_symb_sym.py:160-199):

1. nodes of ~30 tagged grain-boundary edges get d = MAX_DAM;
2. for 8*(MAX_REFINE+1) iterations, two half-steps each:
   - *enlarge*: nodes with d < 0.01 receive the edge-neighbor average,
     d <- max(avg, d);
   - *smooth+enlarge*: all nodes receive the neighbor average,
     d <- max(avg, d).

The per-edge gather/sum is a padded ELL adjacency product (dense gathers
added column by column), the owner-side ``max(avg, old)`` is elementwise;
the device loop and its host twin add in the same left-to-right order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpufem_torch.config import DEFAULT_DTYPE, INDEX_DTYPE, resolve_device
from tpufem_torch.mesh.mesh import Mesh
from tpufem_torch.mesh.topology import build_entities


def node_adjacency_ell(mesh: Mesh):
    """Padded neighbor table via edges: (neighbors (n, k), mask (n, k),
    inv_degree (n,)). Neighbor j of node i <=> edge (i,j) exists.

    Padding entries point at the sentinel slot ``n`` (gather from a
    zero-extended vector instead of a mask multiply); ``mask`` is kept
    in the return for API stability but is None."""
    edges, _ = build_entities(mesh, 1)
    n = mesh.n_nodes
    # undirected: both directions; int32 throughout
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(
        np.int32, copy=False
    )
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(
        np.int32, copy=False
    )
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n)
    k = int(deg.max()) if n else 0
    start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=start[1:])
    neighbors = np.full((n, k), n, dtype=INDEX_DTYPE)  # pad -> slot n
    within = np.arange(len(src), dtype=np.int64)
    within -= start[src]
    neighbors[src, within] = dst
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    return neighbors, None, inv_deg


def initial_damage(
    mesh: Mesh, damaged_edge_tags: Sequence[int], max_dam: float
) -> np.ndarray:
    """d = max_dam on every node of the tagged boundary edges
    (FEniCSx/...cc:354-397). Tag list for the Neper mesh at :359-361
    (30 tags, 333 duplicated -- preserved as-is); square.msh uses {4}
    (:356)."""
    d = np.zeros(mesh.n_nodes)
    if 1 not in mesh.entity_tags:
        return d
    tags = mesh.entity_tags[1]
    for tag in damaged_edge_tags:
        rows = tags.find(int(tag))
        nodes = np.unique(tags.entities[rows].ravel())
        d[nodes] = max_dam
    return d


def _smooth_loop(d, nb, w, iterations):
    """Device loop: ``nb`` (n, k) int64 neighbor table (pad -> slot n),
    ``w`` (n,) inverse degrees."""
    zero = torch.zeros((), dtype=d.dtype, device=d.device)

    def neighbor_avg(dv):
        # padding entries of nb point at the appended zero slot
        ext = torch.cat([dv, dv.new_zeros(1)])
        s = ext[nb[:, 0]]
        for j in range(1, nb.shape[1]):
            s = s + ext[nb[:, j]]
        return s * w

    for _ in range(iterations):
        # half 1: enlarge -- only currently-undamaged nodes updated
        avg = neighbor_avg(d)
        d = torch.maximum(torch.where(d < 0.01, avg, zero), d)
        # half 2: smooth + enlarge everywhere
        d = torch.maximum(neighbor_avg(d), d)
    return d


def _smooth_host(d, neighbors, inv_deg, iterations):
    """NumPy twin of :func:`_smooth_loop` (same two half-steps, same
    sentinel-padded gather, same left-to-right accumulation). Hot
    sections run in native C++ when the library builds."""
    from tpufem_torch import native

    nd = native.damage_smooth(neighbors, inv_deg, d, iterations)
    if nd is not None:
        return nd
    d = np.asarray(d, dtype=np.float64).copy()
    ext = np.zeros(len(d) + 1)

    def neighbor_avg():
        ext[:-1] = d
        g = ext[neighbors]
        s = g[:, 0].copy()
        for j in range(1, g.shape[1]):
            s += g[:, j]
        return s * inv_deg

    for _ in range(iterations):
        avg = neighbor_avg()
        np.maximum(np.where(d < 0.01, avg, 0.0), d, out=d)
        avg = neighbor_avg()
        np.maximum(avg, d, out=d)
    return d


def smooth_damage(
    mesh: Mesh, d0: np.ndarray, *, iterations: int, dtype=None,
    backend: str = "device", device=None,
):
    """Run the two-half-step smoothing loop; returns final d.

    ``backend``: 'device' (the loop on ``device``, default CUDA, in
    ``dtype``, default float32; returns a tensor) or 'host' (NumPy/C++
    twin in float64; returns a NumPy array)."""
    neighbors, _, inv_deg = node_adjacency_ell(mesh)
    if backend == "host":
        d0h = np.asarray(d0)
        out = _smooth_host(d0h, neighbors, inv_deg, iterations)
        return out.astype(d0h.dtype)
    if backend != "device":
        raise ValueError(f"backend {backend!r}")
    dev = resolve_device(device)
    dt = dtype or DEFAULT_DTYPE
    nb = torch.as_tensor(neighbors, dtype=torch.int64, device=dev)
    w = torch.as_tensor(inv_deg, dtype=dt, device=dev)
    d = torch.as_tensor(np.asarray(d0), dtype=dt, device=dev)
    return _smooth_loop(d, nb, w, iterations)


# the reference's damaged-edge tag list for the Neper polycrystal mesh
# (FEniCSx/...cc:359-361; MFEM zero-based copy at MFEM/...cc:1170-1199).
# 333 appears twice in the original -- kept verbatim.
NEPER_DAMAGED_EDGE_TAGS = (
    148, 342, 333, 19, 380, 408, 328, 329, 325, 323,
    96, 97, 531, 4, 471, 234, 235, 184, 236, 419,
    350, 332, 364, 176, 77, 333, 341, 343, 144, 143,
)
SQUARE_DAMAGED_EDGE_TAGS = (4,)
