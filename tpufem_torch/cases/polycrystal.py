"""Synthetic Neper-style polycrystal workload on the unstructured path.

The reference's benchmark mesh is an unstructured Neper polycrystal of
~200 grains (doc.tex:163-187) at ~3.08M nodes / 6.17M displacement dofs
(doc.tex:2336-2337). This module generates a statistically equivalent
workload -- a jittered Delaunay triangulation of the unit square with
Voronoi grain tags -- and solves the same asymmetric elasto-damage
problem end-to-end on the lane-partitioned unstructured engine, on the
GPU unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from tpufem_torch.config import (DEFAULT_DTYPE, INDEX_DTYPE, SolverConfig,
                                 resolve_device)
from tpufem_torch.mesh.mesh import CellType, Mesh


def generate_polycrystal(
    n: int,
    *,
    n_grains: int = 200,
    seed: int = 6575,
    jitter: float = 0.35,
) -> Mesh:
    """Unstructured triangulation of the unit square with grain tags.

    (n+1)^2 nodes on a jittered lattice (boundary nodes stay exact so
    Dirichlet predicates work), Delaunay-triangulated; each cell gets
    the grain tag of the nearest of ``n_grains`` seed points — a Voronoi
    polycrystal. Grain seeds and jitter are reproducible (numpy PCG with
    ``seed``; the per-grain E field later reuses the reference's glibc
    srand(6575) stream keyed by these tags, mechanic2d.young_modulus_range).
    """
    from scipy.spatial import Delaunay, cKDTree

    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    h = 1.0 / n
    inner = (
        (pts[:, 0] > 0) & (pts[:, 0] < 1) & (pts[:, 1] > 0) & (pts[:, 1] < 1)
    )
    pts[inner] += rng.uniform(-jitter * h, jitter * h, (inner.sum(), 2))

    tri = Delaunay(pts)
    cells = tri.simplices.astype(INDEX_DTYPE)
    # drop degenerate slivers (qhull can emit near-zero-area cells on
    # cocircular boundary points)
    v = pts[cells]
    area2 = np.abs(
        (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
        - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1])
    )
    cells = cells[area2 > 1e-14]

    seeds = rng.uniform(0.0, 1.0, (n_grains, 2))
    centroids = pts[cells].mean(axis=1)
    _, grain = cKDTree(seeds).query(centroids)
    tags = (grain + 1).astype(INDEX_DTYPE)
    return Mesh(
        x=pts, cells=cells, cell_type=CellType.triangle, cell_tags=tags,
    )


def damage_seed_nodes(mesh: Mesh, *, n_chains: int = 30,
                      band: float = 0.15, seed: int = 333) -> np.ndarray:
    """Nodes of ~n_chains grain-boundary edge chains near y=0.5 — the
    polycrystal analog of the reference's 30 damaged edge tags
    (FEniCSx/...cc:359-361): d=1 seeds along grain boundaries, NOT a
    severing band (a full band disconnects the tension path and stalls
    Newton)."""
    from tpufem_torch.mesh.topology import build_entities

    facets, c2f = build_entities(mesh, 1)
    nf = len(facets)
    tags = np.asarray(mesh.cell_tags, dtype=np.int64)
    tmin = np.full(nf, np.iinfo(np.int64).max)
    tmax = np.full(nf, -1, dtype=np.int64)
    nlf = c2f.shape[1]
    rep = np.repeat(tags, nlf)
    f = c2f.ravel().astype(np.int64)
    np.minimum.at(tmin, f, rep)
    np.maximum.at(tmax, f, rep)
    gb = tmax != tmin  # grain-boundary facets
    ymid = mesh.x[facets].mean(axis=1)[:, 1]
    cand = gb & (np.abs(ymid - 0.5) < band)
    pair = tmin * 100000 + tmax
    pairs = np.unique(pair[cand])
    if len(pairs) == 0:
        return np.zeros(0, dtype=np.int64)
    rng = np.random.default_rng(seed)
    chosen = rng.choice(pairs, size=min(n_chains, len(pairs)),
                        replace=False)
    sel = cand & np.isin(pair, chosen)
    return np.unique(facets[sel].ravel())


@dataclasses.dataclass
class PolycrystalResult:
    mesh: Mesh
    n_dofs: int
    u_flat: np.ndarray
    energy: float  # total potential (strain energy + load energy)
    stats: dict
    timings: dict
    strain: Optional[np.ndarray] = None  # (nc, 3) [e11,e12,e22] DG0
    stress: Optional[np.ndarray] = None  # (nc, 3)
    energy_density: Optional[np.ndarray] = None  # (nc,) sigma:eps
    energy_stiff: Optional[float] = None  # strain energy alone


def run(
    n: int = 128,
    *,
    n_grains: int = 200,
    use_ecst: bool = False,
    solver: Optional[SolverConfig] = None,
    wg_own: int = 16,
    gmsh_roundtrip: bool = False,
    smooth_iters: int = 8,
    n_damage_chains: int = 30,
    mesh: Optional[Mesh] = None,
    plan=None,
    mixed: bool = False,
    postprocess_fields: bool = True,
    output_path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    use_volume: bool = True,
    fused: bool = True,
    cg_chunk: Optional[int] = None,
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
) -> PolycrystalResult:
    """End-to-end: generate (or take) the polycrystal, per-grain E via the
    reference's glibc stream, damage seeds + smoothing, volumetric body
    force, LaneEngine Newton-Krylov solve, energy and DG0 strain/stress.

    Mirrors the mechanic2d phase structure on the *unstructured* path --
    the reference's actual workload shape (doc.tex:163-187).

    ``use_volume``: include the volumetric load (the reference's
    benchmark build defines USE_VOLUME, FEniCSx/...cc:4,559-588). The
    load term is linear in u, so its assembled gradient is a CONSTANT
    vector with zero tangent -- it is assembled ONCE with the flat
    Assembler at the exact quadrature degree (degree 2, the reference's
    Measure metadata split, asym_ufl.py:78-81) and enters the solve as
    ``const_residual`` -- the reference's own 'Fcst' precomputed-load
    variant (doc.tex:1583-1586) -- keeping the lane kernels on the
    single-term degree-1 path.

    ``mesh`` and ``plan`` (the ``LanePlan`` of an engine built earlier on
    that mesh with the same ``wg_own``) skip their host set-up when a
    caller solves on one mesh several times.

    ``fused`` is forwarded to ``LaneEngine``: ``True`` (the default, as
    in the reference) runs residual and CG operator through the fused
    element kernel ``lane_fused_elem``; ``False`` through the staged
    gather / physics / scatter pipeline. The default solver is the
    reference's: CG preconditioned by the two-level lattice cycle
    (``preconditioner="twolevel"``), with the per-cell damage and
    modulus sampled onto its lattice. ``cg_chunk`` (CG iterations
    enqueued between two host reads) defaults to the reference's: 20
    under two-level and 200 under Jacobi, so the stall guard, which reads
    chunk ends, gives up on the same iteration; the two-level set-up is
    reported as its own row of
    ``timings``, inside "7.3". ``device`` defaults to CUDA and
    ``dtype`` to float32; every device tensor of the run has them.

    ``mixed``: the mixed-precision solve (``LaneEngine.make_mixed_solver``)
    -- a float64 Newton loop on the flat ``Assembler`` around CG solves on
    the lane engine in ``dtype``. The damage, the functional, the load
    vector, the energy and the DG0 fields are then float64 and only the
    engine holds ``dtype``. The mixed solve also takes
    ``preconditioner="amg"`` (the SA-AMG hierarchy of the flat matrix,
    ``la.amg``, with the CG chunk of 200 as under Jacobi); the lane solver
    alone raises ``ValueError`` for it. ``checkpoint_path`` (mixed only: a ``ValueError
    otherwise) saves the iterate after every Newton step and resumes from
    it.

    ``gmsh_roundtrip``: write the mesh as gmsh 2.2 and read it back
    before the solve (the ingest path the reference's Neper meshes take).
    ``output_path``: the output phase -- an XDMF file with one HDF5 file
    of heavy data beside it (u and damage on the nodes; E, grain tag and,
    with ``postprocess_fields``, strain / stress / energy density on the
    cells).
    """
    if checkpoint_path is not None and not mixed:
        raise ValueError("polycrystal.run(checkpoint_path=...) checkpoints "
                         "the mixed-precision solve: pass mixed=True")
    from tpufem_torch.assemble.assembler import Assembler
    from tpufem_torch.cases import mechanic2d
    from tpufem_torch.cases.damage import smooth_damage
    from tpufem_torch.forms import EnergyFunctional, asym_damage_psi
    from tpufem_torch.forms.form import Coefficient, Term
    from tpufem_torch.lane import LaneEngine
    from tpufem_torch.spaces import DirichletBC, FunctionSpace
    from tpufem_torch.spaces.bc import locate_dofs_geometrical

    dev = resolve_device(device)
    # mixed: everything outside the engine's inner solves in float64
    odt = torch.float64 if mixed else dtype
    timings = {}

    def lap(label, t0):
        # device work is asynchronous: a phase ends when the device does
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings[label] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if mesh is None:
        mesh = generate_polycrystal(n, n_grains=n_grains)
    lap("2.1 generate/read mesh", t0)

    if gmsh_roundtrip:
        import os
        import tempfile

        from tpufem_torch.mesh.gmsh import read_gmsh, write_gmsh

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "poly.msh")
            write_gmsh(path, mesh)
            mesh = read_gmsh(path)
        lap("2.1b gmsh roundtrip", t0)

    t0 = time.perf_counter()
    V = FunctionSpace.create(mesh, 1, bs=2)
    DS = FunctionSpace.create(mesh, 1, bs=1)
    lap("3.1 define space", t0)

    # per-grain Young's modulus from the reference's srand(6575) stream
    t0 = time.perf_counter()
    E_range = mechanic2d.young_modulus_range(use_ecst=use_ecst)
    tags = np.asarray(mesh.cell_tags, dtype=np.int64)
    E_cell = E_range[tags % 200]
    lap("4.1 material constant", t0)

    # damage: grain-boundary edge chains seeded d=1, smoothed by the
    # reference's loop (mirrors the 30-tag damaged-edge list,
    # FEniCSx/...cc:359-361)
    t0 = time.perf_counter()
    d0 = np.zeros(DS.n_dofs)
    if n_damage_chains > 0:
        d0[damage_seed_nodes(mesh, n_chains=n_damage_chains)] = 1.0
    d = smooth_damage(mesh, d0, iterations=smooth_iters, dtype=odt,
                      device=dev).cpu().numpy()
    lap("3.2 define damage", t0)

    NU = 0.3
    t0 = time.perf_counter()
    # per-cell E enters as a P0 coefficient
    P0 = FunctionSpace.create(mesh, 0, bs=1)
    stiff = Term(
        integrand=lambda qp: asym_damage_psi(
            qp.eps, qp.coeff("d"), qp.coeff("E"), NU
        ),
        degree=1,
    )
    F = EnergyFunctional(
        V, [stiff], [Coefficient("d", DS), Coefficient("E", P0)],
        device=dev, dtype=odt,
    )
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [DirichletBC(V, left, [0.0, 0.0]),
           DirichletBC(V, right, [0.01, 0.0])]
    lap("5.1 dirichlet setting", t0)

    # volumetric body force, assembled once as a constant residual term
    # (exact: the term is linear in u -- MFEM Fcst, doc.tex:1583-1586)
    t0 = time.perf_counter()
    r_load = None
    if use_volume:
        fvals = mechanic2d.volumetric_load(V.dof_coords)
        f_vec = torch.as_tensor(fvals.reshape(-1), dtype=odt, device=dev)
        load = Term(
            integrand=lambda qp: -torch.dot(qp.coeff("f"), qp.u),
            degree=2,
        )
        F_load = EnergyFunctional(V, [load], [Coefficient("f", V)],
                                  device=dev, dtype=odt)
        r_load = Assembler(F_load, []).residual(
            torch.zeros(V.n_dofs, dtype=odt, device=dev), {"f": f_vec},
            batch=65536,
        )
    lap("5.2 neumann/volume setting", t0)

    t0 = time.perf_counter()
    eng = LaneEngine(F, bcs, wg_own=wg_own, plan=plan, fused=fused,
                     device=dev, dtype=dtype)
    cc = eng.prepare_coeffs({"d": d, "E": E_cell})
    lap("7.1 lane plan + coeffs", t0)

    cfg = solver or SolverConfig(
        cg_rtol=1e-8, newton_rtol=1e-6, cg_maxit=20000,
        preconditioner="twolevel",
    )
    use_tl = cfg.preconditioner == "twolevel"
    if cg_chunk is None:
        cg_chunk = 20 if use_tl else 200
    fine = {"d": d, "E": E_cell} if use_tl else None
    t0 = time.perf_counter()
    if mixed:
        solve = eng.make_mixed_solver(
            cfg, cg_chunk=cg_chunk, fine_coeffs=fine,
            checkpoint_path=checkpoint_path, const_residual=r_load)
        u_flat_dev, stats = solve(
            torch.zeros(V.n_dofs, dtype=odt, device=dev),
            {"d": d, "E": E_cell}, cc)
        tl_seconds = stats["phase_s"]["tl_setup"] + stats["phase_s"][
            "tl_refresh"]
    else:
        solve = eng.make_solver(
            cfg, cg_chunk=cg_chunk, fine_coeffs=fine,
            const_residual=(None if r_load is None
                            else eng.to_lane_dev(r_load)),
        )
        u_lane, stats = solve(torch.zeros_like(eng.bc_lane), cc)
        tl_seconds = stats["twolevel_setup_seconds"]
    lap("7.3 nonlinear resolution", t0)
    if use_tl:
        timings["7.3.1 two-level set-up (in 7.3)"] = tl_seconds

    t0 = time.perf_counter()
    c_pp = {"d": torch.as_tensor(d, dtype=odt, device=dev),
            "E": torch.as_tensor(E_cell, dtype=odt, device=dev)}
    asm = Assembler(F, bcs) if mixed else None
    if mixed:
        # float64 energy through the flat Assembler
        energy = float(asm.energy(u_flat_dev, c_pp, batch=65536))
    else:
        u_flat_dev = eng.from_lane_dev(u_lane)
        energy = float(torch.sum(eng.cell_energies(u_lane, cc)))
    energy_stiff = energy
    if r_load is not None:
        # load energy is linear: E_load(u) = r_load . u exactly
        energy += float(torch.dot(r_load, u_flat_dev))
    u_flat = u_flat_dev.cpu().numpy()
    lap("8 postprocess (energy)", t0)

    # DG0 centroid strain/stress/energy-density -- the reference's
    # "8.1 strain/stress computation" phase (FEniCSx/...cc:909-942)
    # on the polycrystal workload, via the flat expression kernel
    # (slab-batched: bounded temps at multi-million-cell meshes)
    t0 = time.perf_counter()
    strain = stress = endens = None
    if postprocess_fields:
        asm = asm or Assembler(F, bcs)
        strain, stress, endens = mechanic2d.postprocess(
            asm, u_flat_dev, c_pp, batch=65536
        )
    lap("8.1 strain/stress computation", t0)

    # parallel-output analog of the reference's phase 8 (XDMF/VTX,
    # FEniCSx/...cc:946-1032): XDMF + HDF5 heavy data (scale-safe)
    if output_path is not None:
        from tpufem_torch.io.xdmf import write_xdmf

        t0 = time.perf_counter()
        point_data = {"u": u_flat.reshape(-1, 2), "damage": d}
        cell_data = {
            "E": E_cell,
            "grain": np.asarray(mesh.cell_tags, np.float64),
        }
        if postprocess_fields:
            cell_data.update(
                strain=strain, stress=stress, energy_density=endens,
            )
        write_xdmf(output_path, mesh, point_data=point_data,
                   cell_data=cell_data)
        lap("8 outputs", t0)

    return PolycrystalResult(
        mesh=mesh, n_dofs=V.n_dofs, u_flat=u_flat, energy=energy,
        stats=stats, timings=timings,
        strain=strain, stress=stress, energy_density=endens,
        energy_stiff=energy_stiff,
    )
