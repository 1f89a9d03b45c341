"""Where one CG iteration of the lane solver spends its time.

    python -m tpufem_torch.perf.cg_profile -n 1024 --iters 50 [--no-fused]
        [--pc jacobi|twolevel]

Builds the polycrystal problem at lattice size ``n`` (float32; the fused
element kernel, or the staged pipeline with ``--no-fused``; the two-level
preconditioner, or Jacobi with ``--pc jacobi``), linearizes at the
Dirichlet-lifted zero state, and applies the constrained tangent, the
preconditioner and the CG vector updates ``--iters`` times under
``torch.profiler``. Prints one JSON line: wall time per iteration (host
clock around a synchronize), the device-busy time per iteration (sum of
kernel times from the profiler), the idle share, the number of kernel
launches per iteration, the kernels that take the most device time, and
the device time of the fine tangent's kernels K4 (``lane_fused_elem``, or
``lane_fused_gen`` where the physics is generated from the integrand,
``lane_fused_gen_mq`` on the multi-quadrature-point path) and K3
(``lane_pass_update``) per iteration. Under two-level it also splits an iteration into its parts, each run
alone (wall and device time, launches) and multiplied by its count per
iteration: the fine Chebyshev tangents, the lattice V-cycle, K5
restriction and prolongation (with the selector products), and the rest
(CG vector work and the preconditioner's own vector updates). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from tpufem_torch.cases import mechanic2d, polycrystal
from tpufem_torch.cases.damage import smooth_damage
from tpufem_torch.config import resolve_device
from tpufem_torch.forms import EnergyFunctional, asym_damage_psi
from tpufem_torch.forms.form import Coefficient, Term
from tpufem_torch.lane import LaneEngine
from tpufem_torch.lane import kernels as K
from tpufem_torch.spaces import DirichletBC, FunctionSpace
from tpufem_torch.spaces.bc import locate_dofs_geometrical

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def case_inputs(mesh):
    """Per-cell modulus and smoothed damage of the polycrystal case."""
    E_cell = mechanic2d.young_modulus_range()[
        np.asarray(mesh.cell_tags, dtype=np.int64) % 200]
    d0 = np.zeros(mesh.n_nodes)
    d0[polycrystal.damage_seed_nodes(mesh)] = 1.0
    return E_cell, smooth_damage(mesh, d0, iterations=8, backend="host")


def damage_functional(mesh, dev, dtype):
    """The case's energy functional and Dirichlet conditions."""
    V = FunctionSpace.create(mesh, 1, bs=2)
    DS = FunctionSpace.create(mesh, 1, bs=1)
    P0 = FunctionSpace.create(mesh, 0, bs=1)
    F = EnergyFunctional(
        V, [Term(lambda qp: asym_damage_psi(
            qp.eps, qp.coeff("d"), qp.coeff("E"), 0.3), 1)],
        [Coefficient("d", DS), Coefficient("E", P0)], device=dev, dtype=dtype)
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [DirichletBC(V, left, [0.0, 0.0]),
           DirichletBC(V, right, [0.01, 0.0])]
    return F, bcs


def _device_profile(fn, reps):
    """(device-busy ms, kernel launches) per call of ``fn`` over ``reps``
    calls under ``torch.profiler``, and the kernels' rows (name, device
    ms, calls over all ``reps``); ``None`` for the first two when the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower()
            and e.device_time_total > 0]
    if not rows:
        return None, None, rows
    return (sum(r[1] for r in rows) / reps, sum(r[2] for r in rows) / reps,
            rows)


def _part(fn, reps):
    """One part of a CG iteration alone: wall ms per call (host clock
    around ``reps`` calls and a synchronize), device-busy ms and kernel
    launches per call (profiler)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / reps
    dev, n, _ = _device_profile(fn, reps)
    return dict(wall_ms=wall,
                device_ms=dev if dev is not None else "not measured",
                launches=n if n is not None else "not measured")


def profile_cg_iteration(eng, cc, iters: int, twolevel=None,
                         amg=None) -> dict:
    """Time and profile ``iters`` CG iterations of ``eng`` (staged or
    fused, on a hand-written law or on the generated physics) at the
    Dirichlet-lifted zero state: wall ms, device-busy ms,
    idle share and kernel launches per iteration, the lane kernels' own
    launch counts, and the kernels with the most device time.
    ``twolevel``: ``(static, geo)`` of ``lane.twolevel.build_twolevel_geo``
    -- the iteration then preconditions with the two-level cycle, and the
    result also holds ``parts``, the split of one iteration. ``amg``: an
    ``la.amg.AMGHierarchy`` on the engine's device -- the iteration then
    preconditions with one V-cycle (degree 2) in the flat layout, as the
    mixed solver does, and ``parts`` splits it into the fine tangent, the
    V-cycle, the lane <-> flat maps and the rest. A staged engine is
    linearized once; on the multi-quadrature-point path ``parts`` splits
    its tangent into K1 gather, reduced arguments, Hessian apply, chain
    back, K2 scatter and K3 owner-sum / refresh, on the generic path into
    K1 gather, the element-matrix product, K2 scatter and K3. With facet
    terms, ``facet_part`` is the facet Hessians' application alone (the
    state at the facet dofs, the per-facet products, the fixed-order
    gather-sum into the owner and copy slots), once per iteration. On
    the generated fused route ``parts`` splits the tangent into K4-gen
    (K4-gen-mq on the multi-qp path) and K3, beside K4-gen's byte bound,
    reckoned for all lane cells and for the real cells only."""
    from tpufem_torch.lane import twolevel as tl
    from tpufem_torch.structured import mg2d

    free = eng.free_lane
    u = torch.where(free > 0, torch.zeros_like(eng.bc_lane), eng.bc_lane)
    lin = None if eng._fused else eng.linearize(u, cc)
    A_raw = eng.make_tangent(u, cc, lin)

    def A(v):
        return A_raw(v * free) * free + v * (1.0 - free)

    if amg is not None:
        from tpufem_torch.la.amg import vcycle

        def M(r):
            return eng.to_lane_dev(vcycle(amg, eng.from_lane_dev(r)))
    elif twolevel is None:
        dinv = torch.ones_like(u)

        def M(r):
            return dinv * r
    else:
        static, geo = twolevel
        data = tl.refresh_twolevel(eng, static, geo, u, cc, A=A)

        def M(r):
            return tl.precondition_with(eng, static, data, free, r, A)
    b = -eng.residual(u, cc) * free

    def iteration(x, r, p, rz):
        # the body of the solver's CG loop (engine.make_solver)
        Ap = A(p)
        alpha = rz / eng.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = eng.dot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new

    z0 = M(b)
    state = [(torch.zeros_like(b), b, z0, eng.dot(b, z0))]

    def step():
        state[0] = iteration(*state[0])

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    before = K.launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    own_launches = {k: v - before[k] for k, v in K.launch_counts().items()}
    busy, n_kernels, rows = _device_profile(step, iters)
    rows.sort(key=lambda r: -r[1])
    out = dict(
        fused=eng._fused,
        fused_route=(None if not eng._fused else "generated"
                     if eng.fused_law is None else "hand-written"),
        preconditioner=("amg" if amg is not None else "jacobi"
                        if twolevel is None else "twolevel"),
        iters=iters,
        wall_ms_per_iter=wall_ms,
        device_busy_ms_per_iter=busy if rows else "not measured",
        device_idle_share=(1.0 - busy / wall_ms) if rows
        else "not measured",
        kernel_launches_per_iter=n_kernels if rows else "not measured",
        lane_kernel_launches_per_iter={
            k: v / iters for k, v in own_launches.items()},
        top_kernels=[dict(name=k[:80], ms_per_iter=t / iters,
                          calls_per_iter=c / iters)
                     for k, t, c in rows[:12]],
        # the fine tangent's two kernels, summed over the iteration (K3's
        # owner-sum and refresh run as two CUDA kernels)
        lane_kernel_device_ms_per_iter={
            name: sum(t for k, t, _ in rows
                      if any(f"{s}_kernel" in k for s in symbols)) / iters
            for name, symbols in (
                ("lane_fused_elem", ("lane_fused_elem",)),
                ("lane_fused_gen", ("lane_fused_gen",)),
                ("lane_fused_gen_mq", ("lane_fused_gen_mq",)),
                ("lane_pass_update", ("lane_pass_update",
                                      "lane_owner_sum")))}
        if rows else "not measured",
    )
    if eng.facet_arrays:
        facets = lin.facets if lin is not None else eng.facet_hessians(u)
        r = state[0][1]
        y = eng.residual(u, cc)
        out["facet_part"] = _part(lambda: eng._facet_apply(y, facets, r), 20)
        out["facet_part"]["n_facets"] = [int(H.shape[0]) for H in facets]
    if eng._fused and eng.fused_law is None:
        # the generated-fused tangent in its parts, once each per
        # iteration: K4-gen (gather, the generated physics, bin scatter;
        # on the multi-qp path summed over the points) and K3 owner-sum and
        # refresh (the tail included); "rest" is the facet part, the CG
        # vector work and the Jacobi scaling. Beside them K4-gen's byte
        # bound: index, geometry and coefficient rows and both states read
        # once, the bin partials written once -- for every lane cell, and
        # with the cell rows of the real cells only (padding lane cells
        # need not be read)
        p = eng.plan
        r = state[0][1]
        cds = eng._fused_cds(cc, r.dtype)
        phys = eng.fused_gen(r.dtype)

        def k4_gen():
            return K.lane_fused_gen((u, r), eng.gather_starts,
                                    eng.gather_idx, cds, phys, wr=p.wg,
                                    nv=p.nv)

        part = k4_gen().permute(1, 0, 2, 3)
        parts = dict(
            k4_gen=_part(k4_gen, 20),
            # the tail owner-sum adds into its argument: timing only
            owner_refresh=_part(lambda: eng._owner_refresh(part), 20),
        )
        out["parts"] = _per_iter(parts, dict.fromkeys(parts, 1), busy,
                                 n_kernels, rows)

        def size(*ts):
            return sum(t.numel() * t.element_size() for t in ts)

        cell_bytes = size(eng.gather_idx, *cds)
        k4_bytes = cell_bytes + size(u, r, part)
        real = float(np.count_nonzero(np.asarray(p.cell_valid))) / (
            p.G * p.kc * 128)
        k4_real = cell_bytes * real + size(u, r, part)
        out["parts"].update(
            k4_gen_route="multiqp" if phys.MULTIQP else "p1",
            k4_gen_bound_bytes=k4_bytes,
            k4_gen_bound_ms=k4_bytes / HBM_BYTES_PER_S * 1e3,
            real_cell_share=real, k4_gen_bound_bytes_real_cells=k4_real,
            k4_gen_bound_ms_real_cells=k4_real / HBM_BYTES_PER_S * 1e3)
    if eng._gen is not None and lin is not None:
        # the staged generic tangent in its four parts, once each per
        # iteration: K1 gather, the element-matrix product (one
        # multiply-sum over the stored (nd, nd, M) matrices), K2 scatter,
        # K3 owner-sum and refresh; "rest" is the facet part, the CG vector
        # work and the Jacobi scaling
        gen, p = eng._gen, eng.plan
        r = state[0][1]
        vc = eng._gather_cells(r)
        ev = gen.apply(lin.cells, vc)
        src = ev.reshape(p.nv * eng.bs, p.G, p.kc, 128).contiguous()
        part = K.lane_scatter_cm(src, eng.gather_idx, k_out=p.wg,
                                 n_ch=eng.bs, table=eng.scatter_table)
        parts = dict(
            gather=_part(lambda: eng._gather_cells(r), 20),
            element_matrix_product=_part(lambda: gen.apply(lin.cells, vc),
                                         20),
            scatter=_part(lambda: K.lane_scatter_cm(
                src, eng.gather_idx, k_out=p.wg, n_ch=eng.bs,
                table=eng.scatter_table), 20),
            # the tail owner-sum adds into its argument: timing only
            owner_refresh=_part(lambda: eng._owner_refresh(part), 20),
        )
        out["parts"] = _per_iter(parts, dict.fromkeys(parts, 1), busy,
                                 n_kernels, rows)
    if eng._mq is not None and lin is not None:
        # the staged multi-qp tangent application in its six parts, once
        # each per iteration: K1 gather, reduced arguments (a batched
        # product with dN and the value products), the stored per-point
        # Hessian applied, the chain back to the dof rows, K2 scatter, K3
        # owner-sum and refresh (the tail tables included); "rest" is the
        # CG vector work and the Jacobi scaling
        mq, D = eng._mq, eng.geom_dN
        p = eng.plan
        r = state[0][1]
        vc = eng._gather_cells(r)
        a = mq.reduced_args(vc, D)
        dg = mq.hess_apply(lin.cells, a)
        ev = mq.chain_back(dg, D)
        src = ev.reshape(p.nv * eng.bs, p.G, p.kc, 128).contiguous()
        part = K.lane_scatter_cm(src, eng.gather_idx, k_out=p.wg,
                                 n_ch=eng.bs, table=eng.scatter_table)
        parts = dict(
            gather=_part(lambda: eng._gather_cells(r), 20),
            reduced_args=_part(lambda: mq.reduced_args(vc, D), 20),
            hess_apply=_part(lambda: mq.hess_apply(lin.cells, a), 20),
            chain_back=_part(lambda: mq.chain_back(dg, D), 20),
            scatter=_part(lambda: K.lane_scatter_cm(
                src, eng.gather_idx, k_out=p.wg, n_ch=eng.bs,
                table=eng.scatter_table), 20),
            # the tail owner-sum adds into its argument: timing only
            owner_refresh=_part(lambda: eng._owner_refresh(part), 20),
        )
        out["parts"] = _per_iter(parts, dict.fromkeys(parts, 1), busy,
                                 n_kernels, rows)
    if amg is not None:
        from tpufem_torch.la.amg import vcycle

        r = state[0][1]
        r_flat = eng.from_lane_dev(r)
        parts = dict(
            fine_tangent=_part(lambda: A(r), 20),
            vcycle=_part(lambda: vcycle(amg, r_flat), 10),
            lane_maps=_part(lambda: eng.to_lane_dev(eng.from_lane_dev(r)),
                            20),
        )
        out["parts"] = _per_iter(parts, dict(fine_tangent=1, vcycle=1,
                                             lane_maps=1), busy, n_kernels,
                                 rows)
        out["parts"]["amg_levels"] = amg.n_levels
    if twolevel is not None:
        # the parts of one iteration, each run alone: the fine operator
        # runs once in CG and 2 * degree times in the cycle (degree - 1 in
        # the first Chebyshev sweep, which starts from zero and skips A(0),
        # one for the residual, degree in the second sweep, whose last step
        # makes no product), the
        # V-cycle once, restriction and prolongation (K5 + the selector
        # product) once each; "rest" is the iteration's device time and
        # launches that none of them accounts for (CG and Chebyshev vector
        # updates, masks, inner products)
        r = state[0][1]
        res = r * free * eng.owned_w.to(r.dtype)
        rc = tl.restrict(eng, static, data, res) * data.coarse_free.to(
            r.dtype)
        parts = dict(
            fine_tangent=_part(lambda: A(r), 20),
            vcycle=_part(lambda: mg2d.vcycle(data.mg_data, rc), 10),
            restrict=_part(lambda: tl.restrict(eng, static, data, res), 20),
            prolong=_part(lambda: tl.prolong(eng, static, data, rc), 20),
        )
        counts = dict(fine_tangent=1 + 2 * static.degree, vcycle=1,
                      restrict=1, prolong=1)
        out["parts"] = _per_iter(parts, counts, busy, n_kernels, rows)
        out["parts"]["mg_levels"] = len(data.mg_data.levels)
    return out


def _per_iter(parts, counts, busy, n_kernels, rows) -> dict:
    """The parts of one iteration (each timed alone by :func:`_part`)
    times their calls per iteration, and "rest": the iteration's device
    time and launches that none of them accounts for."""
    per_iter = {k: {p: parts[p][k] * counts[p] for p in parts}
                for k in ("wall_ms", "device_ms", "launches")
                if all(isinstance(parts[p][k], float) for p in parts)}
    if rows and "device_ms" in per_iter:
        per_iter["device_ms"]["rest"] = busy - sum(
            per_iter["device_ms"].values())
        per_iter["launches"]["rest"] = n_kernels - sum(
            per_iter["launches"].values())
    return dict(per_call=parts, calls_per_iter=counts, per_iter=per_iter)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="profile the fused element kernel's CG iteration "
                         "(default; --no-fused: the staged pipeline)")
    ap.add_argument("--pc", default="twolevel", choices=["jacobi",
                                                         "twolevel"])
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    mesh = polycrystal.generate_polycrystal(args.n, n_grains=200)
    F, bcs = damage_functional(mesh, dev, torch.float32)
    eng = LaneEngine(F, bcs, wg_own=16, fused=args.fused, device=dev,
                     dtype=torch.float32)
    E_cell, d = case_inputs(mesh)
    cc = eng.prepare_coeffs({"d": d, "E": E_cell})
    twolevel = None
    if args.pc == "twolevel":
        from tpufem_torch.lane.twolevel import build_twolevel_geo

        twolevel = build_twolevel_geo(eng, {"d": d, "E": E_cell})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps(dict(card=smi, n=args.n, n_dofs=F.space.n_dofs,
                          **profile_cg_iteration(eng, cc, args.iters,
                                                 twolevel))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
