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
the device time of the fine tangent's kernels K4 (``lane_fused_elem``) and
K3 (``lane_pass_update``) per iteration. Under two-level it also splits an iteration into its parts, each run
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


def profile_cg_iteration(eng, cc, iters: int, twolevel=None) -> dict:
    """Time and profile ``iters`` CG iterations of ``eng`` (staged or
    fused) at the Dirichlet-lifted zero state: wall ms, device-busy ms,
    idle share and kernel launches per iteration, the lane kernels' own
    launch counts, and the kernels with the most device time.
    ``twolevel``: ``(static, geo)`` of ``lane.twolevel.build_twolevel_geo``
    -- the iteration then preconditions with the two-level cycle, and the
    result also holds ``parts``, the split of one iteration."""
    from tpufem_torch.lane import twolevel as tl
    from tpufem_torch.structured import mg2d

    free = eng.free_lane
    u = torch.where(free > 0, torch.zeros_like(eng.bc_lane), eng.bc_lane)
    A_raw = eng.make_tangent(u, cc)

    def A(v):
        return A_raw(v * free) * free + v * (1.0 - free)

    if twolevel is None:
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
        fused=eng.fused_law is not None,
        preconditioner="jacobi" if twolevel is None else "twolevel",
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
                ("lane_pass_update", ("lane_pass_update",
                                      "lane_owner_sum")))}
        if rows else "not measured",
    )
    if twolevel is not None:
        # the parts of one iteration, each run alone: the fine operator
        # runs once in CG and 2 * degree + 2 times in the cycle (degree in
        # the first Chebyshev sweep, which starts from zero and skips A(0),
        # one for the residual, 1 + degree in the second sweep), the
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
        counts = dict(fine_tangent=3 + 2 * static.degree, vcycle=1,
                      restrict=1, prolong=1)
        per_iter = {k: {p: parts[p][k] * counts[p] for p in parts}
                    for k in ("wall_ms", "device_ms", "launches")
                    if all(isinstance(parts[p][k], float) for p in parts)}
        if rows and "device_ms" in per_iter:
            per_iter["device_ms"]["rest"] = busy - sum(
                per_iter["device_ms"].values())
            per_iter["launches"]["rest"] = n_kernels - sum(
                per_iter["launches"].values())
        out["parts"] = dict(per_call=parts, calls_per_iter=counts,
                            per_iter=per_iter,
                            mg_levels=len(data.mg_data.levels))
    return out


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
