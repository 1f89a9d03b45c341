"""Where one CG iteration of the lane solver spends its time.

    python -m tpufem_torch.perf.cg_profile -n 1024 --iters 50 [--fused]

Builds the polycrystal problem at lattice size ``n`` (float32, Jacobi;
staged pipeline, or the fused element kernel with ``--fused``),
linearizes at the Dirichlet-lifted zero state, and
applies the constrained tangent + the CG vector updates ``--iters``
times under ``torch.profiler``. Prints one JSON line: wall time per
iteration (host clock around a synchronize), the device-busy time per
iteration (sum of kernel times from the profiler), the idle share, the
number of kernel launches per iteration, and the kernels that take the
most device time. Needs a CUDA device.
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


def profile_cg_iteration(eng, cc, iters: int) -> dict:
    """Time and profile ``iters`` CG iterations of ``eng`` (staged or
    fused) at the Dirichlet-lifted zero state: wall ms, device-busy ms,
    idle share and kernel launches per iteration, the lane kernels'
    own launch counts, and the kernels with the most device time."""
    free = eng.free_lane
    u = torch.where(free > 0, torch.zeros_like(eng.bc_lane), eng.bc_lane)
    A_raw = eng.make_tangent(u, cc)
    dinv = torch.ones_like(u)
    b = -eng.residual(u, cc) * free

    def iteration(x, r, p, rz):
        # the body of the solver's CG loop (engine.make_solver)
        Ap = A_raw(p * free) * free + p * (1.0 - free)
        alpha = rz / eng.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = eng.dot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new

    state = (torch.zeros_like(b), b, b.clone(), eng.dot(b, b))
    for _ in range(5):
        state = iteration(*state)
    torch.cuda.synchronize()
    before = K.launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        state = iteration(*state)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    own_launches = {k: v - before[k] for k, v in K.launch_counts().items()}

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            state = iteration(*state)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "cuda" in str(e.device_type).lower()
            and e.device_time_total > 0]
    busy_ms = sum(r[1] for r in rows) / iters
    n_kernels = sum(r[2] for r in rows) / iters
    rows.sort(key=lambda r: -r[1])
    return dict(
        fused=eng.fused_law is not None, iters=iters,
        wall_ms_per_iter=wall_ms,
        device_busy_ms_per_iter=busy_ms if rows else "not measured",
        device_idle_share=(1.0 - busy_ms / wall_ms) if rows
        else "not measured",
        kernel_launches_per_iter=n_kernels if rows else "not measured",
        lane_kernel_launches_per_iter={
            k: v / iters for k, v in own_launches.items()},
        top_kernels=[dict(name=k[:80], ms_per_iter=t / iters,
                          calls_per_iter=c / iters)
                     for k, t, c in rows[:12]],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--fused", action="store_true",
                    help="profile the fused element kernel's CG iteration")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    mesh = polycrystal.generate_polycrystal(args.n, n_grains=200)
    F, bcs = damage_functional(mesh, dev, torch.float32)
    eng = LaneEngine(F, bcs, wg_own=16, fused=args.fused, device=dev,
                     dtype=torch.float32)
    E_cell, d = case_inputs(mesh)
    cc = eng.prepare_coeffs({"d": d, "E": E_cell})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps(dict(card=smi, n=args.n, n_dofs=F.space.n_dofs,
                          **profile_cg_iteration(eng, cc, args.iters))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
