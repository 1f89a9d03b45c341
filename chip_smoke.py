#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports only ``tpufem_torch``, needs a CUDA device (it exits non-zero
without one: nothing here runs on the CPU instead) and no network, and
prints one JSON line per phase:

1. ``device``      the card as ``nvidia-smi`` names it, torch/CUDA versions
2. ``build``       the kernel library built from ``tpufem_torch/csrc/*.cu``
                   (no spill in any K1 / K3 / K4 / K5 / K6 / K7 / K8 / K9 /
                   K11 instance), and
                   the SASS instructions of K6 / K7 / K8's main loops
3. ``kernels``     each CUDA kernel against its plain PyTorch version on the
                   card, at the shapes of the n = 1024 polycrystal plan
                   (float32/float64 values, int8/int32 indices, both modes
                   of the pass kernel; the fused element kernel in both
                   modes and both laws; the weighted gather at the
                   two-level restriction and prolongation tables; the
                   three kernels on no path -- K9 lane_gather at K1's
                   tables in both modes, K10 lane_scatter at their
                   transpose, K11 lane_scatter_weighted as the adjoint of
                   the prolongation, checked as such against K5 in
                   float64), with times, the bound and a yardstick; K1 /
                   K3 / K4 / K5 / K9 / K11 also at edge shapes; for K1 / K5
                   the mean number of 128-byte lines a warp's direct
                   gather touches
4. ``engine``      n = 64, float64: LaneEngine residual / tangent action /
                   diagonal against the flat Assembler, copies == owners;
                   the fused engine against the staged one and the
                   Assembler; one two-level cycle on the card against the
                   same cycle on the CPU (plain versions)
5. ``solve_small`` polycrystal n = 256 to convergence: Jacobi staged and
                   fused (same Newton count), and fused + two-level
6. ``solve_full``  polycrystal n = 1024 (about 2.1 M dofs), 200 grains, a few
                   Newton steps, staged, Jacobi, twice: the kernels' launch
                   counts, the phase table, a bitwise equal residual
                   trajectory
7. ``solve_full_fused`` the same solve through ``LaneEngine(fused=True)``,
                   twice: launch counts of the fused path, a bitwise equal
                   residual trajectory, and one CG iteration of either
                   engine under the profiler (launches and device time)
8. ``solve_full_twolevel`` n = 1024 through ``polycrystal.run``'s defaults
                   (fused engine, two-level preconditioner) TO CONVERGENCE,
                   twice: bitwise equal residual trajectory, CG counts and
                   u; launch counts (two weighted gathers per application
                   of the preconditioner), the phase table with the
                   two-level set-up, peak memory, and one CG iteration
                   split into its parts under the profiler
9. ``solve_full_mixed`` ``polycrystal.run(mixed=True)``: the float64
                   Newton loop on the flat assembler around float32 lane
                   CG (fused engine, two-level), n = 1024 with ``run``'s
                   defaults to convergence, twice: bitwise equal
                   trajectory, CG counts and u, the phase split, one
                   float64 outer residual timed alone, peak memory, K1-K5
                   launches; the same problem solved in float64 on the lane
                   engine for its time; n = 256 mixed to 1e-10 * r0 held
                   against a float64 lane solve (u rel <= 2e-7)
10. ``structured2d`` K6 / K7 (``lattice_residual``, ``lattice_tangent``)
                   against their plain versions at n = 1024 and six small
                   or odd shapes (1x1 to 2047x3) and against the generic
                   lattice's AD residual
                   and tangent, their times warm (inputs in L2) and cold
                   (from HBM), the K6 assembly rate (MDoF/s); path A: the
                   structured nonlinear solve of
                   ``benchmarks/mechanic2d_pallas_bench.py`` at n = 1024
                   (K6 right-hand side, K7 CG operator, Jacobi) to
                   convergence, twice, bitwise equal, launch counts, one CG
                   iteration under the profiler; the same problem at
                   n = 256 through ``make_grid_solver`` with multigrid
11. ``structured3d`` K8 (``lattice_matvec3d``) against its plain version at
                   n = 160, 9x7x11, 1^3, 2^3 and 33x5x17, against the
                   stored 27-point stencil,
                   the conv3d yardstick; path B: the pulled bar of
                   ``benchmarks/solve3d_bench.py`` at n = 160 (12.5 M dofs)
                   through ``make_grid_solver`` with multigrid and K8 on
                   the levels of >= 16 cells (no stored stencil there),
                   twice, bitwise equal, K8 launches, the hierarchy build
                   and one residual timed alone, one CG iteration under
                   the profiler
12. ``mechanic2d`` the reference study's own workload, ``mechanic2d.run``
                   on square.msh (flat Assembler, Newton with Jacobi CG;
                   no CUDA kernel of the port on its path): at r = 3
                   (6 466 dofs), float64, to convergence on the card and
                   on the CPU (same Newton count, CG +-1 per step, u and
                   energy), the reference's CG counts beside them; at
                   r = 7 (1 608 706 dofs), float64, the reference's CG
                   capped at 2 Newton steps, twice (bitwise equal), the
                   phase table, ms per CG iteration, peak memory, the
                   output phase (VTU + XDMF/HDF5 to a temporary directory,
                   u read back), one CG iteration under the profiler with
                   the linearized operator and with the jvp one; one
                   float32 Newton step for its ms per CG iteration

then the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result line.

``--until PHASE`` stops after that phase (a short first check of newly
written kernels); it then prints no result line either.

K6 / K7 / K8's inputs on the card come from a seeded ``torch.Generator``;
the structured problems are the benchmarks' own, made from numpy.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
          file=sys.stderr)
    sys.exit(2)

from tpufem_torch.assemble import Assembler  # noqa: E402
from tpufem_torch.cases import mechanic2d, polycrystal  # noqa: E402
from tpufem_torch.config import Mechanic2DConfig, SolverConfig  # noqa: E402
from tpufem_torch.forms import (EnergyFunctional, asym_damage_psi,  # noqa: E402
                                linear_elastic_psi)
from tpufem_torch.forms.form import Coefficient, Term  # noqa: E402
from tpufem_torch.io import read_xdmf  # noqa: E402
from tpufem_torch.la import jacobi_preconditioner  # noqa: E402
from tpufem_torch.lane import LaneEngine, _build  # noqa: E402
from tpufem_torch.lane import kernels as K  # noqa: E402
from tpufem_torch.lane import twolevel as TL  # noqa: E402
from tpufem_torch.perf import cg_profile  # noqa: E402
from tpufem_torch.perf import lane_gather_bench as GB  # noqa: E402
from tpufem_torch.perf import lattice_bench as LB  # noqa: E402
from tpufem_torch.mesh import unit_square  # noqa: E402
from tpufem_torch.spaces import DirichletBC, FunctionSpace  # noqa: E402
from tpufem_torch.spaces.bc import locate_dofs_geometrical  # noqa: E402
from tpufem_torch.structured import (StructuredGrid2D,  # noqa: E402
                                     StructuredGrid3D, make_grid_solver,
                                     make_linear_matvec, make_residual_kernel,
                                     make_tangent_kernel)
from tpufem_torch.structured import kernels2d as K2  # noqa: E402
from tpufem_torch.structured import kernels3d as K3  # noqa: E402
from tpufem_torch.structured import mg3d  # noqa: E402

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TRIALS = 11  # readings behind a median time
COLD_SETS = 8  # input copies a cold timing cycles through
F32_FLOPS_PER_S = 67e12  # same sheet, float32 outside the tensor cores
N_FULL, N_SMALL, N_ENGINE = 1024, 256, 64
# caps of the full-width solve (it shows the path and its reproducibility,
# not convergence): 2 Newton steps of at most 300 CG iterations each
FULL_NEWTON_MAXIT, FULL_CG_MAXIT = 2, 300
T_START = time.perf_counter()
PHASES = ("device", "build", "kernels", "engine", "solve_small", "solve_full",
          "solve_full_fused", "solve_full_twolevel", "solve_full_mixed",
          "structured2d", "structured3d", "mechanic2d")
_ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
_ap.add_argument("--until", choices=PHASES, default=PHASES[-1],
                 help="stop after this phase (default: run everything)")
UNTIL = _ap.parse_args().until


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)
    if phase == UNTIL and phase != PHASES[-1]:
        print(json.dumps({"stopped_after": phase}), flush=True)
        sys.exit(0)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def median_ms(fn, reps):
    """[median, least, most] of TRIALS readings of :func:`time_ms`."""
    t = sorted(time_ms(fn, reps) for _ in range(TRIALS))
    return [t[TRIALS // 2], t[0], t[-1]]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# -- 1. device ----------------------------------------------------------------

smi = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, check=True,
).stdout.strip().splitlines()[0]
emit("device", nvidia_smi=smi, torch=torch.__version__,
     cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
     count=torch.cuda.device_count())

# -- 2. build -----------------------------------------------------------------

# always from the sources in this checkout, so that ptxas speaks below
build_seconds = _build.build(verbose=True)
_build.load()
# what ptxas says of every kernel instance: registers per thread and spills
ptxas, entry = {}, None
for ln in _build.build_log.splitlines():
    if "Compiling entry function" in ln:
        entry = ln.split("'")[1][:56]
    elif entry and "registers" in ln:
        ptxas.setdefault(entry, {})["registers"] = int(
            ln.split("Used ")[1].split(" registers")[0])
    elif entry and "spill stores" in ln:
        ptxas.setdefault(entry, {})["spill_bytes"] = sum(
            int(part.split(" bytes")[0].split()[-1])
            for part in ln.split(",")[1:])
# K1 / K3 / K4 / K5 / K9 / K11 run with no register cap, and K6 / K7 / K8
# keep their sums and carried stresses in registers: ptxas must report no
# spill in any of their instances
REDESIGNED = ("lane_pass_update_kernel", "lane_owner_sum_kernel",
              "lane_fused_elem_kernel", "lane_gather_cm_kernel",
              "lane_gather_weighted_kernel", "lane_gather_kernel",
              "lane_scatter_weighted_kernel")
LATTICE = ("lattice2d_kernel", "lattice_matvec3d_kernel")
redesigned = {k: v for k, v in ptxas.items()
              if any(name in k for name in REDESIGNED)}
lattice_ptxas = {k: v for k, v in ptxas.items()
                 if any(name in k for name in LATTICE)}
spills = {k: v for k, v in {**redesigned, **lattice_ptxas}.items()
          if v.get("spill_bytes", 0)}
# K1: 4 instances; K3: 4 + 4; K4: 16 per block layout; K5: 4 with its
# tables staged and 4 with them in registers; K9: 4 staged and 4 reading
# global memory; K11: 4 with its tables staged and 4 without
check(len(redesigned) == 4 + 4 + 4 + 16 * len(K.FUSED_CONFIGS) + 8 + 8 + 8
      and len(lattice_ptxas) == 3 and not spills,
      f"ptxas: {len(redesigned)} K1 / K3 / K4 / K5 / K9 / K11 and "
      f"{len(lattice_ptxas)} K6 / K7 / K8 instances, spills: {spills}")
# the SASS of K6 / K7 / K8: instructions of the main loop, one cell or one
# interior node a thread per pass, and the floor they give over every
# SM's 128 lanes at the card's top clock
CLOCK_MHZ = float(subprocess.run(
    ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
     "nounits"], capture_output=True, text=True,
    check=True).stdout.split()[0])
LANES_PER_S = (torch.cuda.get_device_properties(0).multi_processor_count
               * 128 * CLOCK_MHZ * 1e6)
SASS = {}
for name, prefix in LB.KERNELS.items():
    SASS[name] = LB.sass_counts(
        f"{_build.BUILD_DIR}/{LB.OBJECTS[name]}", prefix)
check(all(v["main_loop_instructions"] for v in SASS.values()),
      f"no main loop found in the SASS of K6 / K7 / K8: {SASS}")
emit("build", seconds=build_seconds, library=_build.LIB_PATH,
     spills=spills, sass=SASS, clock_max_mhz=CLOCK_MHZ,
     sources=[s.split("tpufem_torch/")[-1] for s in _build.sources()],
     ptxas=ptxas)

# -- 3. kernels at the shapes of the n = 1024 plan ------------------------------

NU = 0.3


def damage_problem(mesh, dtype, with_E):
    """Asymmetric elasto-damage functional + the case's Dirichlet BCs."""
    V = FunctionSpace.create(mesh, 1, bs=2)
    DS = FunctionSpace.create(mesh, 1, bs=1)
    coeffs = [Coefficient("d", DS)]
    if with_E:
        coeffs.append(Coefficient("E", FunctionSpace.create(mesh, 0, bs=1)))
        integrand = lambda qp: asym_damage_psi(
            qp.eps, qp.coeff("d"), qp.coeff("E"), NU)
    else:
        integrand = lambda qp: asym_damage_psi(
            qp.eps, qp.coeff("d"), 1.0e6, NU)
    F = EnergyFunctional(V, [Term(integrand, 1)], coeffs, device=DEV,
                         dtype=dtype)
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    bcs = [DirichletBC(V, left, [0.0, 0.0]),
           DirichletBC(V, right, [0.01, 0.0])]
    return F, bcs, V, DS


t0 = time.perf_counter()
mesh_full = polycrystal.generate_polycrystal(N_FULL, n_grains=200)
F_full, bcs_full, V_full, _ = damage_problem(mesh_full, torch.float32, True)
# fused: the engine then carries the geometry rows and the coefficient
# block the fused kernel streams; its plan serves every n = 1024 solve below
eng_full = LaneEngine(F_full, bcs_full, wg_own=16, fused=True, device=DEV,
                      dtype=torch.float32)
E_full, d_full = cg_profile.case_inputs(mesh_full)
cc_full = eng_full.prepare_coeffs({"d": d_full, "E": E_full})
p = eng_full.plan
C, V_, G, kc, wg = eng_full.bs, p.nv, p.G, p.kc, p.wg
shapes = dict(C=C, V=V_, G=G, kc=kc, wg=wg, wg_own=p.wg_own, R=p.R,
              n_dofs=V_full.n_dofs, n_cells=int(mesh_full.n_cells),
              owner_passes=len(eng_full.owner_shifts),
              refresh_passes=len(eng_full.refresh_shifts),
              owner_wrs=list(eng_full.owner_wrs),
              refresh_wrs=list(eng_full.refresh_wrs),
              tail_copies=0 if eng_full._tail_copy is None
              else int(len(eng_full._tail_copy)),
              idx_dtype=str(eng_full.gather_idx.dtype),
              fused_geom=list(eng_full.fused_geom.shape),
              fused_cd=list(cc_full["_cd"].shape),
              fused_law=str(eng_full.fused_law),
              host_setup_seconds=time.perf_counter() - t0)
check(eng_full._owner_idx is not None and eng_full._refresh_idx is not None,
      "the n=1024 plan has no owner/refresh passes")
# the two-level geometry of that engine: K5's tables at full width
t0 = time.perf_counter()
tl_static, tl_geo = TL.build_twolevel_geo(eng_full, {"d": d_full, "E": E_full})
torch.cuda.synchronize()
shapes.update(
    twolevel_setup_seconds=time.perf_counter() - t0,
    twolevel={k: getattr(tl_static, k) for k in ("SC", "WRp", "WRr", "Kc",
                                                 "ncx", "ncy", "Rv")},
    p_idx=[list(tl_geo["p_idx"].shape), str(tl_geo["p_idx"].dtype)],
    r_idx=[list(tl_geo["r_idx"].shape), str(tl_geo["r_idx"].dtype)],
    o_dst=int(tl_geo["o_dst"].numel()),
    mg_levels=[list(L.u_lin.shape) for L in tl_geo["mg_data"].levels],
    mg_coarse=list(tl_geo["mg_data"].coarse_inv.shape))

gen = torch.Generator(device=DEV)
gen.manual_seed(1234)
results = {}


def record(name, err, ms, plain_ms, bound_bytes, library_ms, **extra):
    r = results.setdefault(name, dict(max_abs_err=0.0, bound_by="bytes"))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if ms is not None:  # the main-path variant carries the times
        r.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=bound_bytes / HBM_BYTES_PER_S * 1e3,
                 bound_bytes=bound_bytes, **extra)


# K4's arithmetic per cell slot, counted by hand from the kernel source
# (strain, Lame factors, stress or its directional derivative, six element
# vector rows, six accumulator adds): far below what its bytes cost
K4_FLOPS_PER_CELL = {1: 120, 2: 180}
LAW_ELASTIC = K.FusedLaw("linear_elastic", NU, E=eng_full.fused_law.E)
k4_rel = {}


for vdt in (torch.float32, torch.float64):
    for idt in (torch.int8, torch.int32):
        main = vdt == torch.float32 and idt == eng_full.gather_idx.dtype
        gidx = eng_full.gather_idx.to(idt)
        starts = eng_full.gather_starts

        # K1 lane_gather_cm: exactly equal (values are moved, not computed)
        values = torch.randn((C, p.R, 128), dtype=vdt, device=DEV,
                             generator=gen)
        out = K.lane_gather_cm(values, starts, gidx, wr=wg, n_ch=C * V_)
        torch.cuda.synchronize()
        ref = K.lane_gather_cm_plain(values, starts, gidx, wr=wg,
                                     n_ch=C * V_)
        err = float((out - ref).abs().max())
        check(torch.equal(out, ref), f"lane_gather_cm {vdt} {idt}: {err}")
        if main:
            ms_r = median_ms(lambda: K.lane_gather_cm(
                values, starts, gidx, wr=wg, n_ch=C * V_), 20)
            pms = time_ms(lambda: K.lane_gather_cm_plain(
                values, starts, gidx, wr=wg, n_ch=C * V_), 3)
            # library yardstick: one torch.gather over int64 global
            # indices (expanded outside the timing; -1 -> an appended 0)
            ii = gidx.to(torch.int64)
            lane = torch.arange(128, device=DEV)
            flat = (starts.to(torch.int64).view(G, 1, 1, 1) + ii) * 128 + lane
            flat = torch.where(ii >= 0, flat, torch.full_like(flat, p.R * 128))
            flat = flat.permute(1, 0, 2, 3).reshape(1, -1).expand(C, -1)
            vext = torch.cat([values.reshape(C, -1),
                              values.new_zeros((C, 1))], dim=1)
            lib = torch.gather(vext, 1, flat).reshape(C, V_, G, kc, 128) \
                .permute(1, 0, 2, 3, 4).reshape(V_ * C, G, kc, 128)
            check(torch.equal(lib, ref), "gather yardstick disagrees")
            lms = time_ms(lambda: torch.gather(vext, 1, flat), 10)
            # the 128-byte lines a warp load touches where the lanes gather
            # straight from global memory, per load and in all
            lpw, lines = GB.lines_per_warp_load(starts, gidx, wg, p.R)
            record("lane_gather_cm", err, ms_r[0], pms,
                   nbytes(values, starts, gidx, out), lms, ms_range=ms_r,
                   lines_per_warp_load=lpw, direct_load_lines=lines * C,
                   geometry=K.gather_cm_geometry(
                       C, V_, wg, kc, values.element_size(),
                       gidx.element_size()))
            del flat, vext, lib, ii
        else:
            record("lane_gather_cm", err, None, None, None, None)

        # K2 lane_scatter_cm: the kernel keeps the plain version's order of
        # additions (v-outer, k-inner), so the tolerance is 0: exactly equal
        src = torch.randn((V_ * C, G, kc, 128), dtype=vdt, device=DEV,
                          generator=gen)
        out = K.lane_scatter_cm(src, gidx, k_out=wg, n_ch=C)
        torch.cuda.synchronize()
        ref = K.lane_scatter_cm_plain(src, gidx, k_out=wg, n_ch=C)
        err = float((out - ref).abs().max())
        check(torch.equal(out, ref), f"lane_scatter_cm {vdt} {idt}: {err}")
        if main:
            ms = time_ms(lambda: K.lane_scatter_cm(
                src, gidx, k_out=wg, n_ch=C), 20)
            pms = time_ms(lambda: K.lane_scatter_cm_plain(
                src, gidx, k_out=wg, n_ch=C), 2)
            # library yardstick: one index_add_ (float atomics, so only
            # close to the kernel, not equal) over int64 global indices
            ii = gidx.to(torch.int64)
            lane = torch.arange(128, device=DEV)
            tt = torch.arange(G, device=DEV).view(G, 1, 1, 1)
            dest = (tt * wg + ii) * 128 + lane
            dest = torch.where(ii >= 0, dest, torch.full_like(dest, p.R * 128))
            dest = dest.permute(1, 0, 2, 3).reshape(-1)  # (V*G*kc*128,)
            s2 = src.reshape(V_, C, -1).permute(0, 2, 1).reshape(-1, C) \
                .contiguous()
            acc = torch.zeros((p.R * 128 + 1, C), dtype=vdt, device=DEV)
            acc.index_add_(0, dest, s2)
            lib = acc[:-1].T.reshape(C, G, wg, 128)
            check(float((lib - ref).abs().max()) <= 1e-4 * float(
                ref.abs().max()), "index_add_ yardstick disagrees")
            lms = time_ms(lambda: acc.index_add_(0, dest, s2), 10)
            record("lane_scatter_cm", err, ms, pms, nbytes(src, gidx, out),
                   lms)
            del dest, s2, acc, lib, ii
        else:
            record("lane_scatter_cm", err, None, None, None, None)
        del src

        # K3 lane_pass_update: owner-sum (head, +shifts) and refresh (tail
        # rows SET, negated shifts); exactly equal (sum in pass order)
        for head in (True, False):
            if head:
                st, ix = eng_full._owner_starts, eng_full._owner_idx.to(idt)
                wrs, sh = eng_full.owner_wrs, eng_full.owner_shifts
            else:
                st, ix = eng_full._refresh_starts, eng_full._refresh_idx.to(idt)
                wrs = eng_full.refresh_wrs
                sh = tuple(-s for s in eng_full.refresh_shifts)
            kw = dict(wrs=wrs, wg=wg, shifts=sh, head=head)
            out = K.lane_pass_update(values, st, ix, **kw)
            torch.cuda.synchronize()
            ref = K.lane_pass_update_plain(values, st, ix, **kw)
            err = float((out - ref).abs().max())
            check(torch.equal(out, ref),
                  f"lane_pass_update head={head} {vdt} {idt}: {err}")
            if main:
                ms_r = median_ms(
                    lambda: K.lane_pass_update(values, st, ix, **kw), 20)
                pms = time_ms(lambda: K.lane_pass_update_plain(
                    values, st, ix, **kw), 3)
                b = nbytes(values, st, ix, out)
                geo = K.pass_update_geometry(
                    C, ix.shape[2], tuple(wrs), values.element_size(),
                    ix.element_size())
                geo = dict(wt=geo["wt"], units=len(geo["units"]),
                           groups=geo["groups"], smem=geo["smem"])
                if head:
                    record("lane_pass_update", err, ms_r[0], pms, b, None,
                           ms_range=ms_r, geometry=geo)
                else:
                    results["lane_pass_update"].update(
                        refresh_ms=ms_r[0], refresh_ms_range=ms_r,
                        refresh_plain_ms=pms,
                        refresh_bound_ms=b / HBM_BYTES_PER_S * 1e3,
                        refresh_geometry=geo)
                    record("lane_pass_update", err, None, None, None, None)
            else:
                record("lane_pass_update", err, None, None, None, None)
        del out, ref

        # K4 lane_fused_elem: one state (element gradient) and two states
        # (Hessian-vector product), both hand-written laws, on the engine's
        # own geometry and coefficient rows. The state is of the size of a
        # displacement; its first rows are zero, so whole bins sit on the
        # degenerate branch (zero strain), as at the start of a solve.
        # Both spell the same operations in the same order, the library is
        # built without fused multiply-adds and the scatter adds in the
        # plain order: exactly equal. The main-path variant is also timed
        # in each block layout the kernel has (the wrapper takes the first
        # of K.FUSED_CONFIGS that fits).
        u4 = 1e-3 * values
        u4[:, : p.R // 8] = 0.0
        v4 = torch.randn((C, p.R, 128), dtype=vdt, device=DEV, generator=gen)
        geom4 = eng_full.fused_geom.to(vdt)
        cd4 = cc_full["_cd"].to(vdt)
        for law in (eng_full.fused_law, LAW_ELASTIC):
            for states in ((u4,), (u4, v4)):
                kw = dict(wr=wg, nv=V_)
                args = (states, starts, gidx, (geom4, cd4), law)
                out = K.lane_fused_elem(*args, **kw)
                torch.cuda.synchronize()
                ref = K.lane_fused_elem_plain(*args, **kw)
                check(out.shape == (G, C, wg, 128)
                      and out.permute(1, 0, 2, 3).is_contiguous(),
                      "lane_fused_elem: output layout")
                check(bool(torch.isfinite(out).all()),
                      "lane_fused_elem: non-finite output")
                err = float((out - ref).abs().max())
                tag = f"{law.name}/{len(states)}/{vdt}/{idt}"
                k4_rel[tag] = err / float(ref.abs().max())
                check(torch.equal(out, ref), f"lane_fused_elem {tag}: {err}")
                if main and law is eng_full.fused_law:
                    ms_r = median_ms(lambda: K.lane_fused_elem(*args, **kw),
                                     20)
                    pms = time_ms(
                        lambda: K.lane_fused_elem_plain(*args, **kw), 2)
                    geo = K.fused_elem_geometry(
                        len(states), wg, law.rows_needed(),
                        states[0].element_size(), gidx.element_size(),
                        K.FUSED_CONFIGS)
                    by_layout = {}
                    for cfg in K.FUSED_CONFIGS:
                        K.FUSED_CONFIGS, keep = (cfg,), K.FUSED_CONFIGS
                        try:
                            o_lb = K.lane_fused_elem(*args, **kw)
                            check(torch.equal(o_lb, ref),
                                  f"lane_fused_elem {tag} layout {cfg}")
                            by_layout[str(cfg)] = median_ms(
                                lambda: K.lane_fused_elem(*args, **kw), 20)[0]
                        finally:
                            K.FUSED_CONFIGS = keep
                    b = nbytes(*states, starts, gidx, geom4, cd4, out)
                    flops = K4_FLOPS_PER_CELL[len(states)] * G * kc * 128
                    b_ms = b / HBM_BYTES_PER_S * 1e3
                    f_ms = flops / F32_FLOPS_PER_S * 1e3
                    if len(states) == 1:
                        record("lane_fused_elem", err, ms_r[0], pms, b, None,
                               flops=flops, ops_bound_ms=f_ms,
                               ms_range=ms_r, geometry=geo,
                               ms_by_layout=by_layout)
                        results["lane_fused_elem"].update(
                            bound_ms=max(b_ms, f_ms),
                            bound_by="bytes" if b_ms >= f_ms
                            else "operations")
                    else:
                        results["lane_fused_elem"].update(
                            jvp_ms=ms_r[0], jvp_ms_range=ms_r,
                            jvp_plain_ms=pms,
                            jvp_bound_ms=max(b_ms, f_ms), jvp_bound_bytes=b,
                            jvp_flops=flops, jvp_geometry=geo,
                            jvp_ms_by_layout=by_layout)
                        record("lane_fused_elem", err, None, None, None, None)
                else:
                    record("lane_fused_elem", err, None, None, None, None)
                del out, ref
        del values, u4, v4, geom4, cd4

# K5 lane_gather_weighted: the two-level restriction (fine lane vector ->
# coarse view rows; int32 indices, the window is 288 rows) and
# prolongation (view rows -> fine bins; int8 indices, also widened to
# int32) tables of the n = 1024 engine. The kernel sums v ascending as the
# plain version does and the library is built without fused
# multiply-adds: the tolerance is 0, exactly equal.
K5_CASES = {
    "restrict": (tl_geo["r_starts"], tl_geo["r_idx"], tl_geo["r_wts"],
                 (C, p.R, 128), tl_static.WRr, (torch.int32,)),
    "prolong": (tl_geo["p_starts"], tl_geo["p_idx"], tl_geo["p_wts"],
                (C, tl_static.Rv, 128), tl_static.WRp,
                (torch.int8, torch.int32)),
}
for vdt in (torch.float32, torch.float64):
    for which, (st5, ix5, w5, vshape, wr5, idts) in K5_CASES.items():
        for idt in idts:
            main = vdt == torch.float32 and idt == ix5.dtype
            vals = torch.randn(vshape, dtype=vdt, device=DEV, generator=gen)
            ix, w = ix5.to(idt), w5.to(vdt)
            args = (vals, st5, ix, w)
            out = K.lane_gather_weighted(*args, wr=wr5)
            torch.cuda.synchronize()
            ref = K.lane_gather_weighted_plain(*args, wr=wr5)
            err = float((out - ref).abs().max())
            check(out.shape == ref.shape and torch.equal(out, ref),
                  f"lane_gather_weighted {which} {vdt} {idt}: {err}")
            check(out.permute(1, 0, 2, 3).is_contiguous(),
                  "lane_gather_weighted: output layout")
            if not main:
                record("lane_gather_weighted", err, None, None, None, None)
                continue
            ms_r = median_ms(lambda: K.lane_gather_weighted(*args, wr=wr5), 20)
            ms = ms_r[0]
            pms = time_ms(lambda: K.lane_gather_weighted_plain(*args, wr=wr5),
                          3)
            lpw, lines = GB.lines_per_warp_load(st5, ix, wr5, vshape[1])
            geo5 = K.gather_weighted_geometry(C, ix.shape[1], wr5,
                                              ix.shape[2], vals.element_size(),
                                              ix.element_size())
            b = nbytes(vals, st5, ix, w, out)
            # yardstick (two PyTorch calls, not one: no library_ms): a
            # torch.gather over int64 global indices expanded outside the
            # timing (-1 -> an appended 0), then the weighted sum over v
            T5, V5, K5, _ = ix.shape
            ii = ix.to(torch.int64)
            lane = torch.arange(128, device=DEV)
            flat = (st5.to(torch.int64).view(T5, 1, 1, 1) + ii) * 128 + lane
            flat = torch.where(ii >= 0, flat,
                               torch.full_like(flat, vshape[1] * 128))
            flat = flat.reshape(1, -1).expand(C, -1)
            vext = torch.cat([vals.reshape(C, -1), vals.new_zeros((C, 1))], 1)

            def gather_sum():
                g = torch.gather(vext, 1, flat).reshape(C, T5, V5, K5, 128)
                return (g * w).sum(2)

            yard = gather_sum().permute(1, 0, 2, 3)
            check(float((yard - ref).abs().max())
                  <= 1e-5 * float(ref.abs().max()),
                  "gather-sum yardstick disagrees")
            yms = time_ms(gather_sum, 10)
            del flat, vext, ii, yard
            if which == "restrict":
                record("lane_gather_weighted", err, ms, pms, b, None,
                       gather_sum_yardstick_ms=yms, shape="restrict",
                       idx_dtype=str(idt), ms_range=ms_r,
                       lines_per_warp_load=lpw, direct_load_lines=lines * C,
                       geometry=geo5)
            else:
                results["lane_gather_weighted"].update(
                    prolong_ms=ms, prolong_ms_range=ms_r, prolong_plain_ms=pms,
                    prolong_bound_ms=b / HBM_BYTES_PER_S * 1e3,
                    prolong_bound_bytes=b,
                    prolong_gather_sum_yardstick_ms=yms,
                    prolong_lines_per_warp_load=lpw,
                    prolong_direct_load_lines=lines * C,
                    prolong_geometry=geo5)
                record("lane_gather_weighted", err, None, None, None, None)
            del out, ref, vals

# K9 lane_gather, K10 lane_scatter, K11 lane_scatter_weighted: no path of
# either package calls them. K9 at K1's tables (both modes), K10 at their
# transpose (each bin's V * kc cell slots as source rows, the bin window as
# destination), K11 as the adjoint of K5's prolongation tables. Exactly
# equal to the plain versions (moves, or sums in the plain order without
# fused multiply-adds).
SK10 = V_ * kc
k10_starts = torch.arange(G, dtype=torch.int32, device=DEV) * SK10
k11_starts = torch.arange(G, dtype=torch.int32, device=DEV) * wg
p_st, p_ix, p_w = tl_geo["p_starts"], tl_geo["p_idx"], tl_geo["p_wts"]
WRP, RV = tl_static.WRp, tl_static.Rv


def index_add_dest(dest, k_out, rows_per_bin):
    """int64 positions in a (T * k_out * 128 + 1) accumulator of every
    source entry of a (T, ..., rows_per_bin, 128) table (-1 -> the last)."""
    ii = dest.to(torch.int64)
    tt = torch.arange(dest.shape[0], device=DEV).view(
        -1, *([1] * (dest.dim() - 1)))
    lane = torch.arange(128, device=DEV)
    flat = (tt * k_out + ii) * 128 + lane
    return torch.where((ii >= 0) & (ii < k_out), flat,
                       torch.full_like(flat, dest.shape[0] * k_out * 128))


def bound_of(b, flops):
    b_ms = b / HBM_BYTES_PER_S * 1e3
    f_ms = flops / F32_FLOPS_PER_S * 1e3
    return max(b_ms, f_ms), "bytes" if b_ms >= f_ms else "operations"


for vdt in (torch.float32, torch.float64):
    for idt in (torch.int8, torch.int32):
        main = vdt == torch.float32 and idt == eng_full.gather_idx.dtype
        gidx = eng_full.gather_idx.to(idt)
        starts = eng_full.gather_starts
        values = torch.randn((C, p.R, 128), dtype=vdt, device=DEV,
                             generator=gen)
        # K9, per v and summed over v
        for sum_v in (False, True):
            kw = dict(wr=wg, sum_v=sum_v)
            out = K.lane_gather(values, starts, gidx, **kw)
            torch.cuda.synchronize()
            ref = K.lane_gather_plain(values, starts, gidx, **kw)
            err = float((out - ref).abs().max())
            check(out.shape == ref.shape and torch.equal(out, ref),
                  f"lane_gather sum_v={sum_v} {vdt} {idt}: {err}")
            if not main:
                record("lane_gather", err, None, None, None, None)
                continue
            ms_r = median_ms(
                lambda: K.lane_gather(values, starts, gidx, **kw), 20)
            ms = ms_r[0]
            dus = LB.device_us(
                lambda: K.lane_gather(values, starts, gidx, **kw), 20,
                "lane_gather_kernel")
            dms = None if dus is None else dus / 1e3
            pms = time_ms(lambda: K.lane_gather_plain(values, starts, gidx,
                                                      **kw), 3)
            b = nbytes(values, starts, gidx, out)
            n_valid = int((gidx >= 0).sum()) * C
            if not sum_v:
                # yardstick: one torch.gather over int64 global indices
                # expanded outside the timing (-1 -> an appended 0)
                ii = gidx.to(torch.int64)
                lane = torch.arange(128, device=DEV)
                flat = (starts.to(torch.int64).view(G, 1, 1, 1) + ii) * 128 \
                    + lane
                flat = torch.where(ii >= 0, flat,
                                   torch.full_like(flat, p.R * 128))
                flat = flat.reshape(1, -1).expand(C, -1)
                vext = torch.cat([values.reshape(C, -1),
                                  values.new_zeros((C, 1))], dim=1)
                lib = torch.gather(vext, 1, flat).reshape(C, G, V_, kc, 128)
                check(torch.equal(lib.permute(1, 0, 2, 3, 4), ref),
                      "lane_gather yardstick disagrees")
                lms = median_ms(lambda: torch.gather(vext, 1, flat), 10)[0]
                record("lane_gather", err, ms, pms, b, lms, ms_range=ms_r,
                       device_ms=dms, geometry=K.gather_geometry(
                           C, V_, wg, kc, values.element_size(),
                           gidx.element_size()))
                del flat, vext, lib, ii
            else:
                bms, by = bound_of(b, n_valid)
                results["lane_gather"].update(
                    sum_v_ms=ms, sum_v_ms_range=ms_r, sum_v_plain_ms=pms,
                    sum_v_bound_ms=bms, sum_v_bound_by=by,
                    sum_v_device_ms=dms)
                record("lane_gather", err, None, None, None, None)
        del values
        # K10 at the transpose of K1's tables
        didx = gidx.reshape(G, SK10, 128)
        src = torch.randn((C, G * SK10, 128), dtype=vdt, device=DEV,
                          generator=gen)
        kw = dict(sk=SK10, k_out=wg)
        out = K.lane_scatter(src, k10_starts, didx, **kw)
        torch.cuda.synchronize()
        ref = K.lane_scatter_plain(src, k10_starts, didx, **kw)
        err = float((out - ref).abs().max())
        check(out.shape == (G, C, wg, 128) and torch.equal(out, ref),
              f"lane_scatter {vdt} {idt}: {err}")
        if main:
            ms_r = median_ms(
                lambda: K.lane_scatter(src, k10_starts, didx, **kw), 20)
            ms = ms_r[0]
            pms = time_ms(lambda: K.lane_scatter_plain(src, k10_starts,
                                                       didx, **kw), 2)
            # yardstick: one index_add_ (float atomics: close, not equal)
            dest = index_add_dest(didx, wg, SK10).reshape(-1)
            s2 = src.reshape(C, -1).T.contiguous()  # (G*SK10*128, C)
            acc = torch.zeros((G * wg * 128 + 1, C), dtype=vdt, device=DEV)
            acc.index_add_(0, dest, s2)
            lib = acc[:-1].reshape(G, wg, 128, C).permute(0, 3, 1, 2)
            check(float((lib - ref).abs().max())
                  <= 1e-4 * float(ref.abs().max()),
                  "lane_scatter yardstick disagrees")
            lms = median_ms(lambda: acc.index_add_(0, dest, s2), 10)[0]
            bms, by = bound_of(nbytes(src, k10_starts, didx, out),
                               int((didx >= 0).sum()) * C)
            record("lane_scatter", err, ms, pms,
                   nbytes(src, k10_starts, didx, out), lms, ms_range=ms_r)
            results["lane_scatter"].update(bound_ms=bms, bound_by=by)
            del dest, s2, acc, lib
        else:
            record("lane_scatter", err, None, None, None, None)
        del src, out, ref
        # K11 on K5's prolongation tables (the adjoint direction)
        ix11, w11 = p_ix.to(idt), p_w.to(vdt)
        src = torch.randn((C, G * wg, 128), dtype=vdt, device=DEV,
                          generator=gen)
        kw = dict(sk=wg, k_out=WRP, n_dest=ix11.shape[1])
        out = K.lane_scatter_weighted(src, k11_starts, ix11, w11, **kw)
        torch.cuda.synchronize()
        ref = K.lane_scatter_weighted_plain(src, k11_starts, ix11, w11, **kw)
        err = float((out - ref).abs().max())
        check(out.shape == (G, C, WRP, 128) and torch.equal(out, ref),
              f"lane_scatter_weighted {vdt} {idt}: {err}")
        if main:
            args11 = (src, k11_starts, ix11, w11)
            ms_r = median_ms(lambda: K.lane_scatter_weighted(*args11, **kw),
                             20)
            ms = ms_r[0]
            dus = LB.device_us(lambda: K.lane_scatter_weighted(*args11, **kw),
                               20, "lane_scatter_weighted_kernel")
            pms = time_ms(lambda: K.lane_scatter_weighted_plain(*args11,
                                                                **kw), 2)
            # yardstick (two PyTorch calls, not one: no library_ms): the
            # products, then one index_add_ of them
            dest = index_add_dest(ix11, WRP, wg).reshape(-1)
            src_t = src.view(C, G, 1, wg, 128).permute(1, 2, 3, 4, 0) \
                .contiguous()  # (G, 1, wg, 128, C)
            acc = torch.zeros((G * WRP * 128 + 1, C), dtype=vdt, device=DEV)

            def mul_index_add():
                prod = w11.unsqueeze(-1) * src_t  # (G, D, wg, 128, C)
                return acc.index_add_(0, dest, prod.view(-1, C))

            mul_index_add()
            lib = acc[:-1].reshape(G, WRP, 128, C).permute(0, 3, 1, 2)
            check(float((lib - ref).abs().max())
                  <= 1e-4 * float(ref.abs().max()),
                  "lane_scatter_weighted yardstick disagrees")
            yms = median_ms(mul_index_add, 10)[0]
            b = nbytes(*args11, out)
            bms, by = bound_of(b, 2 * int((ix11 >= 0).sum()) * C)
            record("lane_scatter_weighted", err, ms, pms, b, None,
                   mul_index_add_yardstick_ms=yms, ms_range=ms_r,
                   device_ms=None if dus is None else dus / 1e3,
                   geometry=K.scatter_weighted_geometry(
                       C, ix11.shape[1], wg, WRP, src.element_size(),
                       ix11.element_size()))
            results["lane_scatter_weighted"].update(bound_ms=bms,
                                                    bound_by=by)
            del dest, src_t, acc, lib
        else:
            record("lane_scatter_weighted", err, None, None, None, None)
        del src, out, ref
# K11 is K5's transpose: <K5(x), y> = <x, K11(y)>, K11's bin windows placed
# at K5's window starts; float64 on the card, rel <= 1e-12
x5 = torch.randn((C, RV, 128), dtype=torch.float64, device=DEV, generator=gen)
y5 = torch.randn((G, C, wg, 128), dtype=torch.float64, device=DEV,
                 generator=gen)
w5 = p_w.to(torch.float64)
lhs = float(torch.sum(K.lane_gather_weighted(x5, p_st, p_ix, w5, wr=WRP)
                      * y5))
back = K.lane_scatter_weighted(
    y5.permute(1, 0, 2, 3).reshape(C, G * wg, 128).contiguous(), k11_starts,
    p_ix, w5, sk=wg, k_out=WRP, n_dest=p_ix.shape[1])
rows5 = p_st.to(torch.int64).view(G, 1) + torch.arange(WRP, device=DEV)
win5 = x5[:, rows5.clamp(max=RV - 1)].permute(1, 0, 2, 3)
win5 = torch.where((rows5 < RV).view(G, 1, WRP, 1), win5, 0.0)
rhs = float(torch.sum(win5 * back))
adjoint_rel = abs(lhs - rhs) / abs(lhs)
check(adjoint_rel <= 1e-12, f"K11 is not K5's adjoint: rel {adjoint_rel}")
shapes.update(k9_idx=list(eng_full.gather_idx.shape),
              k10=dict(src=[C, G * SK10, 128], dest_idx=[G, SK10, 128],
                       sk=SK10, k_out=wg),
              k11=dict(src=[C, G * wg, 128], dest_idx=list(p_ix.shape),
                       idx_dtype=str(p_ix.dtype), sk=wg, k_out=WRP))
del x5, y5, w5, back, win5, rows5

# K3 / K4 at edge shapes, exactly equal to their plain versions in float32
# and float64, with int8 and int32 indices, both K3 modes, both K4 laws and
# modes: the n = 256 plan's tables; K not a multiple of the thread rows (4
# cells a round in K4, 32 updated rows a block in K3) or of a lane split;
# P = 1; windows that reach past the last row of R (clamped); an int8
# window of 126 rows (float64 K4 then takes 16 lane columns a block, K3
# tiles the window)
mesh_small = polycrystal.generate_polycrystal(N_SMALL, n_grains=200)
F_256, bcs_256, _, _ = damage_problem(mesh_small, torch.float32, True)
eng_256 = LaneEngine(F_256, bcs_256, wg_own=16, fused=True, device=DEV,
                     dtype=torch.float32)
E_256, d_256 = cg_profile.case_inputs(mesh_small)
cd_256 = eng_256.prepare_coeffs({"d": d_256, "E": E_256})["_cd"]
edge_rng = np.random.default_rng(6)
IDX_NP = {torch.int8: np.int8, torch.int32: np.int32}


def on_card(a, dtype=None):
    return torch.as_tensor(a, device=DEV, dtype=dtype)


def k3_edge(tag, st, ix, wrs, wg_, sh):
    for vdt in (torch.float32, torch.float64):
        values = torch.randn((C, st.shape[1] * wg_, 128), dtype=vdt,
                             device=DEV, generator=gen)
        for idt in (torch.int8, torch.int32):
            for head in (True, False):
                kw = dict(wrs=wrs, wg=wg_, shifts=sh, head=head)
                out = K.lane_pass_update(values, st, ix.to(idt), **kw)
                torch.cuda.synchronize()
                ref = K.lane_pass_update_plain(values, st, ix.to(idt), **kw)
                check(torch.equal(out, ref), f"lane_pass_update {tag} "
                      f"head={head} {vdt} {idt}: "
                      f"{float((out - ref).abs().max())}")


def k4_edge(tag, st, ix, geom_, cd_, R_, wr_):
    laws = (K.FusedLaw("asym_damage", NU, E=(3, 1), d=(0, 3)),
            K.FusedLaw("linear_elastic", NU, E=(3, 1)))
    for vdt in (torch.float32, torch.float64):
        u_ = 1e-3 * torch.randn((C, R_, 128), dtype=vdt, device=DEV,
                                generator=gen)
        v_ = torch.randn((C, R_, 128), dtype=vdt, device=DEV, generator=gen)
        cds = (geom_.to(vdt), cd_.to(vdt))
        for idt in (torch.int8, torch.int32):
            for law in laws:
                for states in ((u_,), (u_, v_)):
                    a = (states, st, ix.to(idt), cds, law)
                    out = K.lane_fused_elem(*a, wr=wr_, nv=3)
                    torch.cuda.synchronize()
                    ref = K.lane_fused_elem_plain(*a, wr=wr_, nv=3)
                    check(torch.equal(out, ref), f"lane_fused_elem {tag} "
                          f"{law.name}/{len(states)} {vdt} {idt}: "
                          f"{float((out - ref).abs().max())}")


k3_edge("n=256 owner-sum/refresh", eng_256._owner_starts, eng_256._owner_idx,
        eng_256.owner_wrs, eng_256.plan.wg, eng_256.owner_shifts)
k3_edge("n=256 refresh tables", eng_256._refresh_starts,
        eng_256._refresh_idx, eng_256.refresh_wrs, eng_256.plan.wg,
        tuple(-s for s in eng_256.refresh_shifts))
k4_edge("n=256", eng_256.gather_starts, eng_256.gather_idx,
        eng_256.fused_geom, cd_256, eng_256.plan.R, eng_256.plan.wg)
K3_EDGES = {  # tag: (bins, wg, K, window heights, window to the last row)
    "K=13, P=3": (37, 40, 13, (3, 19, 7), False),
    "K=37 (two row groups)": (9, 50, 37, (5, 9), False),
    "P=1": (11, 40, 16, (11,), False),
    "window past the last row": (7, 40, 16, (6, 12), True),
    "int8 window of 126 rows": (5, 130, 24, (126, 120), False),
}
for tag, (T_, wg_, K_, wrs_, last) in K3_EDGES.items():
    R_ = T_ * wg_
    st_ = edge_rng.integers(0, R_ - max(wrs_) + 1, size=(len(wrs_), T_))
    if last:
        st_[:, -1] = R_ - 3
    ix_ = np.stack([edge_rng.integers(-1, w + 1, size=(T_, K_, 128))
                    for w in wrs_])
    sh_ = tuple(int(x) for x in edge_rng.integers(-300, 300, len(wrs_)))
    k3_edge(tag, on_card(st_, torch.int32), on_card(ix_.astype(np.int8)),
            wrs_, wg_, sh_)
K4_EDGES = {  # tag: (bins, K, wr, window to the last row)
    "K=13": (37, 13, 40, False),
    "K=1": (5, 1, 9, False),
    "window past the last row": (7, 16, 40, True),
    "int8 window of 126 rows": (4, 32, 126, False),
}
for tag, (T_, K_, wr_, last) in K4_EDGES.items():
    R_ = T_ * wr_ + 5
    st_ = edge_rng.integers(0, R_ - wr_ + 1, size=T_)
    if last:
        st_[-1] = R_ - wr_ // 2
    ix_ = edge_rng.integers(-1, wr_ + 1, size=(T_, 3, K_, 128))
    geom_ = edge_rng.standard_normal((T_, 7, K_, 128))
    geom_[:, 6] = np.abs(geom_[:, 6])
    cd_ = edge_rng.random((T_, 4, K_, 128))
    cd_[:, 3] = 1e6 * (1.0 + cd_[:, 3])
    k4_edge(tag, on_card(st_, torch.int32), on_card(ix_.astype(np.int8)),
            on_card(geom_), on_card(cd_), R_, wr_)
# K1 / K5 at edge shapes, exactly equal to their plain versions in float32
# and float64 with int8 and int32 indices: one bin; K not a multiple of the
# block's thread rows (8 or 16); wr not a multiple of 8; windows that run past
# the last row, one with R < wr; a window that starts at the last row (K1
# clamps, K5 adds nothing); indices of -1 and of wr and above; C = 1 and
# C = 4 (K5 takes at most 4); K5 with its tables staged and in registers
# (each path in float32 and float64)
GATHER_EDGES = {  # tag: (bins, V, K, wr, R, C, start of the last bin)
    "T=1": (1, 3, 32, 40, 40, 2, None),
    "K=17": (9, 3, 17, 40, 400, 2, None),
    "K=1, wr=13": (7, 4, 1, 13, 120, 2, None),
    "R < wr, K=40": (3, 4, 40, 72, 50, 2, 47),
    "C=1, V=24, window past the last row": (11, 24, 16, 45, 300, 1, 280),
    "C=4, K=21, wr=37": (11, 5, 21, 37, 300, 4, 300),
    "int8 window of 126 rows": (5, 3, 45, 126, 700, 2, 650),
    "K5 tables in registers, K=40": (3, 24, 40, 200, 250, 2, 240),
}
k5_paths = set()
for tag, (T_, V_e, K_, wr_, R_, C_, last) in GATHER_EDGES.items():
    st_ = edge_rng.integers(0, max(R_ - wr_, 0) + 1, size=T_)
    if last is not None:
        st_[-1] = last
    ix_ = edge_rng.integers(-1, min(wr_ + 2, 127) + 1, size=(T_, V_e, K_, 128))
    w_ = edge_rng.standard_normal((T_, V_e, K_, 128))
    st_ = on_card(st_, torch.int32)
    for vdt in (torch.float32, torch.float64):
        vals_ = torch.randn((C_, R_, 128), dtype=vdt, device=DEV,
                            generator=gen)
        for idt in (torch.int8, torch.int32):
            ix_t = on_card(ix_.astype(IDX_NP[idt]))
            out = K.lane_gather_cm(vals_, st_, ix_t, wr=wr_, n_ch=C_ * V_e)
            torch.cuda.synchronize()
            ref = K.lane_gather_cm_plain(vals_, st_, ix_t, wr=wr_,
                                         n_ch=C_ * V_e)
            check(torch.equal(out, ref), f"lane_gather_cm {tag} {vdt} {idt}: "
                  f"{float((out - ref).abs().max())}")
            k5_paths.add((str(vdt), K.gather_weighted_geometry(
                C_, V_e, wr_, K_, vals_.element_size(),
                ix_t.element_size())["tiles"]))
            out = K.lane_gather_weighted(vals_, st_, ix_t, on_card(w_, vdt),
                                         wr=wr_)
            torch.cuda.synchronize()
            ref = K.lane_gather_weighted_plain(vals_, st_, ix_t,
                                               on_card(w_, vdt), wr=wr_)
            check(out.shape == ref.shape and torch.equal(out, ref),
                  f"lane_gather_weighted {tag} {vdt} {idt}: "
                  f"{float((out - ref).abs().max())}")
check(len(k5_paths) == 4,
      f"K5 edge shapes: {k5_paths}: not both paths in both dtypes")
k5_paths = sorted(k5_paths)
# K9 (both modes) / K11 at edge shapes, exactly equal to their plain
# versions in float32 and float64 with int8 and int32 indices: K not a
# multiple of the thread rows; D = 1; k_out = 1 and k_out at the first K11's
# limit (k_out * 128 values in 227 KB: channel groups); windows that run
# past R or S, and ones that start past the end (a row past the end gives
# or adds nothing); indices of -1 and past wr or k_out; an int8 window of
# 126 rows; K9 with a window too large to stage (read from global memory),
# K11 with D too large to stage its tables and with its window in chunks
# (as float64 / int32 takes the n = 1024 tables)
K9_EDGES = {  # tag: (bins, V, K, wr, R, C, start of the last bin)
    "K=17": (9, 3, 17, 40, 400, 2, None),
    "window past R": (7, 3, 21, 40, 300, 2, 280),
    "window starts past the end": (5, 4, 9, 13, 120, 2, 130),
    "C=1, V=24": (11, 24, 16, 45, 300, 1, None),
    "int8 window of 126 rows": (5, 3, 45, 126, 700, 2, 650),
    "window read from global memory": (3, 2, 5, 2000, 2100, 4, 1500),
}
K11_EDGES = {  # tag: (bins, C, D, sk, k_out, S, start of the last bin)
    "D=1, sk=13": (9, 2, 1, 13, 21, 200, None),
    "k_out=1": (7, 2, 4, 9, 1, 100, None),
    "k_out at the first design's limit": (3, 2, 4, 40, None, 200, None),
    "window past S": (7, 3, 3, 40, 30, 200, 185),
    "window starts past the end": (5, 2, 4, 20, 30, 100, 110),
    "int8 window of 126 rows": (4, 2, 2, 126, 50, 600, None),
    "tables not staged (D=600)": (2, 1, 600, 3, 5, 20, None),
}
k9_paths, k11_paths = set(), set()
for tag, (T_, V_e, K_, wr_, R_, C_, last) in K9_EDGES.items():
    st_ = edge_rng.integers(0, max(R_ - wr_, 0) + 1, size=T_)
    if last is not None:
        st_[-1] = last
    # int32 indices over the whole window and past it; int8 ones clamped
    ix_ = edge_rng.integers(-1, wr_ + 3, size=(T_, V_e, K_, 128))
    st_ = on_card(st_, torch.int32)
    for vdt in (torch.float32, torch.float64):
        vals_ = torch.randn((C_, R_, 128), dtype=vdt, device=DEV,
                            generator=gen)
        for idt in (torch.int8, torch.int32):
            ix_t = on_card((np.minimum(ix_, 127) if idt == torch.int8
                            else ix_).astype(IDX_NP[idt]))
            k9_paths.add(K.check_gather(vals_, st_, ix_t, wr=wr_)["tiles"])
            for sum_v in (False, True):
                out = K.lane_gather(vals_, st_, ix_t, wr=wr_, sum_v=sum_v)
                torch.cuda.synchronize()
                ref = K.lane_gather_plain(vals_, st_, ix_t, wr=wr_,
                                          sum_v=sum_v)
                check(out.shape == ref.shape and torch.equal(out, ref),
                      f"lane_gather {tag} sum_v={sum_v} {vdt} {idt}: "
                      f"{float((out - ref).abs().max())}")
for tag, (T_, C_, D_, sk_, k_out_, S_, last) in K11_EDGES.items():
    st_ = edge_rng.integers(0, max(S_ - sk_, 0) + 1, size=T_)
    if last is not None:
        st_[-1] = last
    st_ = on_card(st_, torch.int32)
    for vdt in (torch.float32, torch.float64):
        # the first design took k_out * 128 values in 227 KB
        ko = k_out_ or K.SMEM_PER_BLOCK // (128 * (4 if vdt == torch.float32
                                                   else 8))
        ix_ = edge_rng.integers(0, ko + 2, size=(T_, D_, sk_, 128))
        ix_[edge_rng.random(ix_.shape) < 0.2] = -1
        w_ = on_card(edge_rng.standard_normal(ix_.shape), vdt)
        src_ = torch.randn((C_, S_, 128), dtype=vdt, device=DEV,
                           generator=gen)
        for idt in (torch.int8, torch.int32):
            # int32 indices over every row of k_out and past it; int8
            # ones clamped
            ix_t = on_card((np.minimum(ix_, 127) if idt == torch.int8
                            else ix_).astype(IDX_NP[idt]))
            kw = dict(sk=sk_, k_out=ko, n_dest=D_)
            g11 = K.check_scatter_weighted(src_, st_, ix_t, w_, **kw)
            k11_paths.add((g11["tiles"], g11["chunks"] > 1,
                           g11["groups"] > 1))
            out = K.lane_scatter_weighted(src_, st_, ix_t, w_, **kw)
            torch.cuda.synchronize()
            ref = K.lane_scatter_weighted_plain(src_, st_, ix_t, w_, **kw)
            check(out.shape == ref.shape and torch.equal(out, ref),
                  f"lane_scatter_weighted {tag} {vdt} {idt}: "
                  f"{float((out - ref).abs().max())}")
# and the path float64 / int32 takes at the n = 1024 tables (above)
g11 = K.scatter_weighted_geometry(C, p_ix.shape[1], wg, WRP, 8, 4)
k11_paths.add((g11["tiles"], g11["chunks"] > 1, g11["groups"] > 1))
check(k9_paths == {True, False} and len(k11_paths) >= 4,
      f"K9 / K11 edge shapes: {k9_paths} / {k11_paths}: not every path")
shapes.update(k3_edges=dict(K3_EDGES, n256=dict(
    owner=list(eng_256._owner_idx.shape),
    refresh=list(eng_256._refresh_idx.shape))),
    k4_edges=dict(K4_EDGES, n256=list(eng_256.gather_idx.shape)),
    k1_k5_edges=GATHER_EDGES, k5_edge_paths=k5_paths, k9_edges=K9_EDGES,
    k11_edges=K11_EDGES,
    k11_edge_paths=[dict(zip(("tiles", "chunks", "groups"), p_))
                    for p_ in sorted(k11_paths)])
del eng_256, F_256, cd_256

emit("kernels", shapes=shapes, kernels=results, lane_fused_elem_rel_err=k4_rel,
     k11_adjoint_of_k5_rel=adjoint_rel,
     tolerance="exactly equal (0) for every kernel, K1, K3, K4, K5, K9 "
               "and K11 also at the edge shapes; K11 adjoint of K5 rel "
               "<= 1e-12 "
               "(float64)")
torch.cuda.empty_cache()

# -- 4. engine against the flat assembler (n = 64, float64) ---------------------

mesh_e = unit_square(N_ENGINE)
F_e, bcs_e, V_e, DS_e = damage_problem(mesh_e, torch.float64, False)
d_e = np.zeros(DS_e.n_dofs)
d_e[(DS_e.dof_coords[:, 1] > 0.45) & (DS_e.dof_coords[:, 1] < 0.55)] = 0.8
rng = np.random.default_rng(0)
u_e = 1e-3 * rng.standard_normal(V_e.n_dofs)
v_e = rng.standard_normal(V_e.n_dofs)
eng_e = LaneEngine(F_e, bcs_e, wg_own=8, device=DEV, dtype=torch.float64)
asm_e = Assembler(F_e, bcs_e)
cc_e = eng_e.prepare_coeffs({"d": d_e})
ct_e = {"d": torch.as_tensor(d_e, device=DEV)}
ut, vt = torch.as_tensor(u_e, device=DEV), torch.as_tensor(v_e, device=DEV)
ul, vl = eng_e.to_lane(u_e), eng_e.to_lane(v_e)
# Assembler.diagonal puts 1.0 on constrained dofs; compare the raw scatter
ed_flat = asm_e._r_plan.apply(torch.diagonal(
    asm_e.element_matrices(ut, ct_e), dim1=0, dim2=1).T.contiguous())
pairs = {
    "residual": (eng_e.residual(ul, cc_e), asm_e.residual(ut, ct_e)),
    "tangent_action": (eng_e.tangent_action(ul, cc_e, vl),
                       asm_e.tangent_action(ut, ct_e, vt)),
    "tangent_linearized": (eng_e.make_tangent(ul, cc_e)(vl),
                           asm_e.tangent_action(ut, ct_e, vt)),
    "diagonal": (eng_e.diagonal(ul, cc_e), ed_flat),
}
engine_out = {}
for name, (lane_val, flat_val) in pairs.items():
    got = eng_e.from_lane_dev(lane_val)
    rel = float((got - flat_val).abs().max() / flat_val.abs().max())
    check(rel <= 1e-12, f"engine {name}: rel {rel}")
    check(torch.equal(eng_e.refresh_copies(lane_val), lane_val),
          f"engine {name}: copy slots differ from their owners")
    check(torch.equal(eng_e.to_lane_dev(got), lane_val),
          f"engine {name}: lane state is not owner-consistent")
    engine_out[name] = rel
# the fused engine (same plan): residual and tangent action against the
# staged engine and the flat assembler, copies consistent
eng_f = LaneEngine(F_e, bcs_e, plan=eng_e.plan, fused=True, device=DEV,
                   dtype=torch.float64)
cf_e = eng_f.prepare_coeffs({"d": d_e})
K.reset_launch_counts()
fused_pairs = {
    "fused_residual": (eng_f.residual(ul, cf_e), pairs["residual"]),
    "fused_tangent_action": (eng_f.tangent_action(ul, cf_e, vl),
                             pairs["tangent_action"]),
    "fused_make_tangent": (eng_f.make_tangent(ul, cf_e)(vl),
                           pairs["tangent_action"]),
}
check(K.launch_counts()["lane_fused_elem"] == 3
      and K.launch_counts()["lane_gather_cm"] == 0,
      f"the fused engine did not run on the fused kernel alone: "
      f"{K.launch_counts()}")
for name, (lane_val, (staged_val, flat_val)) in fused_pairs.items():
    got = eng_f.from_lane_dev(lane_val)
    for other, ref in (("flat", flat_val),
                       ("staged", eng_e.from_lane_dev(staged_val))):
        rel = float((got - ref).abs().max() / ref.abs().max())
        check(rel <= 1e-12, f"engine {name} vs {other}: rel {rel}")
        engine_out[f"{name}_vs_{other}"] = rel
    check(torch.equal(eng_f.refresh_copies(lane_val), lane_val),
          f"engine {name}: copy slots differ from their owners")
# one two-level cycle on the card (K5, the selector products on the card,
# the lattice V-cycle) against the same cycle run by the plain versions on
# the CPU, staged and fused; float64, different summation orders in the
# matrix products and reductions: rel <= 1e-10
cpu = dict(device="cpu", dtype=torch.float64)
F_c = EnergyFunctional(F_e.space, F_e.terms, F_e.coefficients, **cpu)
eng_c = LaneEngine(F_c, bcs_e, plan=eng_e.plan, **cpu)
eng_cf = LaneEngine(F_c, bcs_e, plan=eng_e.plan, fused=True, **cpu)
r_e = rng.standard_normal(V_e.n_dofs)
tl_rel = {}
for tag, (eg, ec) in {"staged": (eng_e, eng_c),
                      "fused": (eng_f, eng_cf)}.items():
    out = []
    for eng in (eg, ec):
        cc = eng.prepare_coeffs({"d": d_e})
        st, data = TL.build_twolevel(eng, eng.bc_lane, cc, {"d": d_e})
        if eng is eg:
            K.reset_launch_counts()
        z = TL.precondition(eng, st, data, eng.bc_lane, cc, eng.free_lane,
                            eng.to_lane(r_e) * eng.free_lane)
        if eng is eg:
            torch.cuda.synchronize()
            check(K.launch_counts()["lane_gather_weighted"] == 2,
                  f"two-level cycle on the card: {K.launch_counts()}")
        out.append(eng.from_lane(z))
    rel = float(np.abs(out[0] - out[1]).max() / np.abs(out[1]).max())
    check(rel <= 1e-10, f"engine twolevel {tag}: card vs CPU rel {rel}")
    tl_rel[f"twolevel_precondition_{tag}_card_vs_cpu"] = rel
engine_out.update(tl_rel)
emit("engine", n=N_ENGINE, dtype="float64", rel_err=engine_out,
     fused_law=str(eng_f.fused_law),
     tolerance="1e-12 (engine vs assembler, fused vs staged); 1e-10 (one "
               "two-level cycle, card vs CPU)")
del eng_e, eng_f, asm_e, eng_c, eng_cf

# -- 5. small solve to convergence, staged and fused ------------------------------

# newton_rtol = 1e-5: in float32 the residual norm of this problem stops
# falling near 1e-6 * r0, so a tolerance at that floor is met or missed by
# rounding; one decade above it is met with room to spare
cfg_small = SolverConfig(cg_rtol=1e-8, newton_rtol=1e-5, cg_maxit=20000,
                         newton_maxit=10, preconditioner="jacobi")
cfg_small_tl = SolverConfig(cg_rtol=1e-8, newton_rtol=1e-5, cg_maxit=20000,
                            newton_maxit=10, preconditioner="twolevel")
small = {}
for tag, fused, cfg in (("staged", False, cfg_small),
                        ("fused", True, cfg_small),
                        ("fused_twolevel", True, cfg_small_tl)):
    t0 = time.perf_counter()
    res_s = polycrystal.run(N_SMALL, fused=fused, device=DEV, mesh=mesh_small,
                            solver=cfg)
    st = res_s.stats
    small[tag] = dict(
        converged=st["converged"], newton_iters=st["newton_iters"],
        cg_iters=st["cg_iters"], residuals=st["residuals"],
        final_residual=st["final_residual"], energy=res_s.energy,
        ms_per_cg_iter=1e3 * st["cg_seconds"] / max(st["total_cg_iters"], 1),
        seconds=time.perf_counter() - t0, timings=res_s.timings)
    check(st["converged"], f"solve_small {tag} did not converge")
    check(np.isfinite(res_s.energy) and np.isfinite(res_s.u_flat).all()
          and np.isfinite(res_s.stress).all(),
          f"solve_small {tag}: non-finite output")
    check(res_s.u_flat.shape == (res_s.n_dofs,), "solve_small: bad shape")
    uu = res_s.u_flat.reshape(-1, 2)
    check(np.allclose(uu[np.abs(res_s.mesh.x[:, 0] - 1) < 1e-9, 0], 0.01,
                      atol=1e-6), f"solve_small {tag}: Dirichlet values lost")
    small[tag]["u"] = res_s.u_flat
check(small["fused"]["newton_iters"] == small["staged"]["newton_iters"],
      "solve_small: fused and staged take different Newton counts")
u_st = small["staged"].pop("u")
u_rels = {}
for tag in ("fused", "fused_twolevel"):
    # all stop at newton_rtol = 1e-5 in float32: they agree to that order
    u_rels[tag] = float(np.abs(small[tag].pop("u") - u_st).max()
                        / np.abs(u_st).max())
    check(u_rels[tag] <= 1e-3, f"solve_small: {tag} vs staged u rel "
          f"{u_rels[tag]}")
    check(abs(small[tag]["energy"] - small["staged"]["energy"])
          <= 1e-4 * abs(small["staged"]["energy"]),
          f"solve_small: {tag} and staged energies differ")
JACOBI_CG_N256 = sum(small["fused"]["cg_iters"])
emit("solve_small", n=N_SMALL, n_dofs=res_s.n_dofs, dtype="float32",
     u_rel_vs_staged=u_rels,
     cg_total=dict(jacobi=JACOBI_CG_N256,
                   twolevel=sum(small["fused_twolevel"]["cg_iters"])),
     **small)
del res_s, mesh_small

# -- 6./7. full-width solve, staged and fused, each twice -------------------------

cfg_full = SolverConfig(cg_rtol=1e-8, newton_rtol=1e-6,
                        cg_maxit=FULL_CG_MAXIT,
                        newton_maxit=FULL_NEWTON_MAXIT,
                        preconditioner="jacobi")


def solve_full_twice(phase, fused, needed):
    """Two runs of the capped n = 1024 solve on the shared mesh and plan.
    The launch counts are set to 0 just before the first run and read
    just after it; every kernel in ``needed`` must have been launched.
    The second run must repeat the first bit for bit."""
    runs = []
    for i in range(2):
        if i == 0:
            K.reset_launch_counts()
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        r = polycrystal.run(N_FULL, n_grains=200, fused=fused, device=DEV,
                            mesh=mesh_full, plan=p, solver=cfg_full,
                            postprocess_fields=(i == 0))
        secs = time.perf_counter() - t0
        if i == 0:
            launches = K.launch_counts()
        runs.append((r, secs, torch.cuda.max_memory_allocated()))
    r0, r1 = runs[0][0], runs[1][0]
    s0 = r0.stats
    check(all(launches[k] > 0 for k in needed),
          f"{phase}: a kernel was not launched on the path: {launches}")
    check(s0["residuals"] == r1.stats["residuals"]
          and s0["final_residual"] == r1.stats["final_residual"]
          and s0["cg_iters"] == r1.stats["cg_iters"],
          f"{phase}: residual trajectory differs between two runs")
    check(np.array_equal(r0.u_flat, r1.u_flat),
          f"{phase}: solution differs bitwise between two runs")
    check(np.isfinite(r0.u_flat).all() and np.isfinite(r0.energy)
          and np.isfinite(r0.stress).all(), f"{phase}: non-finite output")
    check(r0.u_flat.shape == (2 * (N_FULL + 1) ** 2,), f"{phase}: bad shape")
    check(s0["residuals"][-1] < s0["residuals"][0]
          or s0["final_residual"] < s0["residuals"][0],
          f"{phase}: the residual did not decrease")
    out = dict(
        n=N_FULL, n_grains=200, n_dofs=r0.n_dofs, dtype="float32",
        fused=fused,
        caps=dict(newton_maxit=FULL_NEWTON_MAXIT, cg_maxit=FULL_CG_MAXIT),
        newton_iters=s0["newton_iters"], cg_iters=s0["cg_iters"],
        residuals=s0["residuals"], final_residual=s0["final_residual"],
        converged=s0["converged"], energy=r0.energy,
        ms_per_cg_iter=1e3 * s0["cg_seconds"] / max(s0["total_cg_iters"], 1),
        launches=launches, bitwise_equal_runs=True,
        seconds=[runs[0][1], runs[1][1]],
        peak_device_bytes=runs[0][2], timings=r0.timings)
    return r0, launches, out


r_staged, launches, out_staged = solve_full_twice(
    "solve_full", False,
    ("lane_gather_cm", "lane_scatter_cm", "lane_pass_update"))
check(launches["lane_fused_elem"] == 0,
      "solve_full: the staged path launched the fused kernel")
emit("solve_full", **out_staged)

r_fused, launches_fused, out_fused = solve_full_twice(
    "solve_full_fused", True, ("lane_fused_elem", "lane_pass_update"))
total_cg = r_fused.stats["total_cg_iters"]
# every CG iteration applies the operator through K4 once and K3 twice;
# residuals and line-search trials add a few more of each. K1 / K2 run
# only for the Jacobi diagonal, once per Newton step
check(launches_fused["lane_fused_elem"] >= total_cg > 0
      and launches_fused["lane_pass_update"] >= 2 * total_cg,
      f"solve_full_fused: fewer fused launches than CG iterations: "
      f"{launches_fused} for {total_cg} iterations")
check(launches_fused["lane_gather_cm"] <= 2 * FULL_NEWTON_MAXIT
      and launches_fused["lane_scatter_cm"] <= 2 * FULL_NEWTON_MAXIT,
      f"solve_full_fused: the CG loop ran staged kernels: {launches_fused}")
# float32, different rounding of the tangent (hand-derived against AD):
# the two paths solve the same problem and agree to the solve's accuracy
fs_rel = float(np.abs(r_fused.u_flat - r_staged.u_flat).max()
               / np.abs(r_staged.u_flat).max())
check(fs_rel <= 1e-2, f"solve_full_fused: u differs from staged, rel {fs_rel}")
check(abs(r_fused.stats["r0"] - r_staged.stats["r0"])
      <= 1e-5 * r_staged.stats["r0"],
      "solve_full_fused: first residual norm differs from staged")
del r_staged, r_fused

# one CG iteration of either engine under the profiler, on the shared plan
eng_staged = LaneEngine(F_full, bcs_full, plan=p, device=DEV,
                        dtype=torch.float32)
cc_staged = eng_staged.prepare_coeffs({"d": d_full, "E": E_full})
prof = {"staged": cg_profile.profile_cg_iteration(eng_staged, cc_staged, 30),
        "fused": cg_profile.profile_cg_iteration(eng_full, cc_full, 30)}
check(prof["fused"]["lane_kernel_launches_per_iter"]["lane_fused_elem"] == 1.0
      and prof["fused"]["lane_kernel_launches_per_iter"]["lane_pass_update"]
      == 2.0, f"profile: launches per fused CG iteration: {prof['fused']}")
emit("solve_full_fused", **out_fused,
     lane_fused_elem_launches_per_cg_iter=(
         launches_fused["lane_fused_elem"] / total_cg),
     fused_vs_staged_u_rel=fs_rel,
     staged=dict(ms_per_cg_iter=out_staged["ms_per_cg_iter"],
                 cg_iters=out_staged["cg_iters"],
                 peak_device_bytes=out_staged["peak_device_bytes"]),
     cg_iteration_profile=prof)
del eng_staged

# -- 8. full-width solve to convergence: polycrystal.run's defaults ----------

# fused engine + two-level preconditioner, cg_chunk 20, float32, to
# newton_rtol = 1e-5 (float32 stops improving near 1e-6 * r0). Should
# float32 stall above it, the phase solves in float64 instead and says so.
cfg_tl = SolverConfig(cg_rtol=1e-8, newton_rtol=1e-5, cg_maxit=20000,
                      newton_maxit=20, preconditioner="twolevel")


def run_full_twolevel(dtype, postprocess):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = polycrystal.run(N_FULL, n_grains=200, device=DEV, mesh=mesh_full,
                        plan=p, solver=cfg_tl, dtype=dtype,
                        postprocess_fields=postprocess)
    return r, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


tl_dtype, float32_attempt = torch.float32, None
runs = []
for i in range(2):
    if i == 0:
        K.reset_launch_counts()
    r = run_full_twolevel(tl_dtype, i == 0)
    if i == 0 and not r[0].stats["converged"]:
        float32_attempt = dict(residuals=r[0].stats["residuals"],
                               cg_iters=r[0].stats["cg_iters"])
        tl_dtype = torch.float64
        K.reset_launch_counts()
        r = run_full_twolevel(tl_dtype, True)
    if i == 0:
        launches_tl = K.launch_counts()
    runs.append(r)
(r_tl, secs0, peak0), (r_tl1, secs1, _) = runs
st_tl = r_tl.stats
check(st_tl["converged"] and r_tl1.stats["converged"],
      f"solve_full_twolevel did not converge: {st_tl['residuals']}")
check(st_tl["residuals"] == r_tl1.stats["residuals"]
      and st_tl["final_residual"] == r_tl1.stats["final_residual"]
      and st_tl["cg_iters"] == r_tl1.stats["cg_iters"],
      "solve_full_twolevel: residual trajectory differs between two runs")
check(np.array_equal(r_tl.u_flat, r_tl1.u_flat),
      "solve_full_twolevel: solution differs bitwise between two runs")
check(np.isfinite(r_tl.u_flat).all() and np.isfinite(r_tl.energy)
      and np.isfinite(r_tl.stress).all(), "solve_full_twolevel: non-finite")
check(r_tl.u_flat.shape == (2 * (N_FULL + 1) ** 2,),
      "solve_full_twolevel: bad shape")
uu = r_tl.u_flat.reshape(-1, 2)
check(np.allclose(uu[np.abs(r_tl.mesh.x[:, 0] - 1) < 1e-9, 0], 0.01,
                  atol=1e-6), "solve_full_twolevel: Dirichlet values lost")
# two weighted gathers (restriction, prolongation) per application of the
# preconditioner: every CG iteration enqueued (the frozen tail of the last
# chunk too) and one z0 per Newton step that ran CG
n_precond = sum(st_tl["cg_enqueued"]) + len(st_tl["cg_iters"])
check(launches_tl["lane_gather_weighted"] == 2 * n_precond,
      f"solve_full_twolevel: {launches_tl['lane_gather_weighted']} weighted "
      f"gathers for {n_precond} preconditioner applications")
LANE_PATH = ("lane_gather_cm", "lane_scatter_cm", "lane_pass_update",
             "lane_fused_elem", "lane_gather_weighted")
check(all(launches_tl[k] > 0 for k in LANE_PATH),
      f"solve_full_twolevel: a kernel of the path was not launched: "
      f"{launches_tl}")
total_tl = st_tl["total_cg_iters"]
cg_ratio = JACOBI_CG_N256 / max(total_tl, 1)
check(cg_ratio >= 5.0, f"solve_full_twolevel: {total_tl} CG iterations at "
      f"n = {N_FULL} against {JACOBI_CG_N256} of Jacobi at n = {N_SMALL}")
prof_tl = cg_profile.profile_cg_iteration(eng_full, cc_full, 20,
                                          twolevel=(tl_static, tl_geo))
check(prof_tl["lane_kernel_launches_per_iter"]["lane_gather_weighted"] == 2.0,
      f"profile: weighted gathers per two-level CG iteration: {prof_tl}")
emit("solve_full_twolevel", n=N_FULL, n_grains=200, n_dofs=r_tl.n_dofs,
     dtype=str(tl_dtype).replace("torch.", ""),
     float32_attempt=float32_attempt, fused=True, preconditioner="twolevel",
     newton_rtol=cfg_tl.newton_rtol, converged=True,
     newton_iters=st_tl["newton_iters"], cg_iters=st_tl["cg_iters"],
     cg_enqueued=st_tl["cg_enqueued"], total_cg_iters=total_tl,
     jacobi_total_cg_n256=JACOBI_CG_N256, jacobi_over_twolevel=cg_ratio,
     residuals=st_tl["residuals"], final_residual=st_tl["final_residual"],
     energy=r_tl.energy,
     ms_per_cg_iter=1e3 * st_tl["cg_seconds"] / max(total_tl, 1),
     twolevel_setup_seconds=st_tl["twolevel_setup_seconds"],
     launches=launches_tl, preconditioner_applications=n_precond,
     bitwise_equal_runs=True, seconds=[secs0, secs1],
     peak_device_bytes=peak0, timings=r_tl.timings,
     cg_iteration_profile=prof_tl)
del r_tl, r_tl1, runs, eng_full

# -- 8b. the mixed-precision solve: float64 Newton, float32 lane CG ----------

# polycrystal.run(mixed=True) with run's defaults (fused + two-level,
# cg_rtol 1e-8, newton_rtol 1e-6) at n = 1024, twice, bitwise equal; the
# float64 outer residual alone; the same problem solved in float64 on the
# lane engine for the time; at n = 256 the mixed solve to 1e-10 * r0
# against a float64 lane solve (the reference's bound for a loaded mixed
# solve: u rel <= 2e-7, tests/test_polycrystal.py:196-239)


def timed_run(n, **kw):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = polycrystal.run(n, n_grains=200, device=DEV, **kw)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


t_phase = time.perf_counter()
runs = []
for i in range(2):
    if i == 0:
        K.reset_launch_counts()
    runs.append(timed_run(N_FULL, mesh=mesh_full, plan=p, mixed=True,
                          postprocess_fields=(i == 0)))
    if i == 0:
        launches_mx = K.launch_counts()
(r_mx, secs_mx0, peak_mx), (r_mx1, secs_mx1, _) = runs
st_mx = r_mx.stats
check(st_mx["converged"] and r_mx1.stats["converged"],
      f"solve_full_mixed did not converge: {st_mx['residuals']}")
check(st_mx["residuals"] == r_mx1.stats["residuals"]
      and st_mx["final_residual"] == r_mx1.stats["final_residual"]
      and st_mx["cg_iters"] == r_mx1.stats["cg_iters"],
      "solve_full_mixed: residual trajectory differs between two runs")
check(np.array_equal(r_mx.u_flat, r_mx1.u_flat),
      "solve_full_mixed: solution differs bitwise between two runs")
check(r_mx.u_flat.dtype == np.float64 and np.isfinite(r_mx.u_flat).all()
      and np.isfinite(r_mx.energy) and np.isfinite(r_mx.stress).all(),
      "solve_full_mixed: non-finite or not float64")
check(r_mx.u_flat.shape == (2 * (N_FULL + 1) ** 2,),
      "solve_full_mixed: bad shape")
uu = r_mx.u_flat.reshape(-1, 2)
check(np.array_equal(uu[np.abs(r_mx.mesh.x[:, 0] - 1) < 1e-9, 0],
                     np.full(int((np.abs(r_mx.mesh.x[:, 0] - 1) < 1e-9)
                                 .sum()), 0.01)),
      "solve_full_mixed: Dirichlet values are not exactly 0.01")
check(st_mx["final_residual"] < 1e-6 * st_mx["r0"],
      "solve_full_mixed: not converged below 1e-6 * r0")
check(all(launches_mx[k] > 0 for k in LANE_PATH),
      f"solve_full_mixed: a kernel of the path was not launched: "
      f"{launches_mx}")
# two weighted gathers per application of the two-level cycle: every CG
# iteration enqueued and one z0 per Newton step that ran CG
n_precond_mx = sum(st_mx["cg_enqueued"]) + len(st_mx["cg_iters"])
check(launches_mx["lane_gather_weighted"] == 2 * n_precond_mx,
      f"solve_full_mixed: {launches_mx['lane_gather_weighted']} weighted "
      f"gathers for {n_precond_mx} preconditioner applications")

# one float64 outer residual alone, through the same flat Assembler
F64_full, bcs64 = cg_profile.damage_functional(mesh_full, DEV, torch.float64)
asm64 = Assembler(F64_full, bcs64)
c64 = {"d": torch.as_tensor(d_full, dtype=torch.float64, device=DEV),
       "E": torch.as_tensor(E_full, dtype=torch.float64, device=DEV)}
u64 = torch.as_tensor(r_mx.u_flat, device=DEV)
asm64.residual(u64, c64, batch=65536)
torch.cuda.synchronize()
res64_s = []
for _ in range(3):
    t0 = time.perf_counter()
    asm64.residual(u64, c64, batch=65536)
    torch.cuda.synchronize()
    res64_s.append(time.perf_counter() - t0)
del asm64, c64, u64, F64_full

# the same problem in float64 on the lane engine (run's defaults)
r_64, secs_64, peak_64 = timed_run(N_FULL, mesh=mesh_full, plan=p,
                                   dtype=torch.float64,
                                   postprocess_fields=False)
check(r_64.stats["converged"], "solve_full_mixed: the float64 lane solve "
      f"did not converge: {r_64.stats['residuals']}")
mx_vs_64 = float(np.linalg.norm(r_mx.u_flat - r_64.u_flat)
                 / np.linalg.norm(r_64.u_flat))

# n = 256: the mixed solve to 1e-10 * r0 against a float64 lane solve
mesh_256 = polycrystal.generate_polycrystal(N_SMALL, n_grains=200)
r256_mx, secs256_mx, _ = timed_run(
    N_SMALL, mesh=mesh_256, mixed=True, postprocess_fields=False,
    solver=SolverConfig(cg_rtol=1e-8, newton_rtol=1e-10, cg_maxit=20000,
                        newton_maxit=30, preconditioner="twolevel"))
r256_64, secs256_64, _ = timed_run(
    N_SMALL, mesh=mesh_256, dtype=torch.float64, postprocess_fields=False,
    solver=SolverConfig(cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=20000,
                        newton_maxit=30, preconditioner="twolevel"))
st256 = r256_mx.stats
check(st256["final_residual"] <= 1e-10 * st256["r0"],
      f"solve_full_mixed n={N_SMALL}: final residual "
      f"{st256['final_residual']} above 1e-10 * r0 ({st256['r0']})")
check(r256_64.stats["converged"],
      f"n={N_SMALL} float64 lane solve did not converge: "
      f"{r256_64.stats['residuals']}")
rel256 = float(np.linalg.norm(r256_mx.u_flat - r256_64.u_flat)
               / np.linalg.norm(r256_64.u_flat))
check(rel256 <= 2e-7, f"solve_full_mixed n={N_SMALL}: u rel {rel256} "
      "against the float64 lane solve")
emit("solve_full_mixed", n=N_FULL, n_grains=200, n_dofs=r_mx.n_dofs,
     inner_dtype="float32", outer_dtype="float64", fused=True,
     preconditioner="twolevel", newton_rtol=1e-6, converged=True,
     newton_iters=st_mx["newton_iters"], cg_iters=st_mx["cg_iters"],
     cg_enqueued=st_mx["cg_enqueued"],
     total_cg_iters=st_mx["total_cg_iters"], residuals=st_mx["residuals"],
     final_residual=st_mx["final_residual"], r0=st_mx["r0"],
     energy=r_mx.energy, phase_s=st_mx["phase_s"],
     ms_per_cg_iter=1e3 * st_mx["phase_s"]["cg"]
     / max(st_mx["total_cg_iters"], 1),
     float64_residual_seconds=res64_s, launches=launches_mx,
     preconditioner_applications=n_precond_mx, bitwise_equal_runs=True,
     seconds=[secs_mx0, secs_mx1], peak_device_bytes=peak_mx,
     timings=r_mx.timings,
     float64_lane=dict(seconds=secs_64, peak_device_bytes=peak_64,
                       newton_iters=r_64.stats["newton_iters"],
                       cg_iters=r_64.stats["cg_iters"],
                       residuals=r_64.stats["residuals"],
                       timings=r_64.timings, u_rel_to_mixed=mx_vs_64),
     n256=dict(newton_rtol=1e-10, mixed_seconds=secs256_mx,
               float64_seconds=secs256_64,
               mixed_newton_iters=st256["newton_iters"],
               mixed_cg_iters=st256["cg_iters"],
               mixed_residuals=st256["residuals"],
               float64_newton_iters=r256_64.stats["newton_iters"],
               float64_cg_iters=r256_64.stats["cg_iters"],
               float64_residuals=r256_64.stats["residuals"],
               u_rel=rel256),
     tolerance="n = 1024: bitwise equal runs; n = 256: final residual <= "
               "1e-10 * r0, u rel <= 2e-7 against the float64 lane solve",
     seconds_phase=time.perf_counter() - t_phase)
del runs, r_mx, r_mx1, r_64, r256_mx, r256_64, mesh_256
torch.cuda.empty_cache()

# -- 9. structured2d: K6 / K7 and the structured nonlinear solve (path A) ------

E_S, NU_S = 1.0e6, 0.3  # the structured benchmarks' material
N_A, N_A_SMALL, N_B, N_B_SMALL = 1024, 256, 160, 32
# path B's multigrid: levels, coarse dofs, levels on K8 (>= 16 cells a side)
HIERARCHY_B, COARSE_B, K8_LEVELS_B = [160, 80, 40, 20, 10, 5], 648, 4
# flops per lattice cell, counted by hand from csrc/lattice2d.cuh and
# csrc/asym_damage.cuh: both triangles' strain, damage mean and stress (or
# its directional derivative, both branches), and the six contributions the
# cell's v00 node adds (one node per cell)
K6_FLOPS_PER_CELL, K7_FLOPS_PER_CELL = 198, 362


def reset_all_counts():
    for mod in (K, K2, K3):
        mod.reset_launch_counts()


def all_counts():
    return {**K.launch_counts(), **K2.launch_counts(), **K3.launch_counts()}


def damage_grid2d(n):
    return StructuredGrid2D(
        nx=n, ny=n, hx=1 / n, hy=1 / n, bs=2,
        energy_density=lambda g, c: asym_damage_psi(
            0.5 * (g + g.T), c["d"], E_S, NU_S),
        field_kinds={"d": "vertex"})


def band_problem(n):
    """benchmarks/mechanic2d_pallas_bench.py's problem, float32 on the card:
    damage 0.8 in the band 0.45 < y < 0.55, x clamped at both ends, u_x =
    0.01 at x = 1."""
    yy = np.linspace(0, 1, n + 1)[:, None]
    d = np.broadcast_to(np.where((yy > 0.45) & (yy < 0.55), 0.8, 0.0),
                        (n + 1, n + 1)).astype(np.float32)
    free = np.ones((2, n + 1, n + 1), np.float32)
    free[:, :, 0] = 0.0
    free[:, :, -1] = 0.0
    bcv = np.zeros((2, n + 1, n + 1), np.float32)
    bcv[0, :, -1] = 0.01
    return [torch.as_tensor(a, device=DEV) for a in (d, free, bcv)]


def dot(a, b):
    return torch.sum(a * b)


def solve_path_a(n):
    """The structured nonlinear solve of mechanic2d_pallas_bench.py through
    the port's public functions: Newton (rtol 1e-4, atol 1e-2, at most 10
    steps) on K6's residual, Jacobi-CG (rtol 1e-5, chunks of 500 up to
    6000) on K7's tangent action, the Jacobi diagonal from
    StructuredGrid2D.diagonal."""
    grid = damage_grid2d(n)
    res_k = make_residual_kernel(n, n, 1 / n, 1 / n, E_S, NU_S)
    jvp_k = make_tangent_kernel(n, n, 1 / n, 1 / n, E_S, NU_S)
    d, free, bcv = band_problem(n)
    fixed = 1.0 - free
    u = bcv.clone()
    r0, residuals, cg_iters, cg_seconds = None, [], [], 0.0
    for it in range(11):
        b = -res_k(u, d) * free
        bn = float(torch.sqrt(dot(b, b)))
        residuals.append(bn)
        r0 = bn if r0 is None else r0
        if bn < max(1e-4 * r0, 1e-2) or it == 10:
            break
        dinv = 1.0 / (grid.diagonal(u, {"d": d}) * free + fixed)

        def A(v, u=u):
            return jvp_k(u, d, v * free) * free + v * fixed

        x, r, z = torch.zeros_like(b), b, dinv * b
        p, rz = z, dot(b, z)
        k, t0 = 0, time.perf_counter()
        while k < 6000:
            for _ in range(500):
                Ap = A(p)
                alpha = rz / dot(p, Ap)
                x = x + alpha * p
                r = r - alpha * Ap
                z = dinv * r
                rz_new = dot(r, z)
                p = z + (rz_new / rz) * p
                rz = rz_new
            k += 500
            if float(torch.sqrt(dot(r, r))) < 1e-5 * bn:
                break
        cg_seconds += time.perf_counter() - t0
        u = u + x * free
        cg_iters.append(k)
    return dict(u=u, residuals=residuals, cg_iters=cg_iters,
                newton_iters=len(cg_iters), cg_seconds=cg_seconds,
                converged=residuals[-1] < max(1e-4 * r0, 1e-2),
                grid=grid, res_k=res_k, jvp_k=jvp_k, d=d, free=free)


def cg_iteration(A, M, b):
    """One CG iteration (operator, preconditioner, vector updates) from the
    state after z0, repeated on the same state: for the profiler."""
    z = M(b)
    rz = dot(b, z)
    x = torch.zeros_like(b)

    def step():
        Ap = A(z)
        alpha = rz / dot(z, Ap)
        x2 = x + alpha * z
        r2 = b - alpha * Ap
        z2 = M(r2)
        rz2 = dot(r2, z2)
        return x2, z2 + (rz2 / rz) * z

    return step


t_phase = time.perf_counter()
g2 = torch.Generator(device=DEV)
g2.manual_seed(4321)
s2_err, s2_shapes = {}, {}
for nx_, ny_ in ((N_A, N_A), (13, 9), (1001, 517), (1, 1), (31, 7),
                 (33, 9), (2047, 3)):
    u_k = 1e-3 * torch.randn((2, ny_ + 1, nx_ + 1), device=DEV, generator=g2)
    u_k[:, : (ny_ + 1) // 4] = 0.0  # rows of cells on the degenerate branch
    v_k = torch.randn((2, ny_ + 1, nx_ + 1), device=DEV, generator=g2)
    d_k = torch.rand((ny_ + 1, nx_ + 1), device=DEV, generator=g2)
    res_k = make_residual_kernel(nx_, ny_, 1 / nx_, 1 / ny_, E_S, NU_S)
    jvp_k = make_tangent_kernel(nx_, ny_, 1 / nx_, 1 / ny_, E_S, NU_S)
    for name, fn, plain, args, fl in (
            ("lattice_residual", res_k, K2.residual_plain, (u_k, d_k),
             K6_FLOPS_PER_CELL),
            ("lattice_tangent", jvp_k, K2.tangent_plain, (u_k, d_k, v_k),
             K7_FLOPS_PER_CELL)):
        out = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args, fn.consts)
        err = float((out - ref).abs().max())
        check(torch.equal(out, ref), f"{name} {nx_}x{ny_}: max abs err {err}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        if nx_ != N_A:
            record(name, err, None, None, None, None)
            continue
        # per pass: the median of TRIALS timings of back-to-back passes,
        # warm (the same inputs, which the 50 MB L2 holds) and cold
        # (COLD_SETS copies of the inputs in turn, several times what L2
        # holds, so every pass reads its inputs from HBM); the kernels line
        # carries the cold time, the one the byte bound speaks of
        warm = median_ms(lambda: fn(*args), 8 * COLD_SETS)
        sets = itertools.cycle([args] + [tuple(a.clone() for a in args)
                                         for _ in range(COLD_SETS - 1)])
        cold = median_ms(lambda: fn(*next(sets)), 8 * COLD_SETS)
        # the kernel's own device time (torch.profiler): after the profiled
        # phases above the host's cost per launch nears K6 / K7's device
        # time, so back-to-back event timings read the host
        dev_us = LB.device_us(lambda: fn(*next(sets)), 8 * COLD_SETS,
                               LB.PROFILED[name])
        pms = time_ms(lambda: plain(*args, fn.consts), 5)
        b = nbytes(*args, out)
        flops = fl * nx_ * ny_
        b_ms = b / HBM_BYTES_PER_S * 1e3
        f_ms = flops / F32_FLOPS_PER_S * 1e3
        sass_ms = (SASS[name]["main_loop_instructions"] * nx_ * ny_
                   / LANES_PER_S * 1e3)
        record(name, err, cold[0], pms, b, None, flops=flops,
               ops_bound_ms=f_ms, shape=f"{nx_}x{ny_}", cold_ms_range=cold,
               warm_ms=warm[0], warm_ms_range=warm,
               sass_instructions_per_cell=SASS[name][
                   "main_loop_instructions"],
               sass_instruction_floor_ms=sass_ms,
               device_ms=dev_us and dev_us / 1e3)
        del sets
        results[name].update(bound_ms=max(b_ms, f_ms),
                             bound_by="bytes" if b_ms >= f_ms
                             else "operations")
    if nx_ == N_A:
        # the lattice kernels against the generic lattice (AD through
        # torch.func), float32, both on the card
        grid_k = damage_grid2d(N_A)
        ra_ = grid_k.residual(u_k, {"d": d_k})
        rel_r = float((res_k(u_k, d_k) - ra_).abs().max() / ra_.abs().max())
        ta = grid_k.tangent_action(u_k, {"d": d_k}, v_k)
        rel_t = float((jvp_k(u_k, d_k, v_k) - ta).abs().max()
                      / ta.abs().max())
        check(rel_r <= 2e-6 and rel_t <= 5e-6,
              f"K6/K7 against grid2d: rel {rel_r} / {rel_t}")
        s2_err.update(k6_vs_grid2d_residual_rel=rel_r,
                      k7_vs_grid2d_tangent_rel=rel_t)
        # the K6 assembly rate bench.py headlines (back-to-back passes on
        # the same inputs: warm), and the rate of passes from HBM (cold)
        r6, ndof = results["lattice_residual"], 2 * (N_A + 1) ** 2
        s2_shapes["assembly"] = dict(
            n=N_A, n_dofs=ndof, trials=TRIALS, passes=8 * COLD_SETS,
            warm_pass_ms=r6["warm_ms_range"],
            cold_pass_ms=r6["cold_ms_range"],
            mdof_per_s=ndof / (r6["warm_ms"] * 1e-3) / 1e6,
            cold_mdof_per_s=ndof / (r6["ms"] * 1e-3) / 1e6)
        del grid_k, ta, ra_
    del u_k, v_k, d_k

# path A at full width, twice: bitwise equal
runs_a = []
for i in range(2):
    if i == 0:
        reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ra = solve_path_a(N_A)
    torch.cuda.synchronize()
    ra["seconds"] = time.perf_counter() - t0
    ra["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    if i == 0:
        launches_a = all_counts()
    runs_a.append(ra)
ra, ra1 = runs_a
check(ra["converged"] and ra1["converged"],
      f"path A did not converge: {ra['residuals']} / {ra['cg_iters']}")
check(ra["residuals"] == ra1["residuals"]
      and ra["cg_iters"] == ra1["cg_iters"]
      and torch.equal(ra["u"], ra1["u"]),
      "path A: trajectory, CG counts or u differ between two runs")
check(launches_a["lattice_residual"] == len(ra["residuals"])
      and launches_a["lattice_tangent"] == sum(ra["cg_iters"]),
      f"path A launches: {launches_a} for {len(ra['residuals'])} residuals "
      f"and {sum(ra['cg_iters'])} CG iterations")
check(bool(torch.isfinite(ra["u"]).all())
      and torch.equal(ra["u"][0, :, -1], torch.full_like(ra["u"][0, :, -1],
                                                         0.01)),
      "path A: non-finite u or Dirichlet values lost")
step_a = cg_iteration(
    lambda v: ra["jvp_k"](ra["u"], ra["d"], v * ra["free"]) * ra["free"]
    + v * (1.0 - ra["free"]),
    lambda r, dinv=1.0 / (ra["grid"].diagonal(ra["u"], {"d": ra["d"]})
                          * ra["free"] + 1.0 - ra["free"]): dinv * r,
    -ra["res_k"](ra["u"], ra["d"]) * ra["free"])
prof_a = cg_profile._part(step_a, 50)
u_a = ra["u"]
out_a = {k: ra[k] for k in ("residuals", "cg_iters", "newton_iters",
                            "converged", "seconds", "peak_device_bytes")}
out_a.update(n=N_A, n_dofs=2 * (N_A + 1) ** 2, dtype="float32",
             total_cg_iters=sum(ra["cg_iters"]),
             ms_per_cg_iter=1e3 * ra["cg_seconds"] / sum(ra["cg_iters"]),
             seconds_second_run=ra1["seconds"], launches=launches_a,
             cg_iteration_profile=prof_a, bitwise_equal_runs=True)
del runs_a, ra, ra1, step_a

# the same problem at n = 256 through make_grid_solver with multigrid on the
# generic lattice (no K6 / K7), against the kernel path at n = 256
rs = solve_path_a(N_A_SMALL)
d_s, free_s, bcv_s = band_problem(N_A_SMALL)
reset_all_counts()
t0 = time.perf_counter()
rm = make_grid_solver(
    damage_grid2d(N_A_SMALL),
    SolverConfig(preconditioner="mg", newton_rtol=1e-4, newton_atol=1e-2,
                 cg_rtol=1e-5, cg_maxit=6000, newton_maxit=10),
    cg_chunk=10)(bcv_s.clone(), {"d": d_s}, free_s, bcv_s)
torch.cuda.synchronize()
mg_secs = time.perf_counter() - t0
launches_mg = all_counts()
check(rm.converged and rs["converged"], "path A at n = 256 did not converge")
check(launches_mg["lattice_residual"] == 0
      and launches_mg["lattice_tangent"] == 0,
      f"the generic lattice solve launched K6/K7: {launches_mg}")
mg_rel = float((rm.u - rs["u"]).abs().max() / rs["u"].abs().max())
check(mg_rel <= 1e-2, f"path A n = 256: multigrid vs kernel path u rel "
      f"{mg_rel}")
emit("structured2d", kernels={k: results[k] for k in
                              ("lattice_residual", "lattice_tangent")},
     checks=s2_err, **s2_shapes, path_a=out_a,
     path_a_small=dict(
         n=N_A_SMALL, kernel_path=dict(
             newton_iters=rs["newton_iters"], cg_iters=rs["cg_iters"],
             residuals=rs["residuals"]),
         make_grid_solver_mg=dict(
             newton_iters=rm.newton_iters, cg_iters=list(rm.cg_iters),
             residuals=list(rm.residuals), final_residual=rm.final_residual,
             seconds=mg_secs,
             ms_per_cg_iter=1e3 * rm.cg_seconds / max(rm.total_cg_iters, 1)),
         u_rel_mg_vs_kernel_path=mg_rel),
     tolerance="K6/K7 exactly equal to their plain versions at 1024^2, "
               "13x9, 1001x517, 1x1, 31x7, 33x9 and 2047x3; against "
               "grid2d's AD residual / tangent rel <= 2e-6 / 5e-6 (float32)",
     seconds=time.perf_counter() - t_phase)
del rs, rm, u_a
torch.cuda.empty_cache()

# -- 10. structured3d: K8 and the 3D multigrid solve (path B) -----------------


def bar_grid3d(n):
    return StructuredGrid3D(
        nx=n, ny=n, nz=n, hx=1 / n, hy=1 / n, hz=1 / n, bs=3,
        energy_density=lambda g, c: linear_elastic_psi(
            0.5 * (g + g.T), E_S, NU_S),
        field_kinds={})


def bar_problem3d(n):
    """benchmarks/solve3d_bench.py's pulled bar: x = 0 clamped, u_x = 0.01
    at x = 1 (all components fixed on both faces), float32."""
    free = torch.ones((3, n + 1, n + 1, n + 1), device=DEV)
    free[..., 0] = 0.0
    free[..., -1] = 0.0
    bcv = torch.zeros_like(free)
    bcv[0, ..., -1] = 0.01
    return free, bcv


def k8_factory(g):
    """solve3d_bench.py's factory: K8 on levels of at least 16 cells a
    side, the stored stencil below."""
    if min(g.nx, g.ny, g.nz) < 16:
        return None
    return make_linear_matvec(g, E_S, NU_S)


CFG_B = SolverConfig(preconditioner="mg", cg_rtol=1e-6, newton_rtol=1e-5,
                     newton_atol=1e-2, cg_maxit=500)


def solve_path_b(n, factory=k8_factory):
    free, bcv = bar_problem3d(n)
    return make_grid_solver(bar_grid3d(n), CFG_B, cg_chunk=5,
                            mg_matvec_factory=factory)(
        torch.zeros_like(free), {}, free, bcv)


t_phase = time.perf_counter()
s3 = {}
for dims, h3 in (((N_B,) * 3, None), ((9, 7, 11), (0.1, 0.2, 0.15)),
                 ((1, 1, 1), None), ((2, 2, 2), None),
                 ((33, 5, 17), (0.03, 0.2, 0.06))):
    h3 = h3 or tuple(1 / m for m in dims)
    grid3 = StructuredGrid3D(
        nx=dims[0], ny=dims[1], nz=dims[2], hx=h3[0], hy=h3[1], hz=h3[2],
        bs=3, energy_density=lambda g, c: linear_elastic_psi(
            0.5 * (g + g.T), E_S, NU_S), field_kinds={})
    mv = make_linear_matvec(grid3, E_S, NU_S)
    x3 = torch.randn((3, dims[2] + 1, dims[1] + 1, dims[0] + 1), device=DEV,
                     generator=g2)
    y3 = mv(x3)
    torch.cuda.synchronize()
    ref3 = K3.linear_matvec_plain(x3, mv.consts)
    err = float((y3 - ref3).abs().max())
    check(torch.equal(y3, ref3), f"lattice_matvec3d {dims}: {err}")
    if dims != (N_B,) * 3:
        record("lattice_matvec3d", err, None, None, None, None)
        continue
    ms = time_ms(lambda: mv(x3), 20)
    dev_us = LB.device_us(lambda: mv(x3), 20, LB.PROFILED["lattice_matvec3d"])
    pms = time_ms(lambda: K3.linear_matvec_plain(x3, mv.consts), 2)
    b = nbytes(x3, y3)
    # the least work: a product and a sum for every entry of each node's
    # summed blocks that is not zero (153 an interior node)
    flops = LB.k8_least_flops(mv.consts)
    interior = int(np.prod([m - 1 for m in dims]))
    sass_ms = (SASS["lattice_matvec3d"]["main_loop_instructions"] * interior
               / LANES_PER_S * 1e3)
    b_ms, f_ms = b / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    # yardstick: conv3d, 3 -> 3 channels, 3^3 kernel, padding 1, with the
    # interior stencil (sum over chi per delta): right in the interior only
    wgt = torch.zeros((3, 3, 3, 3, 3), dtype=torch.float64)
    for (dz, dy, dx), Sb in zip(K3.DELTAS, mv.consts.S):
        wgt[:, :, dz + 1, dy + 1, dx + 1] = torch.as_tensor(Sb)
    wgt = wgt.to(torch.float32).to(DEV)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # full float32, as K8
    conv = lambda: torch.nn.functional.conv3d(x3[None], wgt, padding=1)[0]
    yc = conv()
    crel = float((yc - y3)[:, 1:-1, 1:-1, 1:-1].abs().max()
                 / y3[:, 1:-1, 1:-1, 1:-1].abs().max())
    check(crel <= 1e-5, f"conv3d yardstick disagrees in the interior: {crel}")
    lms = time_ms(conv, 20)
    torch.backends.cudnn.allow_tf32 = tf32
    record("lattice_matvec3d", err, ms, pms, b, None, flops=flops,
           ops_bound_ms=f_ms,
           kernel_flops_per_interior_node=2 * len(K3.INTERIOR_ENTRIES),
           sass_instructions_per_interior_node=SASS["lattice_matvec3d"][
               "main_loop_instructions"], sass_instruction_floor_ms=sass_ms,
           conv3d_yardstick_ms=lms, conv3d_interior_rel=crel,
           device_ms=dev_us and dev_us / 1e3, shape=f"{N_B}^3")
    results["lattice_matvec3d"].update(
        bound_ms=max(b_ms, f_ms),
        bound_by="bytes" if b_ms >= f_ms else "operations")
    del x3, y3, ref3, yc, wgt
# K8 against the stored 27-point stencil of the same lattice (float32)
g40 = bar_grid3d(40)
x40 = torch.randn((3, 41, 41, 41), device=DEV, generator=g2)
st40 = g40.operator(torch.zeros_like(x40), {})(x40)
s3["k8_vs_stored_stencil_rel"] = float(
    (make_linear_matvec(g40, E_S, NU_S)(x40) - st40).abs().max()
    / st40.abs().max())
check(s3["k8_vs_stored_stencil_rel"] <= 5e-6,
      f"K8 against the stored stencil: {s3['k8_vs_stored_stencil_rel']}")
del g40, x40, st40
# a small bar: the K8 solve against the stored-stencil solve (no factory)
rk, rn = solve_path_b(N_B_SMALL), solve_path_b(N_B_SMALL, None)
s3["small_k8_vs_stencil_u_rel"] = float((rk.u - rn.u).abs().max()
                                        / rn.u.abs().max())
check(rk.converged and rn.converged
      and s3["small_k8_vs_stencil_u_rel"] <= 1e-4,
      f"path B at n = {N_B_SMALL}: {s3}")
del rk, rn

runs_b = []
for i in range(2):
    if i == 0:
        reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rb = solve_path_b(N_B)
    torch.cuda.synchronize()
    runs_b.append((rb, time.perf_counter() - t0,
                   torch.cuda.max_memory_allocated()))
    if i == 0:
        launches_b = all_counts()
(rb, secs_b0, peak_b), (rb1, secs_b1, _) = runs_b
check(rb.converged and rb1.converged,
      f"path B did not converge: {rb.residuals} / {rb.cg_iters}")
check(rb.residuals == rb1.residuals and rb.cg_iters == rb1.cg_iters
      and rb.final_residual == rb1.final_residual
      and torch.equal(rb.u, rb1.u),
      "path B: trajectory, CG counts or u differ between two runs")
# path B's hierarchy (the solver builds it at every Newton step): for the
# launch count, for one CG iteration under the profiler, and for the split
# of the solve's time (the build, one residual, the fine level's diagonal
# and one call of the K8 factory, each timed alone)
free_b, _ = bar_problem3d(N_B)
torch.cuda.synchronize()
t0 = time.perf_counter()
grids_b, data_b = mg3d.build_mg3d(bar_grid3d(N_B), rb.u, {}, free_b,
                                  matvec_factory=k8_factory)
torch.cuda.synchronize()
build_secs_b = time.perf_counter() - t0
t0 = time.perf_counter()
res_b = bar_grid3d(N_B).residual(rb.u, {})
torch.cuda.synchronize()
residual_secs_b = time.perf_counter() - t0
t0 = time.perf_counter()
bar_grid3d(N_B).diagonal(rb.u, {})
torch.cuda.synchronize()
diagonal_secs_b = time.perf_counter() - t0
t0 = time.perf_counter()
k8_factory(bar_grid3d(N_B))  # the law's proof and the stencil constants
factory_secs_b = time.perf_counter() - t0
mvs_b = [k8_factory(g) for g in grids_b[:-1]]
check(all((lv.op is None) == (m is not None)
          for lv, m in zip(data_b.levels, mvs_b)),
      "path B: a level on K8 stores a stencil, or one without K8 lacks it")
k8_levels = sum(m is not None for m in mvs_b)
check([g.nx for g in grids_b] == HIERARCHY_B
      and data_b.coarse_inv.shape == (COARSE_B, COARSE_B)
      and k8_levels == K8_LEVELS_B,
      f"path B hierarchy {[g.nx for g in grids_b]}, coarse "
      f"{tuple(data_b.coarse_inv.shape)}, {k8_levels} K8 levels")
# K8 on the levels of >= 16 cells: the fine CG operator once per CG
# iteration, 8 smoother applications per level per V-cycle (one V-cycle
# per CG iteration and one for z0), and at each Newton step's build the
# level's power iterations and Rayleigh quotient
want_k8 = sum(k + (k + 1) * 8 * k8_levels
              + (mg3d.POWER_ITERS + 1) * k8_levels for k in rb.cg_iters)
check(launches_b["lattice_matvec3d"] == want_k8,
      f"path B: {launches_b['lattice_matvec3d']} K8 launches, expected "
      f"{want_k8}")
mid = rb.u[0, :, :, N_B // 2]
check(bool(torch.isfinite(rb.u).all())
      and 0.004 < float(mid.mean()) < 0.006
      and torch.equal(rb.u[0, ..., -1], torch.full_like(rb.u[0, ..., -1],
                                                        0.01)),
      "path B: non-finite u, Dirichlet values lost, or u_x(1/2) off")
fixed_b = 1.0 - free_b
step_b = cg_iteration(
    lambda v: mvs_b[0](v * free_b) * free_b + v * fixed_b,
    lambda r: mg3d.vcycle(data_b, r, degree=CFG_B.mg_degree, matvecs=mvs_b),
    -res_b * free_b)
prof_b = cg_profile._part(step_b, 10)
emit("structured3d", kernels={"lattice_matvec3d": results["lattice_matvec3d"]},
     checks=s3, path_b=dict(
         n=N_B, n_dofs=3 * (N_B + 1) ** 3, dtype="float32",
         levels=[g.nx for g in grids_b], k8_levels=k8_levels,
         coarse_dofs=int(data_b.coarse_inv.shape[0]),
         newton_iters=rb.newton_iters, cg_iters=list(rb.cg_iters),
         total_cg_iters=rb.total_cg_iters, residuals=list(rb.residuals),
         final_residual=rb.final_residual, r0=rb.r0,
         ms_per_cg_iter=1e3 * rb.cg_seconds / max(rb.total_cg_iters, 1),
         seconds=[secs_b0, secs_b1], peak_device_bytes=peak_b,
         hierarchy_build_seconds=build_secs_b,
         residual_seconds=residual_secs_b,
         fine_diagonal_seconds=diagonal_secs_b,
         k8_factory_seconds=factory_secs_b,
         launches=launches_b, cg_iteration_profile=prof_b,
         u_x_mid_mean=float(mid.mean()), bitwise_equal_runs=True),
     tolerance="K8 exactly equal to its plain version at 160^3, 9x7x11, "
               "1^3, 2^3 and 33x5x17; against the stored stencil rel <= "
               "5e-6 (float32); conv3d yardstick interior rel <= 1e-5",
     seconds=time.perf_counter() - t_phase)
del runs_b, rb, rb1, data_b, grids_b, mvs_b, step_b, res_b
torch.cuda.empty_cache()

# -- 12. mechanic2d: the reference study's own workload (flat Assembler) ---------

# the reference's Newton / CG counts on square.msh refined 3 times
# (tpufem, float64 on the CPU): 5 Newton steps
REF_R3_CG = [609, 596, 613, 620, 614]
R_CHECK, R_FULL = 3, 7  # 6 466 and 1 608 706 dofs


def mech_run(r, device, dtype, **solver_kw):
    """``mechanic2d.run`` on square.msh refined ``r`` times."""
    cfg = Mechanic2DConfig(max_refine=r, output_dir=solver_kw.pop(
        "output_dir", None), solver=SolverConfig(**solver_kw))
    return mechanic2d.run(cfg, device=device, dtype=dtype)


def rel(a, b):
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    return float((a - b).abs().max() / b.abs().max())


def mech_cg_step(A, M, b):
    """One CG iteration of ``la.cg`` (operator, Jacobi, the vector updates
    with ``torch.dot``) from the state after z0, repeated on the same
    state: for the profiler."""
    z = M(b)
    rz = torch.dot(b, z)
    x = torch.zeros_like(b)

    def step():
        Ap = A(z)
        alpha = rz / torch.dot(z, Ap)
        x2 = x + alpha * z
        r2 = b - alpha * Ap
        z2 = M(r2)
        rz2 = torch.dot(r2, z2)
        return x2, z2 + (rz2 / rz) * z, torch.dot(r2, r2)

    return step


t_phase = time.perf_counter()
# (a) card against CPU, converged, float64, the reference's SolverConfig
m_dev = mech_run(R_CHECK, DEV, torch.float64)
m_cpu = mech_run(R_CHECK, "cpu", torch.float64)
u_rel_a = rel(m_dev.u, m_cpu.u)
e_rel_a = abs(float(m_dev.energy.sum()) - float(m_cpu.energy.sum())) / abs(
    float(m_cpu.energy.sum()))
check(m_dev.newton_iterations == m_cpu.newton_iterations
      and len(m_dev.krylov_iters) == len(m_cpu.krylov_iters)
      and all(abs(a - b) <= 1 for a, b in zip(m_dev.krylov_iters,
                                              m_cpu.krylov_iters))
      and u_rel_a <= 1e-9 and e_rel_a <= 1e-10,
      f"mechanic2d r = {R_CHECK}: card {m_dev.newton_iterations} / "
      f"{m_dev.krylov_iters}, CPU {m_cpu.newton_iterations} / "
      f"{m_cpu.krylov_iters}, u rel {u_rel_a:.3e}, energy rel {e_rel_a:.3e}")
check_a = dict(
    r=R_CHECK, n_dofs=m_dev.V.n_dofs, newton_card=m_dev.newton_iterations,
    newton_cpu=m_cpu.newton_iterations, cg_card=m_dev.krylov_iters,
    cg_cpu=m_cpu.krylov_iters, cg_reference=REF_R3_CG, newton_reference=5,
    u_rel=u_rel_a, energy_rel=e_rel_a,
    energy_card=float(m_dev.energy.sum()),
    energy_cpu=float(m_cpu.energy.sum()),
    seconds_card=m_dev.timers.elapsed["total"],
    seconds_cpu=m_cpu.timers.elapsed["total"])
del m_dev, m_cpu

# (b) full width: r = 7, float64, the reference's CG (rtol 1e-12, maxit
# 2000, Jacobi), capped at 2 Newton steps, twice; the second run writes
# the output phase (VTU + XDMF/HDF5) to a temporary directory
CAP = dict(newton_maxit=2, error_on_nonconvergence=False)
full = []
with tempfile.TemporaryDirectory() as out_dir:
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        full.append(mech_run(R_FULL, DEV, torch.float64,
                             output_dir=out_dir if i else None, **CAP))
        full[-1].peak = torch.cuda.max_memory_allocated()
    _, pd_back, _ = read_xdmf(f"{out_dir}/mechanic2d.xdmf")
    u_back = pd_back["u"][:, :2].reshape(-1)
    out_bytes = {f: os.path.getsize(f"{out_dir}/{f}")
                 for f in sorted(os.listdir(out_dir))}
f0, f1 = full
check(torch.equal(f0.u, f1.u) and f0.residual_norms == f1.residual_norms
      and f0.krylov_iters == f1.krylov_iters,
      f"mechanic2d r = {R_FULL}: two runs differ ({f0.krylov_iters} / "
      f"{f1.krylov_iters}, {f0.residual_norms} / {f1.residual_norms})")
check(np.array_equal(u_back, f1.u.cpu().numpy())
      and bool(torch.isfinite(f1.u).all()) and np.isfinite(f1.energy).all()
      and f1.strain.shape == (f1.mesh.n_cells, 3),
      "mechanic2d r = 7: XDMF u read back differs, or fields not finite")
cg_total = sum(f0.krylov_iters)
# one CG iteration under the profiler at the first Newton state: the
# operator run uses (linearized once per step) and the reference's (a jvp
# of the residual per application), Jacobi and the vector updates
asm7, c7, V7, _, _ = mechanic2d.setup(
    Mechanic2DConfig(max_refine=R_FULL), device=DEV, dtype=torch.float64)
u7 = torch.zeros(V7.n_dofs, dtype=torch.float64, device=DEV)
em7 = asm7.element_matrices(u7, c7)
M7 = jacobi_preconditioner(asm7.diagonal(u7, c7, em7))
b7 = asm7.lifted_rhs(u7, c7)
step_lin = mech_cg_step(asm7.constrained_action(u7, c7, em7), M7, b7)
prof_lin = cg_profile._part(step_lin, 10)
# its kernels by device time (ms per iteration, launches per iteration)
_, _, rows_lin = cg_profile._device_profile(step_lin, 10)
prof_lin["top_kernels"] = [
    (name[:60], ms / 10, calls / 10)
    for name, ms, calls in sorted(rows_lin, key=lambda r: -r[1])[:8]]
free7 = asm7.free_mask(torch.float64)
prof_jvp = cg_profile._part(mech_cg_step(
    lambda v: asm7.tangent_action(u7, c7, v * free7) * free7
    + v * (1.0 - free7), M7, b7), 3)
del asm7, c7, em7, M7, b7, u7, free7, step_lin
# float32: one Newton step of at most 2000 CG iterations, for the time
f32 = mech_run(R_FULL, DEV, torch.float32, newton_maxit=1,
               error_on_nonconvergence=False)
m_secs = lambda res: res.timers.elapsed["7.3 NonLinear resolution"]
emit("mechanic2d", check_card_vs_cpu=check_a, full=dict(
    r=R_FULL, n_dofs=f0.V.n_dofs, n_cells=f0.mesh.n_cells,
    n_nodes=f0.mesh.n_nodes, dtype="float64", newton_iters=
    f0.newton_iterations, cg_iters=f0.krylov_iters,
    residual_norms=f0.residual_norms, bitwise_equal_runs=True,
    phases=[f.timers.elapsed for f in full],
    ms_per_cg_iter=[1e3 * m_secs(f) / cg_total for f in full],
    peak_device_bytes=[f.peak for f in full],
    outputs_seconds=f1.timers.elapsed["8 Outputs"],
    output_bytes=out_bytes, xdmf_u_read_back_equal=True,
    energy=float(f0.energy.sum()),
    cg_iteration_profile=dict(linearized=prof_lin, jvp=prof_jvp),
    float32=dict(cg_iters=f32.krylov_iters, residual_norms=
                 f32.residual_norms, phases=f32.timers.elapsed,
                 ms_per_cg_iter=1e3 * m_secs(f32) / sum(f32.krylov_iters))),
    tolerance="r = 3, card against CPU (float64): same Newton count, CG "
              "+-1 per step, u rel <= 1e-9, energy rel <= 1e-10; r = 7: "
              "two runs bitwise equal in u, CG counts and residuals",
    nvidia_smi=smi, seconds=time.perf_counter() - t_phase)
del full, f0, f1, f32
torch.cuda.empty_cache()

# -- summary ------------------------------------------------------------------

REPLACES = {
    "lane_gather_cm": "tpufem/lane/kernels.py:198",
    "lane_scatter_cm": "tpufem/lane/kernels.py:258",
    "lane_pass_update": "tpufem/lane/kernels.py:356",
    "lane_fused_elem": "tpufem/lane/kernels.py:521",
    "lane_gather_weighted": "tpufem/lane/kernels.py:568",
    "lane_gather": "tpufem/lane/kernels.py:76",
    "lane_scatter": "tpufem/lane/kernels.py:138",
    "lane_scatter_weighted": "tpufem/lane/kernels.py:632",
    "lattice_residual": "tpufem/structured/pallas2d.py:197",
    "lattice_tangent": "tpufem/structured/pallas2d.py:391",
    "lattice_matvec3d": "tpufem/structured/pallas3d.py:180",
}
# launches on each kernel's main path: run's defaults (fused + two-level,
# phase solve_full_twolevel) for the lane kernels, with the Jacobi solves'
# and the mixed solve's counts beside them; path A (structured2d) for K6 /
# K7; path B (structured3d) for K8; K9-K11 are on no path (0)
MAIN_LAUNCHES = {**launches_tl, "lattice_residual":
                 launches_a["lattice_residual"], "lattice_tangent":
                 launches_a["lattice_tangent"], "lattice_matvec3d":
                 launches_b["lattice_matvec3d"]}
PATHS = {**dict.fromkeys(LANE_PATH, "polycrystal.run defaults, n = 1024"),
         "lattice_residual": "path A", "lattice_tangent": "path A",
         "lattice_matvec3d": "path B", "lane_gather": None,
         "lane_scatter": None, "lane_scatter_weighted": None}
summary = []
for name, r in results.items():
    entry = dict(
        name=name, route="cuda", source=f"tpufem_torch/csrc/{name}.cu",
        replaces=REPLACES[name], path=PATHS[name],
        launches=MAIN_LAUNCHES[name],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"],
    )
    if name in LANE_PATH:
        entry.update(launches_staged_jacobi_solve=launches[name],
                     launches_fused_jacobi_solve=launches_fused[name],
                     launches_mixed_solve=launches_mx[name])
    for k in ("refresh_ms", "refresh_plain_ms", "refresh_bound_ms",
              "jvp_ms", "jvp_plain_ms", "jvp_bound_ms", "shape",
              "prolong_ms", "prolong_plain_ms", "prolong_bound_ms",
              "gather_sum_yardstick_ms", "prolong_gather_sum_yardstick_ms",
              "conv3d_yardstick_ms", "warm_ms", "device_ms", "sum_v_ms",
              "sum_v_plain_ms", "sum_v_bound_ms", "mul_index_add_yardstick_ms",
              "ms_range", "sum_v_ms_range", "prolong_ms_range",
              "sum_v_device_ms",
              "lines_per_warp_load", "prolong_lines_per_warp_load"):
        if k in r:
            entry[k] = r[k]
    summary.append(entry)
check(set(REPLACES) == {e["name"] for e in summary},
      "the kernels line does not list every kernel")
print(json.dumps({"kernels": summary}), flush=True)
print(smi, flush=True)
print(json.dumps({"total_seconds": time.perf_counter() - T_START}),
      flush=True)
print(json.dumps({"ok": True, "device": {
    "platform": "gpu", "kind": torch.cuda.get_device_name(0),
    "count": torch.cuda.device_count()}}), flush=True)
