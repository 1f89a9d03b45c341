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
                   float64), with times, the bound and a yardstick; K2
                   walking the engine's inverse table (its bytes and host
                   seconds printed; a call without it refused); K1 / K2 /
                   K3 / K4 / K5 / K9 / K11 also at edge shapes; for K1 / K5
                   the mean number of 128-byte lines a warp's direct
                   gather touches; K1 / K2 / K3 also at 3D lane plans
                   (P1 tetrahedra at box(16), 80 passes, and at box(48),
                   a window of 272 rows; Q2 hexahedra at box(40), C = 3,
                   V = 27, timed there beside their bounds), whose Q2-hex
                   engine (its set-up timed) serves phase ``multiqp``
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
11b. ``multiqp``   the lane engine's multi-quadrature-point path
                   (``lane.multiqp``; K1-K3 around PyTorch physics):
                   float64 card against CPU, Jacobi ``make_solver`` on Q2
                   hexahedra at box(4) and on P2 triangles at
                   unit_square(16) with the damage law (same Newton
                   count, CG +-1 a step, u rel <= 1e-9); the full-width
                   problem of ``benchmarks/q2hex_bench.py`` (Q2 hexahedra
                   at box(40), 1 594 323 dofs, float32, staged, Jacobi),
                   one Newton step of at most 2 000 CG, twice, bitwise
                   equal, K1-K3 launched in every CG iteration; set-up
                   seconds, the linearization and diagonal timed alone,
                   peak memory, one CG iteration split into its parts
                   under the profiler beside a tangent's byte bound; and
                   the multi-point generated K4 (``lane_fused_gen_mq``,
                   ``csrc/lane_fused_gen_mq.cuh``): its units built in
                   parallel (registers, spills, build seconds), exactly
                   equal to its plain version in float32 / float64, int8 /
                   int32, grad and JVP at the Q2 box(40) plan, at a Q2
                   plan with 27 points a cell, at the P2 plan below and at
                   edge shapes (tables with zero and unit weights, one
                   bin, a window past the last row, a window read from
                   global memory), timed beside its byte bound (all lane
                   cells and the real cells) and the staged tangent
                   application on the same inputs; Q2 box(40) fused
                   against staged, one Newton step of at most 500 CG, and
                   P2 triangles at unit_square(500) (2 004 002 dofs,
                   damage with the study's body load in the integrand),
                   2 steps of at most 300 CG, each route twice bitwise
                   equal, same Newton count, CG +-1 a step, one CG
                   iteration under the profiler; the float64 card against
                   CPU runs again on fused engines
11c. ``facets_generic`` facet (traction) terms and the lane engine's
                   generic element path (K1-K4 around PyTorch physics):
                   float64 card against CPU on the generic path (Q1
                   hexahedra at box(4), a DG0 modulus, cell terms at
                   quadrature degrees 2 and 3, Jacobi) and on the
                   traction-loaded square at n = 32 under the mixed solver
                   (same Newton count, CG +-1 a step, u rel <= 1e-9); the
                   reference study's functional (``mechanic2d.setup`` at
                   r = 7, 1 608 706 dofs) on the generic engine, float64:
                   K2 exactly equal to its plain version at its plan (both
                   dtypes and index types), timed beside its bound and
                   ``index_add_``; residual, tangent and diagonal at u0
                   and at a random
                   state against the flat Assembler (rel <= 1e-12), a
                   Jacobi solve capped at 2 Newton steps of 1 000 CG,
                   twice, bitwise equal, set-up seconds, one CG iteration
                   under the profiler split into K1, the element-matrix
                   product, K2 and K3 beside its byte bound; the
                   traction-loaded square at n = 1024 (2 101 250 dofs),
                   float32, fused (K4, K3) and staged (K1-K3), capped,
                   twice each, bitwise equal, the facet part of a CG
                   iteration (launches, device ms), the error against the
                   analytic solution; n = 128 in float64 to convergence,
                   error <= 1e-9 max |u|
11d. ``fused_gen`` K4 with physics generated from the integrand
                   (``lane_fused_gen``, ``lane/fused_gen.py``): its units
                   built in parallel; exactly equal to its plain version in
                   float32 / float64, int8 / int32 indices, grad and JVP,
                   for the polycrystal's own law generated (timed beside
                   the hand-written K4 on the same inputs), the
                   polycrystal with the study's body load in the integrand
                   (x-using) and the 3D P1 bar of benchmarks/
                   lane3d_bench.py (n = 87, 2 044 416 dofs, window read
                   from global memory), and at edge shapes with an
                   integrand that holds every operation of the emitter's
                   table; the loaded polycrystal at n = 1024 and the bar,
                   float32, Jacobi, capped at 2 x 300 CG, fused
                   (generated) against staged: same Newton count, CG +-1
                   a step, each twice bitwise equal, one CG iteration
                   under the profiler (K4-gen, K3, beside K4-gen's bytes);
                   float64 card against CPU, converged, at n = 16 (6
                   grains) and box(6): same Newton count, CG +-1, u rel
                   <= 1e-9
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
13. ``flat3d``     BASELINE configs 3 and 4 on the flat Newton solver
                   (``nls.make_newton_solver``; no CUDA kernel of the
                   port on its path), float64: card against CPU for
                   ``elasticity3d`` at n = 6 (hexes, matrix-free Chebyshev
                   and assembled ELL) and ``neohookean`` 3D at n = 4 (same
                   Newton count, |d total CG| <= Newton steps, u rel <=
                   1e-9); ``elasticity3d`` at n = 96 (matrix-free,
                   Chebyshev) and ``neohookean`` 3D at n = 24 (to
                   convergence) and n = 48 (ELL, Jacobi, two capped Newton
                   steps), each twice and bitwise equal, with the stage
                   seconds, ms per CG iteration, peak memory, and one CG
                   iteration under the profiler beside the byte bound of
                   its operator applications; the hex Hessian at n = 64
                   by slab size (seconds, peak)
14. ``amg``        Block Jacobi and SA-AMG (``la.block_jacobi``,
                   ``la.amg``; no CUDA kernel of the port of their own),
                   float64 card against CPU: the damaged 2D system of
                   tests/test_amg.py and ``neohookean`` 3D at n = 4
                   through ``make_newton_solver`` and
                   ``make_chunked_solver`` with each (same Newton count,
                   |d total CG| <= Newton steps, u rel <= 1e-9), one
                   V-cycle from one host hierarchy on both devices (rel
                   <= 1e-12), the aggregates that differ between the
                   card's matrix and the CPU's (printed);
                   ``polycrystal.run(mixed=True)`` under AMG at n = 256
                   to convergence, and again capped at 2 Newton steps
                   with a fresh hierarchy (bitwise equal trajectory), its
                   levels, set-up split, hierarchy bytes, peak memory and
                   one CG iteration under the profiler beside a V-cycle's
                   byte bound; ``neohookean`` n = 48 with block Jacobi,
                   two capped Newton steps twice (bitwise equal), one CG
                   iteration under the profiler beside its byte bound

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
from tpufem_torch.cases import (elasticity3d, mechanic2d,  # noqa: E402
                                neohookean, polycrystal)
from tpufem_torch.config import Mechanic2DConfig, SolverConfig  # noqa: E402
from tpufem_torch.forms import (EnergyFunctional, asym_damage_psi,  # noqa: E402
                                linear_elastic_psi)
from tpufem_torch.forms.form import Coefficient, FacetTerm, Term  # noqa: E402
from tpufem_torch.io import read_xdmf  # noqa: E402
from tpufem_torch.la import (chebyshev_preconditioner,  # noqa: E402
                             estimate_lambda_max, jacobi_preconditioner)
from tpufem_torch.la import amg as AMG  # noqa: E402
from tpufem_torch.la.block_jacobi import BlockJacobiPlan  # noqa: E402
from tpufem_torch.lane import (LaneEngine, _build,  # noqa: E402
                               build_lane_plan)
from tpufem_torch.nls import (make_chunked_solver,  # noqa: E402
                              make_newton_solver)
from tpufem_torch.nls.newton_jit import ELEMENT_BATCH  # noqa: E402
from tpufem_torch.lane import kernels as K  # noqa: E402
from tpufem_torch.lane.fused_gen import GenPhysics, GenPhysicsMQ  # noqa: E402
from tpufem_torch.lane import twolevel as TL  # noqa: E402
from tpufem_torch.perf import cg_profile  # noqa: E402
from tpufem_torch.perf import lane_gather_bench as GB  # noqa: E402
from tpufem_torch.perf import lattice_bench as LB  # noqa: E402
from tpufem_torch.perf import scatter_cm_bench as SB  # noqa: E402
from tpufem_torch.mesh import box, unit_square  # noqa: E402
from tpufem_torch.mesh.topology import locate_entities_boundary  # noqa: E402
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
          "structured2d", "structured3d", "multiqp", "facets_generic",
          "fused_gen", "mechanic2d", "flat3d", "amg")
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
# K1 / K2 / K3 / K4 / K5 / K9 / K11 run with no register cap, and K6 / K7 /
# K8 keep their sums and carried stresses in registers: ptxas must report
# no spill in any of their instances
REDESIGNED = ("lane_pass_update_kernel", "lane_owner_sum_kernel",
              "lane_fused_elem_kernel", "lane_gather_cm_kernel",
              "lane_gather_weighted_kernel", "lane_gather_kernel",
              "lane_scatter_weighted_kernel", "lane_scatter_cm_kernel")
LATTICE = ("lattice2d_kernel", "lattice_matvec3d_kernel")
redesigned = {k: v for k, v in ptxas.items()
              if any(name in k for name in REDESIGNED)}
lattice_ptxas = {k: v for k, v in ptxas.items()
                 if any(name in k for name in LATTICE)}
spills = {k: v for k, v in {**redesigned, **lattice_ptxas}.items()
          if v.get("spill_bytes", 0)}
# K1: 4 staged and 4 reading global memory; K2: 2 value types x 3 channel
# blocks x (2 table types staged + int16 read through L1); K3: 4 + 4; K4:
# 16 per block
# layout; K5: 4 with its tables staged and 4 with them in registers; K9: 4
# staged and 4 reading global memory; K11: 4 with its tables staged and 4
# without
check(len(redesigned) == 8 + 18 + 4 + 4 + 16 * len(K.FUSED_CONFIGS) + 8 + 8
      + 8 and len(lattice_ptxas) == 3 and not spills,
      f"ptxas: {len(redesigned)} K1 / K2 / K3 / K4 / K5 / K9 / K11 and "
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

        # K2 lane_scatter_cm: the kernel walks the engine's inverse table
        # and adds a row's sources in the plain version's order (v-outer,
        # k-inner), so the tolerance is 0: exactly equal
        src = torch.randn((V_ * C, G, kc, 128), dtype=vdt, device=DEV,
                          generator=gen)
        # a table is tied to the tensor it was built from: the engine's
        # serves its own idx, the other index type gets one of its own
        tab = (eng_full.scatter_table if gidx is eng_full.gather_idx
               else K.scatter_cm_table(gidx, wg))
        k2 = dict(k_out=wg, n_ch=C, table=tab)
        out = K.lane_scatter_cm(src, gidx, **k2)
        torch.cuda.synchronize()
        ref = K.lane_scatter_cm_plain(src, gidx, k_out=wg, n_ch=C)
        err = float((out - ref).abs().max())
        check(torch.equal(out, ref), f"lane_scatter_cm {vdt} {idt}: {err}")
        if main:
            ms_r = median_ms(lambda: K.lane_scatter_cm(src, gidx, **k2), 20)
            pms = time_ms(lambda: K.lane_scatter_cm_plain(
                src, gidx, k_out=wg, n_ch=C), 2)
            lms = time_ms(SB.index_add_yardstick(src, gidx, ref), 10)
            # the table's set-up, as LaneEngine builds it (from the card)
            t0 = time.perf_counter()
            K.scatter_cm_table(eng_full.gather_idx, wg)
            rb = SB.real_entry_bytes(src, gidx, tab, out)
            record("lane_scatter_cm", err, ms_r[0], pms,
                   nbytes(src, gidx, out), lms, ms_range=ms_r,
                   padding_share=float((gidx < 0).float().mean()),
                   table_bytes=tab.nbytes,
                   table_host_seconds=time.perf_counter() - t0,
                   real_bound_bytes=rb,
                   real_bound_ms=rb / HBM_BYTES_PER_S * 1e3,
                   geometry=K.scatter_cm_geometry(wg, C, V_, kc, 4))
            # a CUDA call without the table, or with a table built from
            # another tensor (here an equal copy), is refused
            for bad in (None, K.scatter_cm_table(gidx.clone(), wg)):
                try:
                    K.lane_scatter_cm(src, gidx, k_out=wg, n_ch=C, table=bad)
                    refused = False
                except ValueError:
                    refused = True
                check(refused, "lane_scatter_cm ran on the card without "
                      "its own table")
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
            # over the real entries only (padding left out, as for K2)
            dest = index_add_dest(didx, wg, SK10).reshape(-1)
            real = dest < G * wg * 128
            dest = dest[real]
            s2 = src.reshape(C, -1).T[real].contiguous()  # (n_real, C)
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
            del dest, s2, acc, lib, real
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
# K2 at edge shapes, both dtypes and index types (int8 tables clamped at
# 127, so entries past k_out are dropped): heavy padding, an all-padding
# bin, one output row, a row of 23 sources (a P1-tet plan's most), int16
# slots (V * K > 127), a channel count the kernel takes in channel blocks,
# one channel, k_out = 700 rows (the first design's bands), and the shapes
# that launch the rest of K2's instances: 1, 2 and 3 channels a block with
# int16 slots, the tile staged and read through L1, in both dtypes
K2_EDGES = {  # tag: (bins, V, K, k_out, C, padding share)
    "heavy padding": (5, 3, 16, 24, 2, 0.85),
    "all-padding bin": (3, 4, 8, 20, 3, 0.3),
    "k_out 1": (3, 3, 8, 1, 2, 0.4),
    "row of 23": (2, 4, 24, 30, 3, 0.3),
    "int16 slots": (3, 27, 8, 176, 3, 0.5),
    "5 channels": (4, 3, 8, 12, 5, 0.3),
    "1 channel": (4, 3, 32, 40, 1, 0.1),
    "700 rows": (2, 4, 96, 700, 3, 0.2),
    "4 channels": (3, 3, 8, 12, 4, 0.3),
    "6 channels, L1": (1, 8, 96, 50, 6, 0.3),
    "2 channels, int16": (2, 8, 32, 40, 2, 0.3),
    "2 channels, L1": (1, 8, 128, 60, 2, 0.3),
    "1 channel, int16": (2, 8, 32, 40, 1, 0.3),
    "1 channel, L1": (1, 16, 128, 40, 1, 0.3),
}
k2_edge_geo = {}
k2_instances = set()  # (value type, slot type, channels a block, staged)
# their own random streams, so that every later input is the same as
# without them
k2_rng = np.random.default_rng(18)
k2_gen = torch.Generator(device=DEV)
k2_gen.manual_seed(18)
for tag, (T_, V2_, K2_, ko_, C_, pm_) in K2_EDGES.items():
    ix_ = k2_rng.integers(0, ko_ + 2, size=(T_, V2_, K2_, 128))
    ix_[k2_rng.random(ix_.shape) < pm_] = -1
    if tag == "all-padding bin":
        ix_[1] = -1
    if tag == "row of 23":
        ix_[1, :, :, 5] = k2_rng.integers(1, ko_, size=(V2_, K2_))
        ix_[1, 0, :23, 5] = 0
    for idt in (torch.int8, torch.int32):
        ix_t = on_card((np.minimum(ix_, 127) if idt == torch.int8
                        else ix_).astype(IDX_NP[idt]))
        tab_ = K.scatter_cm_table(ix_t, ko_)
        for vdt in (torch.float32, torch.float64):
            src_ = torch.randn((V2_ * C_, T_, K2_, 128), dtype=vdt,
                               device=DEV, generator=k2_gen)
            out = K.lane_scatter_cm(src_, ix_t, k_out=ko_, n_ch=C_,
                                    table=tab_)
            torch.cuda.synchronize()
            ref = K.lane_scatter_cm_plain(src_, ix_t, k_out=ko_, n_ch=C_)
            check(out.shape == ref.shape and torch.equal(out, ref),
                  f"lane_scatter_cm {tag} {vdt} {idt}: "
                  f"{float((out - ref).abs().max())}")
            g2_ = K.scatter_cm_geometry(ko_, C_, V2_, K2_,
                                        src_.element_size())
            k2_instances.add((str(vdt), str(tab_.slots.dtype), g2_["cb"],
                              g2_["staged"]))
            k2_edge_geo[tag] = dict(
                K.scatter_cm_geometry(ko_, C_, V2_, K2_, 8),
                slots=str(tab_.slots.dtype), E=int(tab_.slots.shape[1]))
    if tag == "row of 23":
        cnt = tab_.off[:, 1:].long() - tab_.off[:, :-1].long()
        check(int(cnt.max()) == 23, f"K2 edge {tag}: {int(cnt.max())}")
# every K2 instance ptxas reported was launched and held equal above
k2_ptxas = [k for k in ptxas if "lane_scatter_cm_kernel" in k]
check(len(k2_instances) == len(k2_ptxas) == 18,
      f"K2: {len(k2_instances)} instances launched at the edge shapes, "
      f"{len(k2_ptxas)} built: {sorted(k2_instances)}")
# K1 / K2 / K3 at the shapes of 3D lane plans (bs = 3 channels, int32
# indices), exactly equal to their plain versions in float32 and float64:
# P1 tetrahedra at box(16) (80 owner and refresh passes: more than the
# first K3 took), P1 tetrahedra at box(48) (a window of wg = 272 rows: in
# float64 K1 reads global memory, and K2's tile does not fit a block) and
# the Q2 hexahedra at box(40) of the multi-qp phase (C = 3, V = 27), whose
# engine is built here and serves that phase; at those shapes, float32,
# K1-K3 are also timed beside their bounds
def elastic3d(mesh, degree, qdeg, dtype, device=DEV):
    """Linear elasticity (E = 1e6, nu = 0.3) on a 3D mesh, the left face
    clamped and the right one moved 0.01 in x: the problem of
    benchmarks/q2hex_bench.py."""
    V3 = FunctionSpace.create(mesh, degree, bs=3)
    F3 = EnergyFunctional(V3, [Term(lambda qp: linear_elastic_psi(
        qp.eps, 1.0e6, NU), qdeg)], device=device, dtype=dtype)
    left3 = locate_dofs_geometrical(V3, lambda x: np.abs(x[:, 0]) < 1e-12)
    right3 = locate_dofs_geometrical(
        V3, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    return F3, [DirichletBC(V3, left3, [0.0, 0.0, 0.0]),
                DirichletBC(V3, right3, [0.01, 0.0, 0.0])], V3


def gather_yardstick_ms(vals, st, ix, ref):
    """K1's library yardstick at a plan's shapes: one ``torch.gather`` over
    int64 global indices (expanded outside the timing; -1 -> an appended
    0), checked equal to K1's plain version ``ref``."""
    C3, R3 = vals.shape[0], vals.shape[1]
    G3, V3 = ix.shape[0], ix.shape[1]
    ii = ix.to(torch.int64)
    lane = torch.arange(128, device=DEV)
    flat = (st.to(torch.int64).view(G3, 1, 1, 1) + ii) * 128 + lane
    flat = torch.where(ii >= 0, flat, torch.full_like(flat, R3 * 128))
    flat = flat.permute(1, 0, 2, 3).reshape(1, -1).expand(C3, -1)
    vext = torch.cat([vals.reshape(C3, -1), vals.new_zeros((C3, 1))], dim=1)
    lib = torch.gather(vext, 1, flat).reshape(C3, V3, *ix.shape[:1],
                                              *ix.shape[2:]) \
        .permute(1, 0, 2, 3, 4).reshape(ref.shape)
    check(torch.equal(lib, ref), "gather yardstick disagrees")
    return time_ms(lambda: torch.gather(vext, 1, flat), 10)


def lane_edges_3d(tag, eng3, timed):
    """K1, K2 and both K3 modes on ``eng3``'s own tables, both dtypes;
    with ``timed``, the float32 times, plain times and bounds."""
    p3, C3 = eng3.plan, eng3.bs
    ix, st = eng3.gather_idx, eng3.gather_starts
    k3_tabs = ((True, eng3._owner_starts, eng3._owner_idx, eng3.owner_wrs,
                eng3.owner_shifts),
               (False, eng3._refresh_starts, eng3._refresh_idx,
                eng3.refresh_wrs, tuple(-s for s in eng3.refresh_shifts)))
    info = dict(G=p3.G, kc=p3.kc, wg=p3.wg, nv=p3.nv, R=p3.R,
                idx_dtype=str(ix.dtype), owner_passes=len(eng3.owner_wrs),
                refresh_passes=len(eng3.refresh_wrs), routes={})
    times = {}
    for vdt in (torch.float32, torch.float64):
        vals = torch.randn((C3, p3.R, 128), dtype=vdt, device=DEV,
                           generator=gen)
        k1 = dict(wr=p3.wg, n_ch=C3 * p3.nv)
        out = K.lane_gather_cm(vals, st, ix, **k1)
        torch.cuda.synchronize()
        ref = K.lane_gather_cm_plain(vals, st, ix, **k1)
        check(torch.equal(out, ref), f"lane_gather_cm {tag} {vdt}: "
              f"{float((out - ref).abs().max())}")
        src = torch.randn((p3.nv * C3, p3.G, p3.kc, 128), dtype=vdt,
                          device=DEV, generator=gen)
        k2 = dict(k_out=p3.wg, n_ch=C3, table=eng3.scatter_table)
        out2 = K.lane_scatter_cm(src, ix, **k2)
        torch.cuda.synchronize()
        ref2 = K.lane_scatter_cm_plain(src, ix, k_out=p3.wg, n_ch=C3)
        check(torch.equal(out2, ref2), f"lane_scatter_cm {tag} {vdt}: "
              f"{float((out2 - ref2).abs().max())}")
        vb = vals.element_size()
        info["routes"][str(vdt)] = dict(
            k1_staged=K.check_gather_cm(vals, st, ix, **k1)["tiles"],
            k2=K.scatter_cm_geometry(p3.wg, C3, p3.nv, p3.kc, vb))
        if timed and vdt == torch.float32:
            times["lane_gather_cm"] = (
                median_ms(lambda: K.lane_gather_cm(vals, st, ix, **k1), 20),
                time_ms(lambda: K.lane_gather_cm_plain(vals, st, ix, **k1),
                        2), nbytes(vals, st, ix, out),
                gather_yardstick_ms(vals, st, ix, ref))
            times["lane_scatter_cm"] = (
                median_ms(lambda: K.lane_scatter_cm(src, ix, **k2), 20),
                time_ms(lambda: K.lane_scatter_cm_plain(
                    src, ix, k_out=p3.wg, n_ch=C3), 1),
                nbytes(src, ix, out2),
                time_ms(SB.index_add_yardstick(src, ix, ref2), 10))
            t0 = time.perf_counter()
            K.scatter_cm_table(ix, p3.wg)
            rb = SB.real_entry_bytes(src, ix, eng3.scatter_table, out2)
            results["lane_scatter_cm"].update(
                q2hex_real_bound_bytes=rb,
                q2hex_real_bound_ms=rb / HBM_BYTES_PER_S * 1e3,
                q2hex_library_dump_row_ms=time_ms(SB.index_add_yardstick(
                    src, ix, ref2, dump_row=True), 10),
                q2hex_padding_share=float((ix < 0).float().mean()),
                q2hex_table_bytes=eng3.scatter_table.nbytes,
                q2hex_table_host_seconds=time.perf_counter() - t0)
        del out, ref, src, out2, ref2
        for head, st3, ix3, wrs3, sh3 in k3_tabs:
            kw = dict(wrs=wrs3, wg=p3.wg, shifts=sh3, head=head)
            out = K.lane_pass_update(vals, st3, ix3, **kw)
            torch.cuda.synchronize()
            ref = K.lane_pass_update_plain(vals, st3, ix3, **kw)
            check(torch.equal(out, ref), f"lane_pass_update {tag} head="
                  f"{head} {vdt}: {float((out - ref).abs().max())}")
            geo = K.pass_update_geometry(C3, ix3.shape[2], tuple(wrs3), vb,
                                         ix3.element_size())
            info["routes"][str(vdt)][f"k3_{'owner' if head else 'refresh'}"
                                     ] = dict(wt=geo["wt"],
                                              units=len(geo["units"]))
            if timed and vdt == torch.float32:
                times["lane_pass_update" + ("" if head else "_refresh")] = (
                    median_ms(lambda: K.lane_pass_update(
                        vals, st3, ix3, **kw), 20),
                    time_ms(lambda: K.lane_pass_update_plain(
                        vals, st3, ix3, **kw), 1),
                    nbytes(vals, st3, ix3, out), None)
            del out, ref
        del vals
    for key, (ms_r, pms, b, lib) in times.items():
        name, pre = (("lane_pass_update", "q2hex_refresh_")
                     if key.endswith("_refresh") else (key, "q2hex_"))
        results[name].update({pre + "ms": ms_r[0], pre + "ms_range": ms_r,
                              pre + "plain_ms": pms,
                              pre + "bound_ms": b / HBM_BYTES_PER_S * 1e3,
                              pre + "library_ms": lib})
    return info


edges_3d = {}
for tag, (n3, cell3) in {"P1 tets box(16)": (16, "tetra"),
                         "P1 tets box(48)": (48, "tetra")}.items():
    F3, bcs3, _ = elastic3d(box(n3, n3, n3, cell_type=cell3), 1, 1,
                            torch.float32)
    eng3 = LaneEngine(F3, bcs3, wg_own=32, device=DEV, dtype=torch.float32)
    edges_3d[tag] = lane_edges_3d(tag, eng3, False)
    del eng3, F3, bcs3
# box(48)'s wg rows in float64 exceed one block's shared memory: the
# first K2 design split them into bands
check(edges_3d["P1 tets box(16)"]["owner_passes"] > 64
      and not edges_3d["P1 tets box(48)"]["routes"]["torch.float64"][
          "k1_staged"]
      and edges_3d["P1 tets box(48)"]["wg"] * 128 * 8 > K.SMEM_PER_BLOCK,
      f"the 3D edge plans miss a repaired shape: {edges_3d}")
# the full-width Q2-hex problem (benchmarks/q2hex_bench.py): the engine's
# set-up split into the mesh and space, the lane plan, and the tables
N_Q2 = 40
t0 = time.perf_counter()
mesh_q2 = box(N_Q2, N_Q2, N_Q2)
F_q2, bcs_q2, V_q2 = elastic3d(mesh_q2, 2, 3, torch.float32)
q2_setup = dict(mesh_space=time.perf_counter() - t0)
t0 = time.perf_counter()
plan_q2 = build_lane_plan(V_q2.dof_coords, np.asarray(V_q2.dofmap),
                          wg_own=32)
q2_setup["plan"] = time.perf_counter() - t0
t0 = time.perf_counter()
eng_q2 = LaneEngine(F_q2, bcs_q2, plan=plan_q2, device=DEV,
                    dtype=torch.float32)
torch.cuda.synchronize()
q2_setup["engine_tables"] = time.perf_counter() - t0
edges_3d["Q2 hexes box(40)"] = lane_edges_3d("Q2 hexes box(40)", eng_q2,
                                             True)
shapes.update(k3_edges=dict(K3_EDGES, n256=dict(
    owner=list(eng_256._owner_idx.shape),
    refresh=list(eng_256._refresh_idx.shape))),
    k4_edges=dict(K4_EDGES, n256=list(eng_256.gather_idx.shape)),
    k1_k5_edges=GATHER_EDGES, k5_edge_paths=k5_paths, k9_edges=K9_EDGES,
    k2_edges=K2_EDGES, k2_edge_geometry=k2_edge_geo,
    k11_edges=K11_EDGES,
    k11_edge_paths=[dict(zip(("tiles", "chunks", "groups"), p_))
                    for p_ in sorted(k11_paths)],
    k1_k2_k3_edges_3d=edges_3d)
del eng_256, F_256, cd_256

emit("kernels", shapes=shapes, kernels=results, lane_fused_elem_rel_err=k4_rel,
     k11_adjoint_of_k5_rel=adjoint_rel,
     tolerance="exactly equal (0) for every kernel, K1, K2, K3, K4, K5, "
               "K9 and K11 also at the edge shapes, K1-K3 also at 3D plans; "
               "K11 adjoint of K5 rel "
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
# iteration, 2 * degree smoother applications per level per V-cycle (one
# V-cycle per CG iteration and one for z0), and at each Newton step's
# build the level's power iterations and Rayleigh quotient
want_k8 = sum(k + (k + 1) * 2 * CFG_B.mg_degree * k8_levels
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

# -- 11b. multiqp: the lane engine's multi-quadrature-point path -------------

# (a) card against CPU, float64: make_solver with Jacobi on Q2 hexahedra
# at box(4) (the q2hex problem) and on P2 triangles at unit_square(16)
# (the damage law of tests/test_torch_multiqp.py): the same Newton count,
# CG within 1 a step, u rel <= 1e-9. (b) full width, float32: the q2hex
# problem at box(40) (the engine of the kernels phase), one Newton step of
# at most 2 000 CG, twice, bitwise equal, K1-K3 in every CG iteration; the
# linearization and the diagonal timed alone; one CG iteration split into
# its parts under the profiler beside its byte bound
def body_load_x(x):
    """cases/mechanic2d.py:volumetric_load's x-component (doc.tex:226-232)
    in torch operations on the quadrature point's coordinates."""
    r = x[0] - 0.5
    y = x[1] - 0.5
    return (1600.0 * y * y - 500.0) * (-100000.0 * r * r * r)


def gen_prebuild(items):
    """Build the generated units of ``items`` (unit source -> what it
    serves), all compilers started together (the wrapper would build them
    one by one at first launch); each unit's build seconds, registers and
    spill bytes (ptxas, both kernels of the unit)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(src_):
        t_ = time.perf_counter()
        _build.load_unit(src_)
        return time.perf_counter() - t_

    srcs = sorted(items)
    t_ = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        secs = list(ex.map(one, srcs))
    units = []
    for src_, sec in zip(srcs, secs):
        log = _build.unit_logs.get(_build.unit_key(src_), "")
        units.append(dict(
            serves=items[src_], build_seconds=sec,
            registers=[int(ln.split("Used ")[1].split(" registers")[0])
                       for ln in log.splitlines() if "registers" in ln],
            spill_store_bytes=[
                int(ln.split(" bytes spill stores")[0].split(",")[-1])
                for ln in log.splitlines() if "spill stores" in ln],
            spill_load_bytes=[
                int(ln.split(" bytes spill loads")[0].split(",")[-1])
                for ln in log.splitlines() if "spill loads" in ln]))
    return dict(units=units, n_units=len(units),
                seconds=time.perf_counter() - t_)


def gen_check(tag, phys, st, ix, cds, R_, wr_, idts, timed=None):
    """K4-gen (K4-gen-mq for a multi-point physics) exactly equal to its
    plain version, in both dtypes (``phys`` and ``cds``: dtype -> physics
    / cell data), with the index types ``idts``, grad and JVP. ``timed``:
    the (dtype, index type) whose grad and JVP are timed beside the plain
    version and their bounds."""
    out_t = {}
    for vdt in (torch.float32, torch.float64):
        C_ = phys[vdt].bs
        u_ = 1e-3 * torch.randn((C_, R_, 128), dtype=vdt, device=DEV,
                                generator=gen)
        v_ = torch.randn((C_, R_, 128), dtype=vdt, device=DEV, generator=gen)
        for idt in idts:
            for states in ((u_,), (u_, v_)):
                a = (states, st, ix.to(idt), cds[vdt], phys[vdt])
                kw = dict(wr=wr_, nv=phys[vdt].nv)
                out = K.lane_fused_gen(*a, **kw)
                torch.cuda.synchronize()
                ref = K.lane_fused_gen_plain(*a, **kw)
                err = float((out - ref).abs().max())
                check(bool(torch.isfinite(ref).all()),
                      f"lane_fused_gen {tag}: non-finite plain output")
                check(torch.equal(out, ref), f"lane_fused_gen {tag} "
                      f"{len(states)} state(s) {vdt} {idt}: {err}")
                if timed != (vdt, idt):
                    continue
                ms_r = median_ms(lambda: K.lane_fused_gen(*a, **kw), 10)
                b = nbytes(*states, st, ix.to(idt), *cds[vdt], out)
                ops = phys[vdt].ops_per_cell(len(states)) * int(
                    ix.shape[0] * ix.shape[2] * 128)
                bms, by = bound_of(b, ops)
                out_t["jvp" if len(states) == 2 else "grad"] = dict(
                    ms=ms_r[0], ms_range=ms_r,
                    plain_ms=time_ms(lambda: K.lane_fused_gen_plain(
                        *a, **kw), 1),
                    bound_ms=bms, bound_by=by, bound_bytes=b, ops=ops,
                    geometry=K._gen_layouts(phys[vdt], idt, wr_)[1][
                        len(states) - 1])
                del out, ref
        del u_, v_
    return out_t


MQ_SOLVER = dict(cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=3000,
                 newton_maxit=20, preconditioner="jacobi")


def damage_p2(n, device, dtype=torch.float64, loaded=False):
    """tests/test_torch_multiqp.py's P2 damage problem at unit_square(n);
    ``loaded``: with the study's body load (:func:`body_load_x`) in the
    integrand, as ``loaded_damage_psi`` has it (x-using)."""
    mesh = unit_square(n)
    V2 = FunctionSpace.create(mesh, 2, bs=2)
    DS2 = FunctionSpace.create(mesh, 1, bs=1)
    d2 = np.zeros(DS2.n_dofs)
    d2[(DS2.dof_coords[:, 1] > 0.3) & (DS2.dof_coords[:, 1] < 0.7)] = 0.8

    def psi(qp):
        e = asym_damage_psi(qp.eps, qp.coeff("d"), 1.0e6, NU)
        return e - body_load_x(qp.x) * qp.u[0] if loaded else e

    F2 = EnergyFunctional(V2, [Term(psi, 2)], [Coefficient("d", DS2)],
                          device=device, dtype=dtype)
    left2 = locate_dofs_geometrical(V2, lambda x: np.abs(x[:, 0]) < 1e-12)
    right2 = locate_dofs_geometrical(
        V2, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    return F2, [DirichletBC(V2, left2, [0.0, 0.0]),
                DirichletBC(V2, right2, [0.01, 0.0])], {"d": d2}


MQ_SMALL = {
    "Q2 hexes box(4)": lambda dev: elastic3d(
        box(4, 4, 4), 2, 3, torch.float64, dev)[:2] + ({},),
    "P2 triangles unit_square(16)": lambda dev: damage_p2(16, dev),
}
mq_small, mq_cpu, mq_u_staged = {}, {}, {}
# staged on the card and on the CPU; then fused on the card (K4-gen-mq),
# held against the staged runs of both (the fused route's plain version
# on the CPU is held by tests/test_torch_fused_mq.py)
for fused_s in (False, True):
    for tag, make in MQ_SMALL.items():
        runs = []  # the card's run, then the CPU's
        for dev in (DEV,) if fused_s else (DEV, torch.device("cpu")):
            F_s, bcs_s, c_s = make(dev)
            t0 = time.perf_counter()
            eng_s = LaneEngine(F_s, bcs_s, wg_own=32, fused=fused_s,
                               device=dev, dtype=torch.float64)
            check(eng_s._mq is not None, f"{tag}: not on the multi-qp path")
            K.reset_launch_counts()
            u_s, st_s = eng_s.make_solver(SolverConfig(**MQ_SOLVER),
                                          cg_chunk=50)(
                torch.zeros_like(eng_s.bc_lane), eng_s.prepare_coeffs(c_s))
            runs.append((eng_s.from_lane(u_s), st_s,
                         time.perf_counter() - t0, K.launch_counts()))
            n_dofs_s = F_s.space.n_dofs
            del eng_s, F_s, bcs_s
        u_g, st_g, s_g, l_g = runs[0]
        if not fused_s:
            mq_cpu[tag] = runs[1]
        u_c, st_c, s_c, _ = mq_cpu[tag]
        u_rel = float(np.abs(u_g - u_c).max() / np.abs(u_c).max())
        key = tag + (" fused" if fused_s else "")
        mq_small[key] = dict(
            n_dofs=n_dofs_s, newton_card=st_g["newton_iters"],
            newton_cpu=st_c["newton_iters"], cg_card=st_g["cg_iters"],
            cg_cpu=st_c["cg_iters"], u_rel=u_rel, seconds_card=s_g,
            seconds_cpu=None if fused_s else s_c)
        check(st_g["converged"] and st_c["converged"]
              and st_g["newton_iters"] == st_c["newton_iters"]
              and len(st_g["cg_iters"]) == len(st_c["cg_iters"])
              and all(abs(a - b) <= 1
                      for a, b in zip(st_g["cg_iters"], st_c["cg_iters"]))
              and u_rel <= 1e-9, f"multiqp {key}: card against CPU "
              f"(staged) {mq_small[key]}")
        if fused_s:
            # the fused card run against the staged one on the card: the
            # same Newton count, CG within 1 a step, K4-gen-mq in every CG
            # iteration
            st0 = mq_small[tag]
            mq_small[key].update(card_launches=l_g, u_rel_vs_staged=float(
                np.abs(u_g - mq_u_staged[tag]).max()
                / np.abs(mq_u_staged[tag]).max()))
            check(st_g["newton_iters"] == st0["newton_card"]
                  and all(abs(a - b) <= 1 for a, b in zip(
                      st_g["cg_iters"], st0["cg_card"]))
                  and l_g["lane_fused_gen_mq"] >= sum(st_g["cg_iters"])
                  and mq_small[key]["u_rel_vs_staged"] <= 1e-9,
                  f"multiqp {key}: fused against staged on the card "
                  f"{mq_small[key]}, staged {st0}")
        else:
            mq_u_staged[tag] = u_g
del mq_cpu, mq_u_staged

# (b) full width: Q2 hexes at box(40), float32, staged, Jacobi
cc_q2 = eng_q2.prepare_coeffs({})
MQ_FULL = SolverConfig(newton_maxit=1, cg_maxit=2000,
                       preconditioner="jacobi")
u0_q2 = torch.zeros_like(eng_q2.bc_lane)


def q2_full_run():
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    u_f, st_f = eng_q2.make_solver(MQ_FULL)(u0_q2, cc_q2)
    torch.cuda.synchronize()
    return (u_f, st_f, time.perf_counter() - t0, K.launch_counts(),
            torch.cuda.max_memory_allocated())


mq_u1, mq_st1, mq_s1, launches_mq, mq_peak1 = q2_full_run()
mq_u2, mq_st2, mq_s2, _, mq_peak2 = q2_full_run()
check(torch.equal(mq_u1, mq_u2) and mq_st1["residuals"] == mq_st2["residuals"]
      and mq_st1["final_residual"] == mq_st2["final_residual"]
      and mq_st1["cg_iters"] == mq_st2["cg_iters"],
      f"multiqp full width: two runs differ: {mq_st1['residuals']} / "
      f"{mq_st2['residuals']}")
check(bool(torch.isfinite(mq_u1).all()), "multiqp full width: non-finite u")
enq = sum(mq_st1["cg_enqueued"])
check(enq > 0 and launches_mq["lane_gather_cm"] >= enq
      and launches_mq["lane_scatter_cm"] >= enq
      and launches_mq["lane_pass_update"] >= 2 * enq,
      f"multiqp full width: K1-K3 not in every CG iteration: {launches_mq}, "
      f"{enq} iterations enqueued")
check(mq_st1["final_residual"] < mq_st1["residuals"][0],
      f"multiqp full width: the residual did not fall: "
      f"{mq_st1['residuals']} -> {mq_st1['final_residual']}")
# the linearization, the diagonal and one tangent application alone
u_lin = torch.where(eng_q2.free_lane > 0, u0_q2, eng_q2.bc_lane)
torch.cuda.synchronize()
t0 = time.perf_counter()
lin_q2 = eng_q2.linearize(u_lin, cc_q2)
torch.cuda.synchronize()
lin_s = time.perf_counter() - t0
t0 = time.perf_counter()
eng_q2.diagonal(u_lin, cc_q2, lin_q2)
torch.cuda.synchronize()
diag_s = time.perf_counter() - t0
del lin_q2
mq = eng_q2._mq
M_q2 = plan_q2.G * plan_q2.kc * 128
vb = 4
# one staged tangent application's least traffic: the stored Hessian once,
# dN twice (reduced arguments and chain back), the cell vectors written and
# read once each (gathered values, element vectors), the state read and
# written; the real cells' share of the cell-proportional part beside it
q2_bytes = dict(
    hessian=mq.nr * mq.nr * mq.nq * M_q2 * vb,
    dN_twice=2 * M_q2 * mq.nv * mq.nq * mq.gd * vb,
    cell_vectors=4 * mq.nd * M_q2 * vb,
    state=2 * eng_q2.bs * plan_q2.R * 128 * vb)
q2_bound_ms = sum(q2_bytes.values()) / HBM_BYTES_PER_S * 1e3
real_share = mesh_q2.n_cells / M_q2
q2_bound_real_ms = (q2_bound_ms - q2_bytes["state"] / HBM_BYTES_PER_S * 1e3
                    ) * real_share + q2_bytes["state"] / HBM_BYTES_PER_S * 1e3
prof_q2 = cg_profile.profile_cg_iteration(eng_q2, cc_q2, 20)
# (e) the multi-point generated K4 (K4-gen-mq: lane_fused_gen_mq,
# csrc/lane_fused_gen_mq.cuh): (a) its units built in parallel, exactly
# equal to its plain version at the Q2 box(40) plan, at Q2 hexahedra under
# a degree-4 rule (27 points, 2 214 geometry rows a cell), at the P2 plan
# of (c) and at edge shapes, timed beside its bounds and the staged tangent
# application on the same inputs; (b) Q2 box(40) and (c) P2 triangles at
# unit_square(N_P2) fused against staged
N_Q2_27, N_P2 = 12, 500
MQ_DTS = (torch.float32, torch.float64)
t_mq = time.perf_counter()
mq_setup, mq_secs = {}, {}
t0 = time.perf_counter()
eng_q2f = LaneEngine(F_q2, bcs_q2, plan=plan_q2, fused=True, device=DEV,
                     dtype=torch.float32)
cc_q2f = eng_q2f.prepare_coeffs({})
torch.cuda.synchronize()
mq_setup["q2_fused_engine_and_trace"] = time.perf_counter() - t0
phys_q2 = {dt: eng_q2f.fused_gen(dt) for dt in MQ_DTS}
check(phys_q2[torch.float32].MULTIQP and phys_q2[torch.float32].nq == mq.nq
      and eng_q2f.fused_geom.shape[1] == phys_q2[torch.float32].dg,
      f"Q2 box(40) fused: geometry {tuple(eng_q2f.fused_geom.shape)}")
t0 = time.perf_counter()
F_27, bcs_27, _ = elastic3d(box(N_Q2_27, N_Q2_27, N_Q2_27), 2, 4,
                            torch.float32)
eng_27 = LaneEngine(F_27, bcs_27, wg_own=32, fused=True, device=DEV,
                    dtype=torch.float32)
mq_setup["q2_27_points_engine"] = time.perf_counter() - t0
phys_27 = {dt: eng_27.fused_gen(dt) for dt in MQ_DTS}
check(phys_27[torch.float32].nq == 27
      and eng_27.fused_geom.shape[1] == 27 * 27 * 3 + 27,
      f"Q2 under a degree-4 rule: {tuple(eng_27.fused_geom.shape)}")
t0 = time.perf_counter()
F_p2, bcs_p2, co_p2 = damage_p2(N_P2, DEV, torch.float32, loaded=True)
V_p2 = F_p2.space
mq_setup["p2_mesh_space"] = time.perf_counter() - t0
t0 = time.perf_counter()
plan_p2 = build_lane_plan(V_p2.dof_coords, np.asarray(V_p2.dofmap),
                          wg_own=32)
mq_setup["p2_plan"] = time.perf_counter() - t0
t0 = time.perf_counter()
eng_p2f = LaneEngine(F_p2, bcs_p2, plan=plan_p2, fused=True, device=DEV,
                     dtype=torch.float32)
cc_p2f = eng_p2f.prepare_coeffs(co_p2)
torch.cuda.synchronize()
mq_setup["p2_fused_engine_and_trace"] = time.perf_counter() - t0
phys_p2 = {dt: eng_p2f.fused_gen(dt) for dt in MQ_DTS}
check(phys_p2[torch.float32].x_rows and phys_p2[torch.float32].nq == 3
      and eng_p2f.fused_geom.shape[1] == 3 * 6 * 2 + 3 + 3 * 2,
      f"P2 loaded: x rows {phys_p2[torch.float32].x_rows}, geometry "
      f"{tuple(eng_p2f.fused_geom.shape)}")
# edge physics: basis tables with zero and unit weights (a point where
# every value vanishes), a nodal and a P0 coefficient, x read
MQ_EDGE_NF = np.array([[0.0, 1.0, 0.0], [0.25, 0.0, 0.75], [0.0, 0.0, 0.0],
                       [1.0, 0.5, -0.5]])
MQ_EDGE_NC = np.array([[1.0, 0.0], [0.0, 0.0], [0.5, 0.5], [0.0, 2.0]])


def mq_edge_psi(qp):
    g = qp.grad_u
    return (0.5 * qp.coeff("k") * (g[0, 0] * g[0, 0] + g[0, 1] * g[0, 1])
            + qp.coeff("c0") * qp.u * qp.u * qp.u - qp.u * qp.x[1]
            + (qp.u * qp.u + 1.0) ** 0.5 / 0.52)


phys_edge = {dt: GenPhysicsMQ(
    mq_edge_psi, bs=1, gd=2, nv=3, coeff_meta=(("k", 2, 1), ("c0", 1, 1)),
    dtype=dt, Nf=MQ_EDGE_NF, Nc={"k": MQ_EDGE_NC, "c0": None})
    for dt in MQ_DTS}
MQ_EDGES = {  # tag: (bins, K, wr, window to the last row, physics)
    "K=13": (37, 13, 40, False, "tables"),
    "one bin, K=1": (1, 1, 9, False, "tables"),
    "window past the last row": (7, 16, 40, True, "tables"),
    "int8 window of 126 rows": (4, 32, 126, False, "tables"),
    "Q2 window of 300 rows, global memory": (3, 8, 300, True, "q2"),
}
MQ_EDGE_PHYS = {"tables": phys_edge, "q2": phys_q2}


def mq_idts(wr_):
    return (torch.int8, torch.int32) if wr_ < 127 else (torch.int32,)


mq_items = {}  # unit source -> what it serves
for dt in MQ_DTS:
    for tag_u, ph_, wr_ in (("Q2 box(40)", phys_q2, plan_q2.wg),
                            ("Q2 27 points", phys_27, eng_27.plan.wg),
                            ("P2 loaded", phys_p2, plan_p2.wg),
                            *((f"edge {t_}", MQ_EDGE_PHYS[e_[4]], e_[2])
                              for t_, e_ in MQ_EDGES.items())):
        for idt in mq_idts(wr_):
            src_ = K.fused_gen_source(ph_[dt], idt, wr_)
            mq_items.setdefault(src_, []).append(f"{tag_u} {dt} {idt}")


mq_build = gen_prebuild(mq_items)
mq_secs["setup"] = time.perf_counter() - t_mq


def mq_real_bounds(out_t, eng_, cds_):
    """Beside each timed mode of :func:`gen_check`'s ``out_t``, its bound
    with the cell rows of the real cells only: the kernel reads nothing of
    a lane cell whose every index is -1."""
    p_ = eng_.plan
    real = float(np.count_nonzero(np.asarray(p_.cell_valid))) / (
        p_.G * p_.kc * 128)
    cell = nbytes(eng_.gather_idx, *cds_)
    for r_ in out_t.values():
        b_real = r_["bound_bytes"] - cell + cell * real
        r_["bound_ms_real_cells"], r_["bound_by_real_cells"] = bound_of(
            b_real, r_["ops"] * real)
        r_.update(bound_bytes_real_cells=b_real, real_cell_share=real)
    return out_t


t0 = time.perf_counter()
k4mq = {}
cds_q2f = {dt: eng_q2f._fused_cds(cc_q2f, dt) for dt in MQ_DTS}
k4mq["q2_box40"] = mq_real_bounds(gen_check(
    "Q2 box(40)", phys_q2, eng_q2f.gather_starts, eng_q2f.gather_idx,
    cds_q2f, plan_q2.R, plan_q2.wg, mq_idts(plan_q2.wg),
    timed=(torch.float32, eng_q2f.gather_idx.dtype)), eng_q2f,
    cds_q2f[torch.float32])
cds_27 = {dt: eng_27._fused_cds({}, dt) for dt in MQ_DTS}
k4mq["q2_27_points"] = mq_real_bounds(gen_check(
    "Q2 27 points", phys_27, eng_27.gather_starts, eng_27.gather_idx,
    cds_27, eng_27.plan.R, eng_27.plan.wg, mq_idts(eng_27.plan.wg),
    timed=(torch.float32, eng_27.gather_idx.dtype)), eng_27,
    cds_27[torch.float32])
del cds_27, eng_27, F_27, bcs_27
cds_p2f = {dt: eng_p2f._fused_cds(cc_p2f, dt) for dt in MQ_DTS}
k4mq["p2_loaded"] = mq_real_bounds(gen_check(
    "P2 loaded", phys_p2, eng_p2f.gather_starts, eng_p2f.gather_idx,
    cds_p2f, plan_p2.R, plan_p2.wg, mq_idts(plan_p2.wg),
    timed=(torch.float32, eng_p2f.gather_idx.dtype)), eng_p2f,
    cds_p2f[torch.float32])
del cds_p2f
mq_edges = {}
for tag, (T_, K_, wr_, last, which) in MQ_EDGES.items():
    ph = MQ_EDGE_PHYS[which][torch.float64]
    R_ = T_ * wr_ + 5
    st_ = edge_rng.integers(0, R_ - wr_ + 1, size=T_)
    if last:
        st_[-1] = R_ - wr_ // 2
    ix_ = edge_rng.integers(-1, wr_ + 1, size=(T_, ph.nv, K_, 128))
    geom_ = edge_rng.standard_normal((T_, ph.dg, K_, 128))
    cds_e = [geom_]
    if ph.n_coeff_rows:
        cds_e.append(edge_rng.uniform(0.5, 2.0, (T_, ph.n_coeff_rows, K_,
                                                 128)))
    gen_check(f"K4-gen-mq {which} at {tag}", MQ_EDGE_PHYS[which],
              on_card(st_, torch.int32), on_card(ix_.astype(np.int32)),
              {dt: tuple(on_card(c_, dt) for c_ in cds_e) for dt in MQ_DTS},
              R_, wr_, mq_idts(wr_))
    mq_edges[tag] = dict(bins=T_, K=K_, wr=wr_, window_to_last_row=last,
                         physics=which, geometry=[
                             K._gen_layouts(MQ_EDGE_PHYS[which][dt], idt,
                                            wr_)[1][ns]
                             for dt in MQ_DTS for idt in mq_idts(wr_)
                             for ns in (0, 1)])
mq_secs["kernel_checks"] = time.perf_counter() - t0

# the staged tangent application at the Q2 box(40) shapes on the inputs
# of the fused one: K1 -> reduced arguments -> H apply -> chain back -> K2
u_t = 1e-3 * torch.randn((3, plan_q2.R, 128), device=DEV, generator=gen)
v_t = torch.randn((3, plan_q2.R, 128), device=DEV, generator=gen)
H_t = eng_q2.linearize(u_t, cc_q2).cells
D_t = eng_q2.geom_dN


def staged_q2_apply():
    vc = eng_q2._gather_cells(v_t)
    ev = mq.chain_back(mq.hess_apply(H_t, mq.reduced_args(vc, D_t)), D_t)
    return K.lane_scatter_cm(
        ev.reshape(mq.nd, plan_q2.G, plan_q2.kc, 128).contiguous(),
        eng_q2.gather_idx, k_out=plan_q2.wg, n_ch=3,
        table=eng_q2.scatter_table)


def fused_q2_apply():
    return K.lane_fused_gen((u_t, v_t), eng_q2f.gather_starts,
                            eng_q2f.gather_idx, cds_q2f[torch.float32],
                            phys_q2[torch.float32], wr=plan_q2.wg, nv=27)


o_st = staged_q2_apply()
o_fu = fused_q2_apply().permute(1, 0, 2, 3)
q2_apply = dict(
    staged_ms=median_ms(staged_q2_apply, 5),
    fused_ms=median_ms(fused_q2_apply, 10),
    rel=float((o_st - o_fu).abs().max() / o_st.abs().max()))
# two orders of one float32 sum (2.2e-7 on the H100): the capped solves of
# (b) cannot tell the routes apart, so this is the full-width check of the
# fused operator
check(q2_apply["rel"] <= 1e-5, f"staged against fused Q2 tangent {q2_apply}")
del o_st, o_fu, H_t, u_t, v_t, cds_q2f
torch.cuda.empty_cache()


def mq_pair(tag, engs, ccs, cfg):
    """Each route of ``engs`` ({"fused": ..., "staged": ...}, coefficient
    blocks ``ccs``) solved twice from the lifted zero state under ``cfg``:
    bitwise equal, the residual falls, the route's kernels in every CG
    iteration (the fused one's K1 / K2 only in the Jacobi diagonal, once a
    Newton step); then the same Newton count and CG +-1 a step across the
    routes, and one CG iteration of each under the profiler."""
    out_p, runs_p = {}, {}
    for route, eng in engs.items():
        rr = []
        for _ in range(2):
            K.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_ = time.perf_counter()
            u_, st_ = eng.make_solver(cfg)(torch.zeros_like(eng.bc_lane),
                                           ccs[route])
            torch.cuda.synchronize()
            rr.append((u_, st_, time.perf_counter() - t_, K.launch_counts(),
                       torch.cuda.max_memory_allocated()))
        (u1, s1, t1, l1, m1), (u2, s2, t2, _, m2) = rr
        check(torch.equal(u1, u2) and s1["residuals"] == s2["residuals"]
              and s1["final_residual"] == s2["final_residual"]
              and s1["cg_iters"] == s2["cg_iters"],
              f"{tag} {route}: two runs differ ({s1['cg_iters']} / "
              f"{s2['cg_iters']}, {s1['residuals']} / {s2['residuals']})")
        check(bool(torch.isfinite(u1).all()), f"{tag} {route}: non-finite u")
        check(s1["final_residual"] < s1["residuals"][0],
              f"{tag} {route}: the residual did not fall: "
              f"{s1['residuals']} -> {s1['final_residual']}")
        enq_ = sum(s1["cg_enqueued"])
        steps = s1["newton_iters"]
        if route == "fused":
            ok = (l1["lane_fused_gen_mq"] >= enq_
                  and l1["lane_fused_gen"] == l1["lane_fused_elem"] == 0
                  and l1["lane_gather_cm"] <= steps
                  and l1["lane_scatter_cm"] <= steps)
        else:
            ok = (l1["lane_gather_cm"] >= enq_ and l1["lane_scatter_cm"]
                  >= enq_ and l1["lane_fused_gen_mq"] == 0)
        check(ok and enq_ > 0 and l1["lane_pass_update"] >= 2 * enq_,
              f"{tag} {route}: launches {l1} for {enq_} CG iterations")
        out_p[route] = dict(
            newton_iters=steps, cg_iters=s1["cg_iters"],
            cg_enqueued=s1["cg_enqueued"], residuals=s1["residuals"],
            final_residual=s1["final_residual"], run_seconds=[t1, t2],
            cg_seconds=s1["cg_seconds"],
            ms_per_cg_iter=1e3 * s1["cg_seconds"] / max(enq_, 1),
            peak_bytes=[m1, m2], launches=l1, bitwise_equal_twice=True,
            cg_iteration=cg_profile.profile_cg_iteration(eng, ccs[route],
                                                         20))
        runs_p[route] = (u1, s1)
    (uf, sf), (us, ss) = runs_p["fused"], runs_p["staged"]
    check(sf["newton_iters"] == ss["newton_iters"]
          and len(sf["cg_iters"]) == len(ss["cg_iters"])
          and all(abs(a - b) <= 1 for a, b in zip(sf["cg_iters"],
                                                  ss["cg_iters"])),
          f"{tag}: fused {sf['newton_iters']} / {sf['cg_iters']}, staged "
          f"{ss['newton_iters']} / {ss['cg_iters']}")
    out_p["u_rel_fused_vs_staged"] = float((uf - us).abs().max()
                                           / us.abs().max())
    # both routes may stop at the cap: their final residuals within 2x
    ratio = sf["final_residual"] / ss["final_residual"]
    out_p["final_residual_ratio_fused_vs_staged"] = ratio
    check(0.5 <= ratio <= 2.0, f"{tag}: final residual fused "
          f"{sf['final_residual']} against staged {ss['final_residual']}")
    return out_p


# (b) Q2 box(40) fused against staged: one Newton step of at most 500 CG
# (the staged route stalls at 800, so both reach the cap)
t0 = time.perf_counter()
MQ_CAP = SolverConfig(newton_maxit=1, cg_maxit=500, preconditioner="jacobi")
q2_pair = mq_pair("Q2 box(40)", {"fused": eng_q2f, "staged": eng_q2},
                  {"fused": cc_q2f, "staged": cc_q2}, MQ_CAP)
launches_mq_gen = q2_pair["fused"]["launches"]
mq_secs["q2_pair"] = time.perf_counter() - t0
del eng_q2f, cc_q2f
torch.cuda.empty_cache()
# (c) the body-loaded P2 damage square fused against staged, 2 x <= 300 CG
t0 = time.perf_counter()
eng_p2s = LaneEngine(F_p2, bcs_p2, plan=plan_p2, device=DEV,
                     dtype=torch.float32)
cc_p2s = eng_p2s.prepare_coeffs(co_p2)
torch.cuda.synchronize()
mq_setup["p2_staged_engine"] = time.perf_counter() - t0
t0 = time.perf_counter()
p2_pair = mq_pair(f"P2 loaded unit_square({N_P2})",
                  {"fused": eng_p2f, "staged": eng_p2s},
                  {"fused": cc_p2f, "staged": cc_p2s},
                  SolverConfig(cg_rtol=1e-8, newton_rtol=1e-6,
                               cg_maxit=FULL_CG_MAXIT,
                               newton_maxit=FULL_NEWTON_MAXIT,
                               preconditioner="jacobi"))
p2_pair.update(n=N_P2, n_dofs=V_p2.n_dofs, n_cells=int(V_p2.mesh.n_cells),
               lane_cells=plan_p2.G * plan_p2.kc * 128, G=plan_p2.G,
               kc=plan_p2.kc, wg=plan_p2.wg,
               index_type=str(eng_p2f.gather_idx.dtype))
mq_secs["p2_pair"] = time.perf_counter() - t0
del eng_p2f, eng_p2s, cc_p2f, cc_p2s, F_p2, bcs_p2, V_p2, plan_p2
torch.cuda.empty_cache()
# the kernels line: K4-gen-mq timed at the Q2 box(40) shapes (its bound
# with the real cells' rows: the kernel skips padding lane cells), its
# launches those of the first fused solve of (b)
lq = k4mq["q2_box40"]
record("lane_fused_gen_mq", 0.0, lq["grad"]["ms"], lq["grad"]["plain_ms"],
       lq["grad"]["bound_bytes_real_cells"], None,
       ms_range=lq["grad"]["ms_range"], jvp_ms=lq["jvp"]["ms"],
       jvp_plain_ms=lq["jvp"]["plain_ms"],
       jvp_bound_ms=lq["jvp"]["bound_ms_real_cells"],
       bound_ms_all_lane_cells=lq["grad"]["bound_ms"],
       jvp_bound_ms_all_lane_cells=lq["jvp"]["bound_ms"],
       geometry=lq["grad"]["geometry"], jvp_geometry=lq["jvp"]["geometry"])
results["lane_fused_gen_mq"].update(
    bound_ms=lq["grad"]["bound_ms_real_cells"],
    bound_by=lq["grad"]["bound_by_real_cells"])
mq_gen = dict(
    kernel=k4mq, edges=mq_edges, build=mq_build, setup_s=mq_setup,
    staged_vs_fused_tangent_q2=q2_apply, q2_fused_vs_staged=q2_pair,
    p2_fused_vs_staged=p2_pair, seconds_by_part=mq_secs,
    op_histogram={"q2": phys_q2[torch.float32].histogram(),
                  "p2_loaded": phys_p2[torch.float32].histogram()},
    tolerance="K4-gen-mq against its plain version: exactly equal in every "
              "dtype, index type and mode; the staged Q2 tangent against "
              "the fused one (float32, two orders of one sum): rel <= "
              "1e-5; fused against staged: same Newton count, CG +-1 a "
              "step, final residuals within 2x, each twice bitwise "
              "equal, the residual falls; card against CPU (float64, "
              "converged; staged card and fused card against the staged "
              "CPU run): same Newton count, CG +-1 a step, u rel <= 1e-9",
    seconds=time.perf_counter() - t_mq)
del phys_q2, phys_p2, phys_edge, MQ_EDGE_PHYS
emit("multiqp", check_card_vs_cpu=mq_small, full=dict(
    problem="benchmarks/q2hex_bench.py, Q2 hexes box(40), float32, staged "
            "engine, Jacobi, 1 Newton step of at most 2000 CG",
    n_dofs=V_q2.n_dofs, n_cells=int(mesh_q2.n_cells), lane_cells=M_q2,
    nq=mq.nq, nv=mq.nv, nr=mq.nr, G=plan_q2.G, kc=plan_q2.kc,
    wg=plan_q2.wg, owner_passes=len(eng_q2.owner_wrs),
    refresh_passes=len(eng_q2.refresh_wrs),
    tail_copies=0 if eng_q2._tail_copy is None
    else int(len(eng_q2._tail_copy)),
    setup_s=q2_setup, table_bytes=nbytes(eng_q2.geom_dN, eng_q2.geom_w,
                                         eng_q2.geom_xq),
    linearize_s=lin_s, diagonal_s=diag_s,
    newton_iters=mq_st1["newton_iters"], cg_iters=mq_st1["cg_iters"],
    cg_enqueued=mq_st1["cg_enqueued"], residuals=mq_st1["residuals"],
    final_residual=mq_st1["final_residual"],
    cg_seconds=mq_st1["cg_seconds"], run_seconds=[mq_s1, mq_s2],
    ms_per_cg_iter=1e3 * mq_st1["cg_seconds"] / max(enq, 1),
    peak_bytes=[mq_peak1, mq_peak2], launches=launches_mq,
    bitwise_equal_twice=True),
    cg_iteration=prof_q2, tangent_bound_bytes=q2_bytes,
    tangent_bound_ms=q2_bound_ms,
    tangent_bound_ms_real_cells=q2_bound_real_ms, fused_gen_mq=mq_gen,
    nvidia_smi=smi)
del eng_q2, plan_q2, F_q2, bcs_q2, mq_u1, mq_u2, u0_q2, u_lin, mq
torch.cuda.empty_cache()

# -- 11c. facets_generic: facet terms and the generic element path -----------

T_TRAC = 1000.0  # the traction of tests/test_facets.py:25
FG_R, FG_N, FG_N_CONV, FG_N_MIXED = 7, 1024, 128, 32


def fg_rel(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float((a - b.to(a.device)).abs().max() / b.abs().max())


def traction_problem(n, dtype, device=DEV):
    """tests/test_facets.py:25 at unit_square(n): plane strain, linear
    elasticity, a traction T_TRAC on x = 1 (a facet term), u_x = 0 on
    x = 0, u_y = 0 on y = 0."""
    mesh_t = unit_square(n)
    V_t = FunctionSpace.create(mesh_t, 1, bs=2)
    right_t = locate_entities_boundary(
        mesh_t, 1, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    F_t = EnergyFunctional(
        V_t, [Term(lambda qp: linear_elastic_psi(qp.eps, 1.0e6, NU), 1)],
        facet_terms=[FacetTerm(lambda f: -T_TRAC * f.u[0], 2,
                               facets=right_t)], device=device, dtype=dtype)
    left_x = locate_dofs_geometrical(V_t, lambda x: np.abs(x[:, 0]) < 1e-12)
    bot_y = locate_dofs_geometrical(V_t, lambda x: np.abs(x[:, 1]) < 1e-12)
    return F_t, [DirichletBC(V_t, left_x, 0.0, components=[0]),
                 DirichletBC(V_t, bot_y, 0.0, components=[1])], V_t


def traction_error(V_t, u_flat):
    """(max error against the plane-strain solution u_x = T(1 - nu^2)/E x,
    u_y = -nu(1 + nu)T/E y; max |u|)."""
    uu = np.asarray(u_flat, dtype=np.float64).reshape(-1, 2)
    x = V_t.dof_coords
    err = max(np.abs(uu[:, 0] - T_TRAC * (1 - NU ** 2) / 1.0e6 * x[:, 0]).max(),
              np.abs(uu[:, 1] + NU * (1 + NU) * T_TRAC / 1.0e6 * x[:, 1]).max())
    return float(err), float(np.abs(uu).max())


def fg_solve(eng, cc, cfg, chunk=200):
    """``make_solver`` from the lifted zero state, timed, with the lane
    kernels' launches of this solve alone."""
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, st = eng.make_solver(cfg, cg_chunk=chunk)(torch.zeros_like(
        eng.bc_lane), cc)
    torch.cuda.synchronize()
    return u, st, time.perf_counter() - t0, K.launch_counts()


def fg_twice(tag, eng, cc, cfg, path):
    """Two solves, bitwise equal in u, residuals and CG counts; every
    kernel of ``path`` launched in each. A staged solve launches no K4; a
    fused one's K1 / K2 run only in the Jacobi diagonal, once a Newton
    step."""
    runs = [fg_solve(eng, cc, cfg) for _ in range(2)]
    (u1, s1, t1, l1), (u2, s2, t2, l2) = runs
    check(torch.equal(u1, u2) and s1["residuals"] == s2["residuals"]
          and s1["cg_iters"] == s2["cg_iters"],
          f"{tag}: two runs differ ({s1['cg_iters']} / {s2['cg_iters']}, "
          f"{s1['residuals']} / {s2['residuals']})")
    check(bool(torch.isfinite(u1).all()), f"{tag}: non-finite u")
    steps = s1["newton_iters"]
    others = ({"lane_gather_cm": steps, "lane_scatter_cm": steps}
              if {"lane_fused_elem", "lane_fused_gen"} & set(path) else {})
    check(all(l1[k] > 0 for k in path)
          and all(l1[k] <= others.get(k, 0) for k in l1 if k not in path),
          f"{tag}: the solve did not run on {path}: {l1}")
    return u1, s1, [t1, t2], l1


t_phase = time.perf_counter()
fg_gen = torch.Generator(device=DEV)
fg_gen.manual_seed(1515)
STAGED_PATH = ("lane_gather_cm", "lane_scatter_cm", "lane_pass_update")
FUSED_PATH = ("lane_fused_elem", "lane_pass_update")

# (c) card against CPU at small sizes, float64: the generic path on Q1
# hexahedra at box(4) (a DG0 modulus, cell terms at quadrature degrees 2
# and 3), and the traction problem at n = FG_N_MIXED under the mixed solver
def q1_generic(device):
    mesh_h = box(4, 4, 4)
    V_h = FunctionSpace.create(mesh_h, 1, bs=3)
    P0_h = FunctionSpace.create(mesh_h, 0, bs=1)
    F_h = EnergyFunctional(V_h, [
        Term(lambda qp: qp.coeff("E") * linear_elastic_psi(qp.eps, 1.0, NU),
             2),
        Term(lambda qp: -1.0e3 * qp.u[0] * qp.x[2], 3)],
        [Coefficient("E", P0_h)], device=device, dtype=torch.float64)
    left_h = locate_dofs_geometrical(V_h, lambda x: np.abs(x[:, 0]) < 1e-12)
    right_h = locate_dofs_geometrical(
        V_h, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    eng_h = LaneEngine(F_h, [DirichletBC(V_h, left_h, [0.0, 0.0, 0.0]),
                             DirichletBC(V_h, right_h, [0.01, 0.0, 0.0])],
                       wg_own=8, device=device, dtype=torch.float64)
    check(eng_h.path == "generic", f"Q1 box(4): on the {eng_h.path} path")
    E_h = 1.0e6 * (1.0 + np.random.default_rng(15).uniform(
        size=mesh_h.n_cells))
    u_h, st_h = eng_h.make_solver(SolverConfig(
        cg_rtol=1e-12, newton_rtol=1e-10, cg_maxit=3000), cg_chunk=200)(
        torch.zeros_like(eng_h.bc_lane), eng_h.prepare_coeffs({"E": E_h}))
    return eng_h.from_lane(u_h), st_h


def traction_mixed(device):
    F_m, bcs_m, V_m = traction_problem(FG_N_MIXED, torch.float64, device)
    eng_m = LaneEngine(F_m, bcs_m, wg_own=8, device=device,
                       dtype=torch.float32)
    u_m, st_m = eng_m.make_mixed_solver(SolverConfig(
        cg_rtol=1e-8, newton_rtol=1e-10, cg_maxit=4000, newton_maxit=30),
        cg_chunk=200)(torch.zeros(V_m.n_dofs, dtype=torch.float64,
                                  device=device), {}, eng_m.prepare_coeffs({}))
    return u_m.cpu().numpy(), st_m, V_m


fg_small = {}
for tag, fn in (("generic_q1_box4", q1_generic),
                ("traction_mixed_n32", traction_mixed)):
    out_d, out_c = fn(DEV), fn("cpu")
    (u_d, s_d), (u_c, s_c) = out_d[:2], out_c[:2]
    u_rel = fg_rel(u_d, u_c)
    check(s_d["converged"] and s_c["converged"]
          and s_d["newton_iters"] == s_c["newton_iters"]
          and all(abs(a - b) <= 1 for a, b in zip(s_d["cg_iters"],
                                                  s_c["cg_iters"]))
          and u_rel <= 1e-9,
          f"facets_generic {tag}: card {s_d['newton_iters']} / "
          f"{s_d['cg_iters']}, CPU {s_c['newton_iters']} / {s_c['cg_iters']},"
          f" u rel {u_rel:.3e}")
    fg_small[tag] = dict(newton_card=s_d["newton_iters"],
                         newton_cpu=s_c["newton_iters"],
                         cg_card=s_d["cg_iters"], cg_cpu=s_c["cg_iters"],
                         u_rel=u_rel)
    if tag.startswith("traction"):
        fg_small[tag]["analytic_error"] = traction_error(out_d[2], u_d)
secs_fg_c = time.perf_counter() - t_phase

# (a) the reference study's functional (mechanic2d.setup at r = FG_R: asym
# damage at degree 1, the volumetric load at degree 2) on the lane engine's
# generic path, staged, float64
t0 = time.perf_counter()
asm_g, c_g, V_g, mesh_g, _ = mechanic2d.setup(
    Mechanic2DConfig(max_refine=FG_R), device=DEV, dtype=torch.float64)
torch.cuda.synchronize()
g_setup = dict(mechanic2d_setup=time.perf_counter() - t0)
t0 = time.perf_counter()
plan_g = build_lane_plan(V_g.dof_coords, np.asarray(V_g.dofmap), wg_own=32)
g_setup["plan"] = time.perf_counter() - t0
t0 = time.perf_counter()
eng_g = LaneEngine(asm_g.functional, asm_g.bcs, plan=plan_g, device=DEV,
                   dtype=torch.float64)
torch.cuda.synchronize()
g_setup["engine_tables_x_lane"] = time.perf_counter() - t0
check(eng_g.path == "generic", f"mechanic2d r = {FG_R}: on the "
      f"{eng_g.path} path, not the generic one")
# K2 at this plan (the engine's table), both dtypes and index types,
# exactly equal to its plain version; in float64, the path's type, timed
# beside its bound and the index_add_ yardstick
kw_g = dict(k_out=plan_g.wg, n_ch=eng_g.bs)
# (a stream of its own, not fg_gen's: every later input stays the same)
fg_k2_gen = torch.Generator(device=DEV)
fg_k2_gen.manual_seed(19)
for vdt in (torch.float64, torch.float32):
    src = torch.randn((plan_g.nv * eng_g.bs, plan_g.G, plan_g.kc, 128),
                      dtype=vdt, device=DEV, generator=fg_k2_gen)
    for idt in (torch.int8, torch.int32):
        ix = eng_g.gather_idx.to(idt)
        tab = (eng_g.scatter_table if ix is eng_g.gather_idx
               else K.scatter_cm_table(ix, plan_g.wg))
        out = K.lane_scatter_cm(src, ix, table=tab, **kw_g)
        torch.cuda.synchronize()
        ref = K.lane_scatter_cm_plain(src, ix, **kw_g)
        check(torch.equal(out, ref), f"lane_scatter_cm generic r = {FG_R} "
              f"{vdt} {idt}: {float((out - ref).abs().max())}")
    if vdt == torch.float64:
        ix = eng_g.gather_idx
        ms_r = median_ms(lambda: K.lane_scatter_cm(
            src, ix, table=eng_g.scatter_table, **kw_g), 20)
        t0 = time.perf_counter()
        K.scatter_cm_table(ix, plan_g.wg)
        rb = SB.real_entry_bytes(src, ix, eng_g.scatter_table, out)
        k2_generic = dict(
            ms=ms_r[0], ms_range=ms_r, table_host_seconds=(
                time.perf_counter() - t0),
            plain_ms=time_ms(lambda: K.lane_scatter_cm_plain(
                src, ix, **kw_g), 1),
            bound_ms=nbytes(src, ix, out) / HBM_BYTES_PER_S * 1e3,
            real_bound_ms=rb / HBM_BYTES_PER_S * 1e3,
            library_ms=time_ms(SB.index_add_yardstick(src, ix, ref), 10),
            table_bytes=eng_g.scatter_table.nbytes,
            geometry=K.scatter_cm_geometry(plan_g.wg, eng_g.bs, plan_g.nv,
                                           plan_g.kc, 8))
    del src, out, ref
t0 = time.perf_counter()
cc_g = eng_g.prepare_coeffs(c_g)
torch.cuda.synchronize()
g_setup["prepare_coeffs"] = time.perf_counter() - t0
free_g = asm_g.free_mask(torch.float64) > 0
u0_g = asm_g.set_bc(torch.zeros(V_g.n_dofs, dtype=torch.float64, device=DEV))
ur_g = u0_g + 1e-3 * torch.randn(V_g.n_dofs, dtype=torch.float64,
                                 device=DEV, generator=fg_gen) * free_g
v_g = torch.randn(V_g.n_dofs, dtype=torch.float64, device=DEV,
                  generator=fg_gen)
g_parity = {}
for tag, uf in (("u0", u0_g), ("random", ur_g)):
    ul = eng_g.to_lane_dev(uf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lin_g = eng_g.linearize(ul, cc_g)
    torch.cuda.synchronize()
    lin_s = time.perf_counter() - t0
    got = dict(
        residual=eng_g.from_lane_dev(eng_g.residual(ul, cc_g)),
        tangent=eng_g.from_lane_dev(eng_g.make_tangent(ul, cc_g, lin_g)(
            eng_g.to_lane_dev(v_g))),
        diagonal=eng_g.from_lane_dev(eng_g.diagonal(ul, cc_g, lin_g))[free_g])
    del lin_g
    ref = dict(residual=asm_g.residual(uf, c_g, batch=ELEMENT_BATCH),
               tangent=asm_g.tangent_action(uf, c_g, v_g),
               diagonal=asm_g.diagonal(uf, c_g)[free_g])
    g_parity[tag] = {k: fg_rel(got[k], ref[k]) for k in got}
    g_parity[tag]["linearize_s"] = lin_s
    check(all(g_parity[tag][k] <= 1e-12 for k in got),
          f"mechanic2d r = {FG_R} generic engine against the flat "
          f"Assembler at {tag}: {g_parity[tag]}")
    del got, ref, ul
del ur_g, v_g
torch.cuda.empty_cache()
# the solve: Jacobi at the reference's rtol 1e-12, capped at 2 Newton
# steps of at most 1 000 CG (2 000, phase mechanic2d's cap, until the
# multi-point generated K4 took the script's time), twice
cfg_g = SolverConfig(newton_maxit=2, cg_maxit=1000)
torch.cuda.reset_peak_memory_stats()
u_g, st_g, secs_g, launches_g = fg_twice(
    f"mechanic2d r = {FG_R} generic", eng_g, cc_g, cfg_g, STAGED_PATH)
peak_g = torch.cuda.max_memory_allocated()
check(st_g["final_residual"] < st_g["residuals"][0],
      f"mechanic2d r = {FG_R} generic: the residual did not fall: "
      f"{st_g['residuals']} -> {st_g['final_residual']}")
prof_g = cg_profile.profile_cg_iteration(eng_g, cc_g, 10)
M_g = plan_g.G * plan_g.kc * 128
nd_g = plan_g.nv * eng_g.bs
# one generic tangent application's least traffic: the element matrices
# once, the gathered cell values and the element vectors written and read
# once each, the state read and written
g_bytes = dict(element_matrices=nd_g * nd_g * M_g * 8,
               cell_vectors=4 * nd_g * M_g * 8,
               state=2 * eng_g.bs * plan_g.R * 128 * 8)
prof_g.update(tangent_bound_bytes=g_bytes, tangent_bound_ms=sum(
    g_bytes.values()) / HBM_BYTES_PER_S * 1e3)
fg_generic = dict(
    problem=f"mechanic2d.setup(max_refine={FG_R}) (square.msh), its "
            "functional on LaneEngine: generic path, staged, float64, "
            "Jacobi, 2 Newton steps of at most 1000 CG",
    n_dofs=V_g.n_dofs, n_cells=int(mesh_g.n_cells), lane_cells=M_g,
    G=plan_g.G, kc=plan_g.kc, wg=plan_g.wg,
    owner_passes=len(eng_g.owner_wrs), refresh_passes=len(eng_g.refresh_wrs),
    setup_s=g_setup, x_lane_bytes=nbytes(eng_g.x_lane), parity=g_parity,
    newton_iters=st_g["newton_iters"], cg_iters=st_g["cg_iters"],
    cg_enqueued=st_g["cg_enqueued"], residuals=st_g["residuals"],
    final_residual=st_g["final_residual"], cg_seconds=st_g["cg_seconds"],
    run_seconds=secs_g, ms_per_cg_iter=1e3 * st_g["cg_seconds"] / max(
        sum(st_g["cg_enqueued"]), 1),
    peak_bytes=peak_g, launches=launches_g, bitwise_equal_twice=True,
    cg_iteration=prof_g, k2_float64=k2_generic)
del eng_g, asm_g, c_g, cc_g, plan_g, u_g, u0_g, free_g, mesh_g, V_g
torch.cuda.empty_cache()

# (b) the traction-loaded square at full width: unit_square(FG_N), P1,
# float32, Jacobi, capped like the polycrystal's Jacobi solves, fused (K4,
# K3) and staged (K1-K3) on one plan, twice each
t0 = time.perf_counter()
F_t, bcs_t, V_t = traction_problem(FG_N, torch.float32)
t_setup = dict(problem=time.perf_counter() - t0)
t0 = time.perf_counter()
plan_t = build_lane_plan(V_t.dof_coords, np.asarray(V_t.dofmap), wg_own=16)
t_setup["plan"] = time.perf_counter() - t0
cfg_t = SolverConfig(newton_maxit=FULL_NEWTON_MAXIT, cg_maxit=FULL_CG_MAXIT,
                     cg_rtol=1e-8, newton_rtol=1e-6)
fg_traction, launches_t = {}, {}
for name, fused, path in (("fused", True, FUSED_PATH),
                          ("staged", False, STAGED_PATH)):
    t0 = time.perf_counter()
    eng_t = LaneEngine(F_t, bcs_t, plan=plan_t, fused=fused, device=DEV,
                       dtype=torch.float32)
    cc_t = eng_t.prepare_coeffs({})
    torch.cuda.synchronize()
    setup_t = time.perf_counter() - t0
    u_t, st_t, secs_t, launches_t[name] = fg_twice(
        f"traction n = {FG_N} {name}", eng_t, cc_t, cfg_t, path)
    err_t, umax_t = traction_error(V_t, eng_t.from_lane_dev(u_t).cpu())
    prof_t = cg_profile.profile_cg_iteration(eng_t, cc_t, 20)
    fp = prof_t["facet_part"]
    fg_traction[name] = dict(
        engine_setup_s=setup_t, newton_iters=st_t["newton_iters"],
        cg_iters=st_t["cg_iters"], residuals=st_t["residuals"],
        final_residual=st_t["final_residual"], run_seconds=secs_t,
        ms_per_cg_iter=1e3 * st_t["cg_seconds"] / max(
            sum(st_t["cg_enqueued"]), 1),
        analytic_error_at_cap=err_t, max_abs_u=umax_t,
        launches=launches_t[name], bitwise_equal_twice=True,
        facet_part=fp, cg_iteration=prof_t)
    del eng_t, cc_t, u_t
fg_traction.update(setup_s=t_setup, n_dofs=V_t.n_dofs,
                   n_facets=int(len(F_t.facet_terms[0].facets)),
                   lane_cells=plan_t.G * plan_t.kc * 128)
del F_t, bcs_t, plan_t
torch.cuda.empty_cache()
# ... and at n = FG_N_CONV to convergence in float64, against the analytic
# solution
F_c, bcs_c, V_c = traction_problem(FG_N_CONV, torch.float64)
eng_c = LaneEngine(F_c, bcs_c, wg_own=16, device=DEV, dtype=torch.float64)
u_c, st_c, secs_c, _ = fg_solve(eng_c, eng_c.prepare_coeffs({}),
                                SolverConfig(cg_rtol=1e-12, newton_rtol=1e-10,
                                             cg_maxit=20000))
err_c, umax_c = traction_error(V_c, eng_c.from_lane_dev(u_c).cpu())
check(st_c["converged"] and err_c <= 1e-9 * umax_c,
      f"traction n = {FG_N_CONV} float64: converged {st_c['converged']}, "
      f"error {err_c:.3e} against max |u| {umax_c:.3e}")
fg_traction["converged_n128_float64"] = dict(
    n_dofs=V_c.n_dofs, newton_iters=st_c["newton_iters"],
    cg_iters=st_c["cg_iters"], seconds=secs_c, analytic_error=err_c,
    max_abs_u=umax_c)
del F_c, bcs_c, V_c, eng_c, u_c
torch.cuda.empty_cache()
emit("facets_generic", card_vs_cpu=fg_small, generic_mechanic2d=fg_generic,
     traction=fg_traction,
     tolerance="generic engine against the flat Assembler (float64, card): "
               "rel <= 1e-12 (diagonal on free dofs); card against CPU "
               "(float64): same Newton count, CG +-1 a step, u rel <= 1e-9; "
               "full width: two runs bitwise equal, each on its kernels "
               "alone; n = 128 float64: analytic error <= 1e-9 max |u|",
     seconds_by_part=dict(card_vs_cpu=secs_fg_c),
     nvidia_smi=smi, seconds=time.perf_counter() - t_phase)

# -- 11d. fused_gen: K4 generated from the elementwise energy ----------------

GEN_N3 = 87  # benchmarks/lane3d_bench.py's bar: P1 tetrahedra, 2 044 416 dofs
# card against CPU, float64: the loaded polycrystal at n = 16 with 6
# grains (6 Newton steps, ~880 CG; the CPU's plain version takes ~6 s)
# and the bar at box(6)
GEN_N_SMALL, GEN_GRAINS_SMALL, GEN_N3_SMALL = 16, 6, 6
GEN_PATH = ("lane_fused_gen", "lane_pass_update")


def loaded_damage_psi(qp):
    """The polycrystal's energy with the study's body load in the
    integrand: x-using, so no hand-written law takes it."""
    return (asym_damage_psi(qp.eps, qp.coeff("d"), qp.coeff("E"), NU)
            - body_load_x(qp.x) * qp.u[0])


def loaded_polycrystal(mesh_, device, dtype):
    """``run``'s space, coefficients (damage P1, modulus P0) and BCs with
    :func:`loaded_damage_psi` as the one cell term."""
    V_b = FunctionSpace.create(mesh_, 1, bs=2)
    F_b = EnergyFunctional(
        V_b, [Term(loaded_damage_psi, 1)],
        [Coefficient("d", FunctionSpace.create(mesh_, 1, bs=1)),
         Coefficient("E", FunctionSpace.create(mesh_, 0, bs=1))],
        device=device, dtype=dtype)
    left_b = locate_dofs_geometrical(V_b, lambda x: np.abs(x[:, 0]) < 1e-12)
    right_b = locate_dofs_geometrical(
        V_b, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    return F_b, [DirichletBC(V_b, left_b, [0.0, 0.0]),
                 DirichletBC(V_b, right_b, [0.01, 0.0])], V_b


def elastic_bar3d(n, device, dtype):
    """benchmarks/lane3d_bench.py's problem: box(n)^3 of P1 tetrahedra,
    linear elasticity, x = 0 clamped, x = 1 pulled by 0.01."""
    mesh_3 = box(n, n, n, cell_type="tetra")
    V_3 = FunctionSpace.create(mesh_3, 1, bs=3)
    F_3 = EnergyFunctional(
        V_3, [Term(lambda qp: linear_elastic_psi(qp.eps, 1.0e6, NU), 1)],
        device=device, dtype=dtype)
    left_3 = locate_dofs_geometrical(V_3, lambda x: np.abs(x[:, 0]) < 1e-12)
    right_3 = locate_dofs_geometrical(
        V_3, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    return F_3, [DirichletBC(V_3, left_3, [0.0, 0.0, 0.0]),
                 DirichletBC(V_3, right_3, [0.01, 0.0, 0.0])], V_3


def gen_twice(tag, eng, cc, cfg):
    """:func:`fg_twice` on the generated route: two solves bitwise equal,
    K4-gen and K3 launched in the first, K1 / K2 only in the Jacobi
    diagonal and no hand-written K4."""
    u1, s1, secs, l1 = fg_twice(tag, eng, cc, cfg, GEN_PATH)
    check(l1["lane_fused_elem"] == 0 and l1["lane_fused_gen"] >= sum(
        s1["cg_enqueued"]), f"{tag}: launches {l1} for {s1['cg_enqueued']}")
    return u1, s1, secs, l1


def gen_summary(st, secs, launches_, prof):
    return dict(newton_iters=st["newton_iters"], cg_iters=st["cg_iters"],
                residuals=st["residuals"],
                final_residual=st["final_residual"], run_seconds=secs,
                ms_per_cg_iter=1e3 * st["cg_seconds"] / max(
                    sum(st["cg_enqueued"]), 1),
                launches=launches_, bitwise_equal_twice=True,
                fused_route=prof["fused_route"], cg_iteration=prof)


def gen_pair(tag, eng_fused, coeffs_, cfg):
    """The problem of the fused (generated) engine ``eng_fused`` on that
    engine and on a staged one of its plan, each solved twice: the same
    Newton count and CG +-1 a step."""
    out_p, runs = {}, {}
    for name, fused in (("fused_gen", True), ("staged", False)):
        t0 = time.perf_counter()
        eng = eng_fused if fused else LaneEngine(
            eng_fused.functional, eng_fused.bcs, plan=eng_fused.plan,
            device=DEV, dtype=torch.float32)
        cc_ = eng.prepare_coeffs(coeffs_)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if fused:
            check(eng.fused_law is None, f"{tag}: a hand-written law took it")
            u_, st_, secs_, l_ = gen_twice(f"{tag} {name}", eng, cc_, cfg)
        else:
            u_, st_, secs_, l_ = fg_twice(f"{tag} {name}", eng, cc_, cfg,
                                          STAGED_PATH)
        prof_ = cg_profile.profile_cg_iteration(eng, cc_, 20)
        out_p[name] = dict(engine_setup_s=setup_s,
                           **gen_summary(st_, secs_, l_, prof_))
        runs[name] = st_
        del eng, cc_, u_
        torch.cuda.empty_cache()
    a, b = runs["fused_gen"], runs["staged"]
    check(a["newton_iters"] == b["newton_iters"]
          and all(abs(x - y) <= 1 for x, y in zip(a["cg_iters"],
                                                  b["cg_iters"])),
          f"{tag}: fused {a['newton_iters']} / {a['cg_iters']}, staged "
          f"{b['newton_iters']} / {b['cg_iters']}")
    return out_p


t_phase = time.perf_counter()
gen_setup = {}
# the polycrystal's own fused engine on the n = 1024 plan: it still takes
# the hand-written law (and serves (a) its inputs)
t0 = time.perf_counter()
eng_h = LaneEngine(F_full, bcs_full, plan=p, fused=True, device=DEV,
                   dtype=torch.float32)
cc_h = eng_h.prepare_coeffs({"d": d_full, "E": E_full})
torch.cuda.synchronize()
gen_setup["polycrystal_engine"] = time.perf_counter() - t0
check(eng_h.fused_law is not None,
      "the polycrystal engine no longer takes its hand-written law")
# (b) the polycrystal at full width with the study's body load in the
# integrand: run's mesh, damage, per-grain E and BCs on the n = 1024 plan
t0 = time.perf_counter()
F_b, bcs_b, V_b = loaded_polycrystal(mesh_full, DEV, torch.float32)
eng_b = LaneEngine(F_b, bcs_b, plan=p, fused=True, device=DEV,
                   dtype=torch.float32)
cc_b = eng_b.prepare_coeffs({"d": d_full, "E": E_full})
torch.cuda.synchronize()
gen_setup["polycrystal_engine_trace"] = time.perf_counter() - t0
phys_b = {dt: eng_b.fused_gen(dt) for dt in (torch.float32, torch.float64)}
check(eng_b.fused_law is None and phys_b[torch.float32].x_rows
      and eng_b.fused_geom.shape[1] == 9,
      f"loaded polycrystal: law {eng_b.fused_law}, geometry rows "
      f"{eng_b.fused_geom.shape}")
# (a) the polycrystal's own law, generated (the engine takes it by hand)
t0 = time.perf_counter()
phys_law = {dt: GenPhysics(
    lambda qp: asym_damage_psi(qp.eps, qp.coeff("d"), qp.coeff("E"), NU),
    bs=2, gd=2, nv=3, coeff_meta=(("d", 3, 1), ("E", 1, 1)), dtype=dt)
    for dt in (torch.float32, torch.float64)}
gen_setup["law_trace"] = time.perf_counter() - t0
# (c) the 3D bar: mesh, space, plan, engines
t0 = time.perf_counter()
F_3, bcs_3, V_3 = elastic_bar3d(GEN_N3, DEV, torch.float32)
gen_setup["bar3d_mesh_space"] = time.perf_counter() - t0
t0 = time.perf_counter()
plan_3 = build_lane_plan(V_3.dof_coords, np.asarray(V_3.dofmap), wg_own=32)
gen_setup["bar3d_plan"] = time.perf_counter() - t0
t0 = time.perf_counter()
eng_3 = LaneEngine(F_3, bcs_3, plan=plan_3, fused=True, device=DEV,
                   dtype=torch.float32)
torch.cuda.synchronize()
gen_setup["bar3d_engine_trace"] = time.perf_counter() - t0
phys_3 = {dt: eng_3.fused_gen(dt) for dt in (torch.float32, torch.float64)}
check(eng_3.fused_law is None and not phys_3[torch.float32].x_rows,
      f"3D bar: law {eng_3.fused_law}, x rows {phys_3[torch.float32].x_rows}")


def op_table_psi(qp):
    """Every operation of the emitter's table on the card: pow at 2, 3,
    -2, 0.5, -0.5, -1 and a general exponent, reciprocal, division by a
    number, log, clamp, where, comparisons, rsub."""
    g = qp.grad_u
    s = qp.u * qp.u
    return ((g[0, 0] ** 3 + (g[0, 1] * g[0, 1] + 1.0) ** -2
             + (s + 1.0) ** 0.5 + (s + 2.0) ** -0.5 + 1.0 / (qp.u + 3.0)
             + (s + 1.0) ** 1.5 + torch.log(s + 2.0) + (s + 1.0) ** -1) / 3.0
            + torch.clamp(g[0, 0], min=0.0) ** 2 + (1.0 - s) * qp.x[1]
            + torch.where(g[0, 1] > 0.1, g[0, 1] * qp.x[0], -g[0, 1]) / 0.52)


phys_ops = {dt: GenPhysics(op_table_psi, bs=1, gd=2, nv=3, coeff_meta=(),
                           dtype=dt) for dt in (torch.float32, torch.float64)}
P3 = eng_3.plan
K4G_EDGES = {  # tag: (bins, K, wr, window to the last row)
    "K=13": (37, 13, 40, False),
    "K=1": (5, 1, 9, False),
    "window past the last row": (7, 16, 40, True),
    "int8 window of 126 rows": (4, 32, 126, False),
    "3D window of 300 rows, global memory": (3, 8, 300, True),
}
items = {}  # unit source -> what it serves
for dt in (torch.float32, torch.float64):
    for idt in (torch.int8, torch.int32):
        its = [("polycrystal law", phys_law, p.wg),
               ("loaded polycrystal", phys_b, p.wg), ("3D bar", phys_3, P3.wg)]
        its += [(f"{tag_u} edge {t_}", ph, w)
                for t_, (_, _, w, _) in K4G_EDGES.items()
                for tag_u, ph in (("op table", phys_ops), ("3D bar", phys_3))
                if w < 127 or idt == torch.int32]
        for tag_u, ph, w in its:
            items.setdefault(K.fused_gen_source(ph[dt], idt, w), []).append(
                f"{tag_u} {dt} {idt}")
t0 = time.perf_counter()
gen_build = gen_prebuild(items)
gen_build.update(
    spill_units=sum(1 for u_ in gen_build["units"]
                    if any(u_["spill_store_bytes"])),
    registers=sorted({r_ for u_ in gen_build["units"]
                      for r_ in u_["registers"]}))

# (a) the kernel against its plain version on the card: three integrands at
# their path shapes, every dtype, index type and mode, and at edge shapes
k4g = {}
cds_law = {dt: (eng_h.fused_geom.to(dt), cc_h["_cd"].to(dt))
           for dt in (torch.float32, torch.float64)}
main_t = (torch.float32, eng_h.gather_idx.dtype)
k4g["polycrystal_law"] = gen_check(
    "polycrystal law", phys_law, eng_h.gather_starts, eng_h.gather_idx,
    cds_law, p.R, p.wg, (torch.int8, torch.int32), timed=main_t)
# ... beside the hand-written K4 on the same inputs
u_h = 1e-3 * torch.randn((C, p.R, 128), device=DEV, generator=gen)
v_h = torch.randn((C, p.R, 128), device=DEV, generator=gen)
hand_vs_gen = {}
for states in ((u_h,), (u_h, v_h)):
    a_h = (states, eng_h.gather_starts, eng_h.gather_idx)
    kw = dict(wr=p.wg, nv=p.nv)
    o_hand = K.lane_fused_elem(*a_h, cds_law[torch.float32],
                               eng_h.fused_law, **kw)
    o_gen = K.lane_fused_gen(*a_h, cds_law[torch.float32],
                             phys_law[torch.float32], **kw)
    hand_vs_gen["jvp" if len(states) == 2 else "grad"] = dict(
        rel=float((o_hand - o_gen).abs().max() / o_hand.abs().max()),
        hand_ms=median_ms(lambda: K.lane_fused_elem(
            *a_h, cds_law[torch.float32], eng_h.fused_law, **kw), 10),
        gen_ms=median_ms(lambda: K.lane_fused_gen(
            *a_h, cds_law[torch.float32], phys_law[torch.float32], **kw),
            10))
    # the same law by two routes, rounded differently (float32): a sanity
    # bound, the number is printed
    check(hand_vs_gen["jvp" if len(states) == 2 else "grad"]["rel"] <= 1e-2,
          f"hand-written against generated K4: {hand_vs_gen}")
del u_h, v_h, o_hand, o_gen
cds_b = {dt: eng_b._fused_cds(cc_b, dt) for dt in (torch.float32,
                                                  torch.float64)}
k4g["loaded_polycrystal"] = gen_check(
    "loaded polycrystal", phys_b, eng_b.gather_starts, eng_b.gather_idx,
    cds_b, p.R, p.wg, (torch.int8, torch.int32), timed=main_t)
cds_3 = {dt: eng_3._fused_cds({}, dt) for dt in (torch.float32,
                                                torch.float64)}
idts_3 = (torch.int8, torch.int32) if P3.wg < 127 else (torch.int32,)
k4g["bar3d"] = gen_check(
    "3D bar", phys_3, eng_3.gather_starts, eng_3.gather_idx, cds_3, P3.R,
    P3.wg, idts_3, timed=(torch.float32, eng_3.gather_idx.dtype))
edges = {}
for tag, (T_, K_, wr_, last) in K4G_EDGES.items():
    R_ = T_ * wr_ + 5
    st_ = edge_rng.integers(0, R_ - wr_ + 1, size=T_)
    if last:
        st_[-1] = R_ - wr_ // 2
    idts = (torch.int8, torch.int32) if wr_ < 127 else (torch.int32,)
    for name_e, phys_e in (("op_table", phys_ops), ("bar3d", phys_3)):
        ph = phys_e[torch.float64]
        ix_ = edge_rng.integers(-1, wr_ + 1, size=(T_, ph.nv, K_, 128))
        geom_ = edge_rng.standard_normal((T_, ph.dg, K_, 128))
        geom_[:, ph.nv * ph.gd] = np.abs(geom_[:, ph.nv * ph.gd])
        cds_e = [geom_]
        if ph.n_coeff_rows:
            cd_ = edge_rng.random((T_, ph.n_coeff_rows, K_, 128))
            cd_[:, 3] = 1e6 * (1.0 + cd_[:, 3])
            cds_e.append(cd_)
        gen_check(f"{name_e} at {tag}", phys_e,
                  on_card(st_, torch.int32), on_card(ix_.astype(np.int32)),
                  {dt: tuple(on_card(c, dt) for c in cds_e)
                   for dt in (torch.float32, torch.float64)}, R_, wr_, idts)
        edges.setdefault(tag, []).append(name_e)

gen_secs = dict(setup=t0 - t_phase, build_and_kernels=time.perf_counter()
                - t0)
t0 = time.perf_counter()
# (b) the loaded polycrystal solved on the generated route and staged
cfg_gen = SolverConfig(cg_rtol=1e-8, newton_rtol=1e-6, cg_maxit=FULL_CG_MAXIT,
                       newton_maxit=FULL_NEWTON_MAXIT, preconditioner="jacobi")
del cc_b
torch.cuda.empty_cache()
gen_b = gen_pair(f"loaded polycrystal n = {N_FULL}", eng_b,
                 {"d": d_full, "E": E_full}, cfg_gen)
launches_gen = gen_b["fused_gen"]["launches"]
del eng_b
torch.cuda.empty_cache()
gen_secs["loaded_polycrystal"] = time.perf_counter() - t0
t0 = time.perf_counter()
# (c) the 3D bar on the generated route and staged
gen_c = gen_pair(f"3D bar n = {GEN_N3}", eng_3, {}, cfg_gen)
gen_secs["bar3d"] = time.perf_counter() - t0
t0 = time.perf_counter()
gen_c.update(n=GEN_N3, n_dofs=V_3.n_dofs, n_cells=int(V_3.mesh.n_cells),
             wr=P3.wg, kc=P3.kc, G=P3.G, lane_cells=P3.G * P3.kc * 128)
del eng_3, F_3, bcs_3, V_3, plan_3
torch.cuda.empty_cache()


# (d) card against CPU, float64, converged: the loaded polycrystal at
# n = GEN_N_SMALL and the 3D bar at n = GEN_N3_SMALL
def gen_small(kind, device):
    if kind == "loaded_polycrystal":
        mesh_s = polycrystal.generate_polycrystal(
            GEN_N_SMALL, n_grains=GEN_GRAINS_SMALL)
        F_s, bcs_s, V_s = loaded_polycrystal(mesh_s, device, torch.float64)
        E_s, d_s = cg_profile.case_inputs(mesh_s)
        coeffs_s = {"d": d_s, "E": E_s}
    else:
        F_s, bcs_s, V_s = elastic_bar3d(GEN_N3_SMALL, device, torch.float64)
        coeffs_s = {}
    eng_s = LaneEngine(F_s, bcs_s, wg_own=16, fused=True, device=device,
                       dtype=torch.float64)
    check(eng_s.fused_law is None, f"{kind}: not on the generated route")
    u_s, st_s = eng_s.make_solver(SolverConfig(
        cg_rtol=1e-10, newton_rtol=1e-9, cg_maxit=20000), cg_chunk=200)(
        torch.zeros_like(eng_s.bc_lane), eng_s.prepare_coeffs(coeffs_s))
    return eng_s.from_lane(u_s), st_s


gen_d = {}
for kind in ("loaded_polycrystal", "bar3d"):
    K.reset_launch_counts()
    (u_d, s_d) = gen_small(kind, DEV)
    l_d = K.launch_counts()
    (u_c, s_c) = gen_small(kind, "cpu")
    u_rel = fg_rel(u_d, u_c)
    check(l_d["lane_fused_gen"] > 0 and s_d["converged"] and s_c["converged"]
          and s_d["newton_iters"] == s_c["newton_iters"]
          and all(abs(a - b) <= 1 for a, b in zip(s_d["cg_iters"],
                                                  s_c["cg_iters"]))
          and u_rel <= 1e-9,
          f"fused_gen {kind}: card {s_d['newton_iters']} / {s_d['cg_iters']}"
          f", CPU {s_c['newton_iters']} / {s_c['cg_iters']}, u rel "
          f"{u_rel:.3e}, launches {l_d}")
    gen_d[kind] = dict(newton_card=s_d["newton_iters"],
                       newton_cpu=s_c["newton_iters"],
                       cg_card=s_d["cg_iters"], cg_cpu=s_c["cg_iters"],
                       u_rel=u_rel, card_launches=l_d)

gen_secs["card_vs_cpu"] = time.perf_counter() - t0
# the kernels line: K4-gen timed at the loaded polycrystal's shapes, its
# launches those of the first fused solve of (b)
lg = k4g["loaded_polycrystal"]
record("lane_fused_gen", 0.0, lg["grad"]["ms"], lg["grad"]["plain_ms"],
       lg["grad"]["bound_bytes"], None, ms_range=lg["grad"]["ms_range"],
       jvp_ms=lg["jvp"]["ms"], jvp_plain_ms=lg["jvp"]["plain_ms"],
       jvp_bound_ms=lg["jvp"]["bound_ms"], geometry=lg["grad"]["geometry"],
       jvp_geometry=lg["jvp"]["geometry"])
results["lane_fused_gen"].update(bound_ms=lg["grad"]["bound_ms"],
                                 bound_by=lg["grad"]["bound_by"])
emit("fused_gen", kernel=k4g, hand_written_vs_generated=hand_vs_gen,
     edges=edges, build=gen_build, setup_s=gen_setup,
     op_histogram={"loaded_polycrystal": phys_b[torch.float32].histogram(),
                   "bar3d": phys_3[torch.float32].histogram(),
                   "op_table": phys_ops[torch.float32].histogram()},
     loaded_polycrystal=gen_b, bar3d=gen_c, card_vs_cpu=gen_d,
     seconds_by_part=gen_secs,
     tolerance="K4-gen against its plain version: exactly equal in every "
               "dtype, index type and mode; hand-written against generated "
               "K4 (float32, two roundings of one law): rel <= 1e-2; fused against staged: same "
               "Newton count, CG +-1 a step, each twice bitwise equal; card "
               "against CPU (float64, converged): same Newton count, CG +-1 "
               "a step, u rel <= 1e-9",
     nvidia_smi=smi, seconds=time.perf_counter() - t_phase)
del F_b, bcs_b, V_b, phys_b, phys_3, phys_law, phys_ops, cds_law, cds_b, cds_3
del eng_h, cc_h
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

# -- 13. flat3d: BASELINE configs 3 and 4 on the flat Newton solver -----------

# elasticity3d: n = 96 hexes (2 738 019 dofs; its element matrices 4.1 GB
# in float64), chosen by the script's time: n = 128 (6 440 067 dofs)
# took 28-30 s a solve, twice, and n = 160 over 74 s a solve on an H100
# (PERF.md); the script's 1 200 s limit now also holds phase fused_gen
N3D_CHECK, N3D_FULL = 6, 96
# neohookean 3D: 375, 46 875 and 352 947 dofs (n = 48, cut from 64 by the
# script's time: 16 s a capped run there, four runs with phase amg's)
NH_CHECK, NH_CONV, NH_FULL, NH_FULL_STEPS = 4, 24, 48, 2


def flat_run(mod, cfg, device):
    """``mod.run(cfg)`` in float64 on ``device``; the result with its
    wall seconds and peak device bytes."""
    if str(device) != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, V, _ = mod.run(cfg, device=device, dtype=torch.float64)
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() if str(device) != "cpu"
            else None)
    return res, V, secs, peak


def flat_summary(res, V, secs, peak):
    return dict(n_dofs=V.n_dofs, newton_iters=res.newton_iters,
                total_cg_iters=res.total_cg_iters,
                final_residual=res.final_residual, r0=res.r0,
                converged=res.converged, seconds=secs, phase_s=res.phase_s,
                ms_per_cg_iter=1e3 * res.phase_s["cg"]
                / max(res.total_cg_iters, 1),
                peak_device_bytes=peak)


t_phase = time.perf_counter()
# (a) card against CPU, float64
flat_checks = {}
for name, mod, cfg in (
        ("elasticity3d_hex_matrix_free", elasticity3d,
         elasticity3d.Elasticity3DConfig(n=N3D_CHECK)),
        ("elasticity3d_hex_assembled", elasticity3d,
         elasticity3d.Elasticity3DConfig(n=N3D_CHECK, matrix_free=False)),
        ("neohookean_3d", neohookean,
         neohookean.NeoHookeanConfig(n=NH_CHECK))):
    rd, Vd, _, _ = flat_run(mod, cfg, DEV)
    rc, _, _, _ = flat_run(mod, cfg, "cpu")
    u_rel = rel(rd.u, rc.u)
    check(rd.converged and rc.converged
          and rd.newton_iters == rc.newton_iters
          and abs(rd.total_cg_iters - rc.total_cg_iters) <= rd.newton_iters
          and u_rel <= 1e-9,
          f"flat3d {name}: card {rd.newton_iters} / {rd.total_cg_iters}, "
          f"CPU {rc.newton_iters} / {rc.total_cg_iters}, u rel {u_rel:.3e}")
    flat_checks[name] = dict(
        n_dofs=Vd.n_dofs, newton_card=rd.newton_iters,
        newton_cpu=rc.newton_iters, cg_card=rd.total_cg_iters,
        cg_cpu=rc.total_cg_iters, u_rel=u_rel,
        final_residual_card=rd.final_residual,
        final_residual_cpu=rc.final_residual)
    del rd, rc

# (b) elasticity3d at full width, matrix-free Chebyshev-CG, twice
cfg_e = elasticity3d.Elasticity3DConfig(n=N3D_FULL)
e_runs = [flat_run(elasticity3d, cfg_e, DEV) for _ in range(2)]
(e0, Ve, *_), (e1, *_) = e_runs
print(json.dumps({"flat3d_elasticity3d": [flat_summary(*r)
                                          for r in e_runs]}), flush=True)
check(e0.converged and torch.equal(e0.u, e1.u)
      and e0.total_cg_iters == e1.total_cg_iters
      and e0.final_residual == e1.final_residual,
      f"elasticity3d n = {N3D_FULL}: not converged or two runs differ "
      f"({e0.total_cg_iters} / {e1.total_cg_iters} CG, "
      f"{e0.final_residual} / {e1.final_residual})")
uu = e0.u.reshape(-1, 3)
check(bool(torch.isfinite(e0.u).all())
      and float(uu[:, 0].max()) <= cfg_e.imposed + 1e-12
      and float(uu[:, 0].min()) > -1e-3,
      "elasticity3d: u not finite or out of the pulled bar's bounds")
e_full = dict(n=N3D_FULL, n_cells=N3D_FULL ** 3, runs=[
    flat_summary(*r) for r in e_runs], bitwise_equal_runs=True)
del e_runs, e0, e1, uu
torch.cuda.empty_cache()
# one CG iteration under the profiler at the solve's first state: the
# element action (one) and the degree-4 Chebyshev polynomial (three more:
# its last step makes no product), Jacobi scaling and the vector updates
asm_e, _, _ = elasticity3d.setup(cfg_e, device=DEV, dtype=torch.float64)
u_e = asm_e.set_bc(torch.zeros(asm_e.n_dofs, dtype=torch.float64,
                               device=DEV))
em_e = asm_e.element_matrices(u_e, {}, batch=ELEMENT_BATCH)
A_e = asm_e.constrained_action(u_e, {}, em_e)
d_e = asm_e.diagonal(u_e, {}, em_e)
lmax_e = float(estimate_lambda_max(A_e, d_e, asm_e.n_dofs))
M_e = chebyshev_preconditioner(A_e, d_e, lmax=lmax_e)
b_e = -asm_e.residual(u_e, {}, batch=ELEMENT_BATCH) * asm_e.free_mask(
    torch.float64)
step_e = mech_cg_step(A_e, M_e, b_e)
prof_e = cg_profile._part(step_e, 3)
_, _, rows_e = cg_profile._device_profile(step_e, 3)
prof_e["top_kernels"] = [
    (name[:60], ms / 3, calls / 3)
    for name, ms, calls in sorted(rows_e, key=lambda r: -r[1])[:8]]
e_bytes = nbytes(em_e)
prof_e.update(element_matrix_bytes=e_bytes, operator_applications=4,
              bound_ms=1e3 * 4 * e_bytes / HBM_BYTES_PER_S,
              lambda_max=lmax_e)
e_full["cg_iteration_profile"] = prof_e
del asm_e, u_e, em_e, A_e, d_e, M_e, b_e, step_e
torch.cuda.empty_cache()
# the hex Hessian alone at n = 64 (262 144 cells) by slab size: seconds
# and the peak above what was allocated before (the element matrices
# themselves, 1.2 GB, and the slabs' temporaries)
asm_h, _, _ = elasticity3d.setup(elasticity3d.Elasticity3DConfig(n=64),
                                 device=DEV, dtype=torch.float64)
u_h = asm_h.set_bc(torch.zeros(asm_h.n_dofs, dtype=torch.float64,
                               device=DEV))
asm_h.element_matrices(u_h, {}, batch=1 << 14)  # warm-up
hess_slabs = []
for batch in (1 << 14, 1 << 16, 1 << 18):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    em_h = asm_h.element_matrices(u_h, {}, batch=batch)
    torch.cuda.synchronize()
    hess_slabs.append(dict(batch=batch, seconds=time.perf_counter() - t0,
                           peak_above_base_bytes=torch.cuda.max_memory_allocated()
                           - base, element_matrix_bytes=nbytes(em_h)))
    del em_h
e_full["hessian_by_slab_n64"] = hess_slabs
del asm_h, u_h
torch.cuda.empty_cache()

# (c) neohookean 3D on the assembled ELL Jacobian with Jacobi, the
# reference's settings, twice each: to convergence at NH_CONV, and at
# full width capped at NH_FULL_STEPS Newton steps (at n >= 32 the
# reference's formulation -- the whole stretch in the last cell layer of
# the initial guess -- does not converge in its 20 steps: PERF.md)
def nh_pair(n, **solver_kw):
    cfg = neohookean.NeoHookeanConfig(n=n)
    for k, v in solver_kw.items():
        setattr(cfg.solver, k, v)
    runs = [flat_run(neohookean, cfg, DEV) for _ in range(2)]
    (r0_, V_, *_), (r1_, *_) = runs
    out = dict(n=n, n_cells=n ** 3, runs=[flat_summary(*r) for r in runs],
               solver=dict(newton_maxit=cfg.solver.newton_maxit,
                           cg_maxit=cfg.solver.cg_maxit,
                           cg_rtol=cfg.solver.cg_rtol,
                           newton_rtol=cfg.solver.newton_rtol))
    print(json.dumps({"flat3d_neohookean": out}), flush=True)
    right = torch.as_tensor(np.abs(V_.dof_coords[:, 0] - 1) < 1e-12,
                            device=DEV)
    check(torch.equal(r0_.u, r1_.u)
          and r0_.total_cg_iters == r1_.total_cg_iters
          and r0_.final_residual == r1_.final_residual
          and bool(torch.isfinite(r0_.u).all())
          and bool((r0_.u.reshape(-1, 3)[right, 0] == cfg.stretch).all()),
          f"neohookean n = {n}: two runs differ, u not finite or the "
          "pulled face moved")
    out["bitwise_equal_runs"] = True
    return out, r0_


nh_conv, r_conv = nh_pair(NH_CONV)
check(r_conv.converged and r_conv.newton_iters >= 2,
      f"neohookean n = {NH_CONV}: not converged")
n_full, _ = nh_pair(NH_FULL, newton_maxit=NH_FULL_STEPS)
n_full["converged_at"] = nh_conv
del r_conv
torch.cuda.empty_cache()
cfg_n = neohookean.NeoHookeanConfig(n=NH_FULL)
# one Jacobi-CG iteration on the ELL matrix at the first state
asm_n, _, _ = neohookean.setup(cfg_n, device=DEV, dtype=torch.float64)
u_n = asm_n.set_bc(torch.zeros(asm_n.n_dofs, dtype=torch.float64,
                               device=DEV))
t0 = time.perf_counter()
asm_n.pattern
pattern_secs = time.perf_counter() - t0
mat_n = asm_n.matrix(u_n, {}, batch=ELEMENT_BATCH)
M_n = jacobi_preconditioner(mat_n.diagonal())
b_n = -asm_n.residual(u_n, {}, batch=ELEMENT_BATCH) * asm_n.free_mask(
    torch.float64)
step_n = mech_cg_step(mat_n.matvec, M_n, b_n)
prof_n = cg_profile._part(step_n, 10)
_, _, rows_n = cg_profile._device_profile(step_n, 10)
prof_n["top_kernels"] = [
    (name[:60], ms / 10, calls / 10)
    for name, ms, calls in sorted(rows_n, key=lambda r: -r[1])[:8]]
# the ELL product reads its values and int32 columns once, x once and
# writes y
ell_bytes = nbytes(mat_n.vals, mat_n.cols) + 2 * nbytes(b_n)
prof_n.update(ell_width=int(mat_n.cols.shape[0]), ell_bytes=ell_bytes,
              matvec_bound_ms=1e3 * ell_bytes / HBM_BYTES_PER_S,
              matvec_ms=median_ms(lambda: mat_n.matvec(b_n), 5),
              pattern_seconds=pattern_secs,
              nnz=asm_n.pattern.nnz)
n_full["cg_iteration_profile"] = prof_n
del asm_n, u_n, mat_n, M_n, b_n, step_n
torch.cuda.empty_cache()
emit("flat3d", check_card_vs_cpu=flat_checks, elasticity3d=e_full,
     neohookean=n_full, path_b=dict(n=N_B, seconds=[secs_b0, secs_b1]),
     tolerance="card against CPU (float64): same Newton count, |d total "
               "CG| <= Newton steps, u rel <= 1e-9; full width: two runs "
               "bitwise equal in u, CG count and final residual",
     nvidia_smi=smi, seconds=time.perf_counter() - t_phase)

# -- 14. amg: Block Jacobi and SA-AMG in the flat and mixed solvers -----------

# (a) card against CPU, float64: tests/test_amg.py's damaged 2D system at
# n = 20 (1 764 dofs) and neohookean 3D at n = 4 (375 dofs), with coarse
# sizes small enough for levels; (b) polycrystal.run(mixed=True) under AMG
# at n = 1024 (run's defaults otherwise, as solve_full_mixed); (c)
# neohookean n = NH_FULL with block Jacobi, capped as in flat3d
AMG_N2D, AMG_COARSE_2D, AMG_COARSE_3D = 20, 64, 24
AMG_FULL_CAP = 2  # Newton steps of the second run
# the polycrystal under AMG at n = 256 (132 098 dofs): cut from n = 1024
# by the script's 1 200 s (there its two runs took 117-134 s, 28-38 s of
# each the host hierarchy, rebuilt by the second; PERF.md), then from
# n = 512 when phase multiqp grew
N_AMG = 256


def amg_damage_system(n, device):
    """tests/test_amg.py's _elastic_system(n, "damage") in float64: the
    assembler, its coefficients and the space."""
    V = FunctionSpace.create(unit_square(n), 1, bs=2)
    DS = FunctionSpace.create(V.mesh, 1, bs=1)
    d = np.zeros(DS.n_dofs)
    d[(DS.dof_coords[:, 1] > 0.45) & (DS.dof_coords[:, 1] < 0.55)] = 0.8
    F = EnergyFunctional(V, [Term(lambda qp: asym_damage_psi(
        qp.eps, qp.coeff("d"), 1.0e6, NU), 1)], [Coefficient("d", DS)],
        device=device, dtype=torch.float64)
    left = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0]) < 1e-12)
    right = locate_dofs_geometrical(V, lambda x: np.abs(x[:, 0] - 1) < 1e-12)
    return (Assembler(F, [DirichletBC(V, left, [0.0, 0.0]),
                          DirichletBC(V, right, [0.01, 0.0])]),
            {"d": torch.as_tensor(d, device=device)}, V)


def amg_systems(device):
    """name -> (assembler, coefficients, space, solver settings)."""
    asm2, c2, V2 = amg_damage_system(AMG_N2D, device)
    nh = neohookean.NeoHookeanConfig(n=NH_CHECK)
    asm3, V3, _ = neohookean.setup(nh, device=device, dtype=torch.float64)
    return {
        "damage2d": (asm2, c2, V2, dict(cg_rtol=1e-10,
                                        amg_coarse_size=AMG_COARSE_2D)),
        "neohookean3d": (asm3, {}, V3, dict(
            cg_rtol=nh.solver.cg_rtol, newton_rtol=nh.solver.newton_rtol,
            newton_maxit=nh.solver.newton_maxit,
            amg_coarse_size=AMG_COARSE_3D)),
    }


def flat_amg_solve(system, solver, pc):
    asm, coeffs, V, kw = system
    cfg = SolverConfig(preconditioner=pc, **kw)
    make = make_newton_solver if solver == "newton" else make_chunked_solver
    u0 = torch.zeros(V.n_dofs, dtype=torch.float64, device=asm.device)
    return make(asm, cfg)(u0, coeffs)


def ell_bytes(m, n_in):
    """Bytes one ELL product moves: values and columns read once, the
    input vector (``n_in`` entries) read once, the output written once."""
    return nbytes(m.vals, m.cols) + m.vals.element_size() * (n_in + m.n_rows)


def vcycle_bytes(h, degree=2):
    """Bytes of one V(degree, degree)-cycle's products: per level
    2 * degree operator products (degree - 1 in the first sweep, which
    starts from zero, one for the residual, degree in the second, whose
    last step makes no product), one restriction and one prolongation;
    and the dense coarse product."""
    total = nbytes(h.coarse_inv)
    for L in h.levels:
        n, nc = L.a.n_rows, L.r.n_rows
        total += (2 * degree * ell_bytes(L.a, n) + ell_bytes(L.r, n)
                  + ell_bytes(L.p, nc))
    return total


t_phase = time.perf_counter()
sys_dev, sys_cpu = amg_systems(DEV), amg_systems("cpu")
amg_checks = {}
for name in sys_dev:
    for solver in ("newton", "chunked"):
        for pc in ("amg", "block_jacobi"):
            rd = flat_amg_solve(sys_dev[name], solver, pc)
            rc = flat_amg_solve(sys_cpu[name], solver, pc)
            u_rel = rel(rd.u, rc.u)
            key = f"{name}_{solver}_{pc}"
            check(rd.converged and rc.converged
                  and rd.newton_iters == rc.newton_iters
                  and abs(rd.total_cg_iters - rc.total_cg_iters)
                  <= rd.newton_iters and u_rel <= 1e-9,
                  f"amg {key}: card {rd.newton_iters} / "
                  f"{rd.total_cg_iters}, CPU {rc.newton_iters} / "
                  f"{rc.total_cg_iters}, u rel {u_rel:.3e}")
            amg_checks[key] = dict(
                newton_card=rd.newton_iters, newton_cpu=rc.newton_iters,
                cg_card=rd.total_cg_iters, cg_cpu=rc.total_cg_iters,
                u_rel=u_rel)
            del rd, rc
# one V-cycle from one host hierarchy (the CPU matrix of the 2D system)
# on both devices; the hierarchy's levels
asm_c, c_c, V_c, kw_c = sys_cpu["damage2d"]
asm_d, c_d, _, _ = sys_dev["damage2d"]
A_cpu = AMG.ell_to_scipy(asm_c.matrix(asm_c.set_bc(torch.zeros(
    V_c.n_dofs, dtype=torch.float64)), c_c))
A_dev = AMG.ell_to_scipy(asm_d.matrix(asm_d.set_bc(torch.zeros(
    V_c.n_dofs, dtype=torch.float64, device=DEV)), c_d))
h_cpu = AMG.build_hierarchy(
    A_cpu, V_c.dof_coords, 2, free_mask=asm_c.free_mask(
        torch.float64).numpy(),
    opts=AMG.AMGOptions(coarse_size=AMG_COARSE_2D))
check(h_cpu.n_levels >= 3, f"amg: {h_cpu.n_levels} levels on the 2D check")
b_c = torch.as_tensor(np.random.default_rng(7).normal(size=V_c.n_dofs))
vc_rel = rel(AMG.vcycle(h_cpu.to(DEV), b_c.to(DEV)), AMG.vcycle(h_cpu, b_c))
check(vc_rel <= 1e-12, f"amg: one V-cycle card against CPU, rel {vc_rel}")
# how far the card's matrix moves the aggregation (not a gate)
agg_c, n_agg_c = AMG.aggregate(AMG._node_strength_graph(A_cpu, 2, 0.0))
agg_d, n_agg_d = AMG.aggregate(AMG._node_strength_graph(A_dev, 2, 0.0))
amg_agg = dict(matrix_entries_differing=int((A_cpu != A_dev).nnz),
               aggregates_card=n_agg_d, aggregates_cpu=n_agg_c,
               nodes_in_other_aggregate=int((agg_c != agg_d).sum()))
amg_small = dict(checks=amg_checks, vcycle_card_vs_cpu_rel=vc_rel,
                 levels_2d=h_cpu.shapes(), aggregation_card_vs_cpu=amg_agg)
print(json.dumps({"amg_card_vs_cpu": amg_small}), flush=True)
del sys_dev, sys_cpu, asm_c, asm_d, A_cpu, A_dev, h_cpu
torch.cuda.empty_cache()
secs_amg_a = time.perf_counter() - t_phase

# (b) polycrystal.run(mixed=True) under AMG at n = N_AMG, to convergence;
# then capped at AMG_FULL_CAP Newton steps with a fresh hierarchy (a new
# solver): the same trajectory bit for bit. The host hierarchy of the
# first run is kept for the profile
mesh_amg = polycrystal.generate_polycrystal(N_AMG, n_grains=200)
V_amg = FunctionSpace.create(mesh_amg, 1, bs=2)
plan_amg = build_lane_plan(V_amg.dof_coords, np.asarray(V_amg.dofmap),
                           wg_own=16)
E_amg, d_amg = cg_profile.case_inputs(mesh_amg)
cfg_amg = SolverConfig(cg_rtol=1e-8, newton_rtol=1e-6, cg_maxit=20000,
                       preconditioner="amg")
kept_hier = []
_build_hierarchy = AMG.build_hierarchy


def keep_hierarchy(*a, **k):
    h = _build_hierarchy(*a, **k)
    kept_hier.append(h)
    return h


AMG.build_hierarchy = keep_hierarchy
try:
    K.reset_launch_counts()
    r_am, secs_am, peak_am = timed_run(N_AMG, mesh=mesh_amg, plan=plan_amg,
                                       mixed=True, solver=cfg_amg,
                                       postprocess_fields=False)
    launches_am = K.launch_counts()
finally:
    AMG.build_hierarchy = _build_hierarchy
st_am = r_am.stats
print(json.dumps({"amg_full_stats": st_am, "seconds": secs_am}),
      flush=True)
check(st_am["converged"] and st_am["final_residual"] < 1e-6 * st_am["r0"],
      f"amg: the n = {N_AMG} mixed AMG solve did not converge: "
      f"{st_am['residuals']} / {st_am['cg_iters']}")
check(np.isfinite(r_am.u_flat).all() and r_am.u_flat.dtype == np.float64
      and r_am.u_flat.shape == (2 * (N_AMG + 1) ** 2,),
      "amg: u not finite, not float64 or of a wrong shape")
check(launches_am["lane_fused_elem"] > 0
      and launches_am["lane_pass_update"] > 0
      and launches_am["lane_gather_weighted"] == 0,
      f"amg: the operator's kernels on the AMG path: {launches_am}")
cfg_cap = SolverConfig(cg_rtol=1e-8, newton_rtol=1e-6, cg_maxit=20000,
                       preconditioner="amg", newton_maxit=AMG_FULL_CAP)
r_cap, secs_cap, _ = timed_run(N_AMG, mesh=mesh_amg, plan=plan_amg,
                               mixed=True, solver=cfg_cap,
                               postprocess_fields=False)
st_cap = r_cap.stats
n_cap = min(AMG_FULL_CAP, st_am["newton_iters"])
check(st_cap["residuals"] == st_am["residuals"][:n_cap]
      and st_cap["cg_iters"] == st_am["cg_iters"][:n_cap]
      and st_cap["cg_enqueued"] == st_am["cg_enqueued"][:n_cap]
      and (st_am["newton_iters"] <= AMG_FULL_CAP
           or st_cap["final_residual"] == st_am["residuals"][n_cap]),
      f"amg: the capped run differs from the first: {st_cap['residuals']} "
      f"/ {st_cap['cg_iters']} against {st_am['residuals']} / "
      f"{st_am['cg_iters']}")
del r_cap
# one CG iteration under the profiler: a float32 fused engine on the same
# plan, the first run's hierarchy put on the card
F32_am, bcs32_am = cg_profile.damage_functional(mesh_amg, DEV,
                                                torch.float32)
eng_am = LaneEngine(F32_am, bcs32_am, wg_own=16, plan=plan_amg, fused=True,
                    device=DEV, dtype=torch.float32)
cc_am = eng_am.prepare_coeffs({"d": d_amg, "E": E_amg})
hier_am = kept_hier[0].to(DEV)
prof_am = cg_profile.profile_cg_iteration(eng_am, cc_am, 10, amg=hier_am)
vc_bytes = vcycle_bytes(hier_am)
prof_am.update(vcycle_bytes=vc_bytes,
               vcycle_bound_ms=1e3 * vc_bytes / HBM_BYTES_PER_S)
amg_full = dict(
    n=N_AMG, n_dofs=r_am.n_dofs, preconditioner="amg", fused=True,
    newton_iters=st_am["newton_iters"], cg_iters=st_am["cg_iters"],
    total_cg_iters=st_am["total_cg_iters"], residuals=st_am["residuals"],
    final_residual=st_am["final_residual"], energy=r_am.energy,
    levels=st_am["amg"]["levels"], setup_s=st_am["amg"]["setup_s"],
    hierarchy_device_bytes=st_am["amg"]["device_bytes"],
    phase_s=st_am["phase_s"], timings=r_am.timings,
    ms_per_cg_iter=1e3 * st_am["phase_s"]["cg"]
    / max(st_am["total_cg_iters"], 1),
    seconds=secs_am, capped_seconds=secs_cap, peak_device_bytes=peak_am,
    capped_newton_steps=AMG_FULL_CAP, capped_run_bitwise_equal=True,
    launches=launches_am, cg_iteration_profile=prof_am)
del r_am, eng_am, cc_am, hier_am, kept_hier, F32_am, bcs32_am, mesh_amg
del V_amg, plan_amg
torch.cuda.empty_cache()
secs_amg_b = time.perf_counter() - t_phase - secs_amg_a

# (c) neohookean n = NH_FULL with block Jacobi (blocks of 128), the
# reference's settings capped at NH_FULL_STEPS Newton steps as in flat3d,
# twice on one assembler (its pattern built once), bitwise equal
cfg_bj = neohookean.NeoHookeanConfig(n=NH_FULL)
cfg_bj.solver.preconditioner = "block_jacobi"
cfg_bj.solver.newton_maxit = NH_FULL_STEPS
asm_bj, V_bj, _ = neohookean.setup(cfg_bj, device=DEV, dtype=torch.float64)
t0 = time.perf_counter()
asm_bj.pattern
bj_pattern_s = time.perf_counter() - t0
u0_bj = torch.zeros(V_bj.n_dofs, dtype=torch.float64, device=DEV)
bj_runs = []
for _ in range(2):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solve_bj = make_newton_solver(asm_bj, cfg_bj.solver)
    plan_s = time.perf_counter() - t0
    res_bj = solve_bj(u0_bj, {})
    torch.cuda.synchronize()
    bj_runs.append((res_bj, time.perf_counter() - t0, plan_s,
                    torch.cuda.max_memory_allocated()))
    del solve_bj
(b0, *_), (b1, *_) = bj_runs
check(torch.equal(b0.u, b1.u) and b0.cg_iters == b1.cg_iters
      and b0.final_residual == b1.final_residual
      and bool(torch.isfinite(b0.u).all()),
      f"amg: neohookean n = {NH_FULL} block Jacobi, two runs differ or u "
      f"is not finite ({b0.cg_iters} / {b1.cg_iters})")
bj_full = dict(
    n=NH_FULL, n_dofs=V_bj.n_dofs, block_size=cfg_bj.solver.block_size,
    newton_steps=NH_FULL_STEPS, pattern_seconds=bj_pattern_s,
    jacobi_cg_iters_pr11=[2000, 367],
    runs=[dict(cg_iters=r.cg_iters, total_cg_iters=r.total_cg_iters,
               residual_r0=r.r0, final_residual=r.final_residual,
               phase_s=r.phase_s, seconds=secs, plan_seconds=ps,
               ms_per_cg_iter=1e3 * r.phase_s["cg"]
               / max(r.total_cg_iters, 1), peak_device_bytes=pk)
          for r, secs, ps, pk in bj_runs],
    bitwise_equal_runs=True)
del bj_runs, b0, b1, res_bj
torch.cuda.empty_cache()
# one block-Jacobi CG iteration at the first state, its extraction and
# inversion timed alone; the bound: the ELL product and the inverse blocks
# read once, the vectors of the product and of the block product
mat_bj = asm_bj.matrix(asm_bj.set_bc(u0_bj), {}, batch=ELEMENT_BATCH)
plan_bj = BlockJacobiPlan.build(asm_bj.pattern, cfg_bj.solver.block_size,
                                device=DEV)
torch.cuda.synchronize()
t0 = time.perf_counter()
blocks_bj = plan_bj.extract(mat_bj)
torch.cuda.synchronize()
extract_s = time.perf_counter() - t0
t0 = time.perf_counter()
inv_bj = torch.linalg.inv(blocks_bj)
torch.cuda.synchronize()
inverse_s = time.perf_counter() - t0
check(torch.equal(inv_bj, torch.linalg.inv(blocks_bj)),
      "amg: the batched inverse differs between two calls")
del blocks_bj
b_bj = -asm_bj.residual(asm_bj.set_bc(u0_bj), {}, batch=ELEMENT_BATCH) * (
    asm_bj.free_mask(torch.float64))
step_bj = mech_cg_step(mat_bj.matvec, lambda r: plan_bj.apply(inv_bj, r),
                       b_bj)
prof_bj = cg_profile._part(step_bj, 10)
_, _, rows_bj = cg_profile._device_profile(step_bj, 10)
prof_bj["top_kernels"] = [
    (name[:60], ms / 10, calls / 10)
    for name, ms, calls in sorted(rows_bj, key=lambda r: -r[1])[:8]]
bj_ell = ell_bytes(mat_bj, mat_bj.n_rows)
bj_bytes = bj_ell + nbytes(inv_bj) + 2 * nbytes(b_bj)
prof_bj.update(ell_bytes=bj_ell, inverse_block_bytes=nbytes(
    inv_bj), bound_bytes=bj_bytes,
    bound_ms=1e3 * bj_bytes / HBM_BYTES_PER_S,
    block_apply_ms=median_ms(lambda: plan_bj.apply(inv_bj, b_bj), 5),
    extract_seconds=extract_s, inverse_seconds=inverse_s,
    ell_pos_bytes=nbytes(plan_bj.ell_pos))
bj_full["cg_iteration_profile"] = prof_bj
del mat_bj, plan_bj, inv_bj, b_bj, step_bj, asm_bj, u0_bj
torch.cuda.empty_cache()
emit("amg", card_vs_cpu=amg_small, polycrystal_mixed_amg=amg_full,
     neohookean_block_jacobi=bj_full,
     tolerance="card against CPU (float64): same Newton count, |d total "
               "CG| <= Newton steps, u rel <= 1e-9; one V-cycle from one "
               "host hierarchy rel <= 1e-12; n = 256: the capped run "
               "and the second block-Jacobi run bitwise equal",
     seconds_by_part=dict(card_vs_cpu=secs_amg_a, polycrystal=secs_amg_b,
                          neohookean_block_jacobi=time.perf_counter()
                          - t_phase - secs_amg_a - secs_amg_b),
     nvidia_smi=smi, seconds=time.perf_counter() - t_phase)

# -- summary ------------------------------------------------------------------

REPLACES = {
    "lane_gather_cm": "tpufem/lane/kernels.py:198",
    "lane_scatter_cm": "tpufem/lane/kernels.py:258",
    "lane_pass_update": "tpufem/lane/kernels.py:356",
    "lane_fused_elem": "tpufem/lane/kernels.py:521",
    "lane_fused_gen": "tpufem/lane/kernels.py:521",
    "lane_fused_gen_mq": "tpufem/lane/kernels.py:521",
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
                 launches_b["lattice_matvec3d"],
                 "lane_fused_gen": launches_gen["lane_fused_gen"],
                 "lane_fused_gen_mq": launches_mq_gen["lane_fused_gen_mq"]}
PATHS = {**dict.fromkeys(LANE_PATH, "polycrystal.run defaults, n = 1024"),
         "lattice_residual": "path A", "lattice_tangent": "path A",
         "lattice_matvec3d": "path B",
         "lane_fused_gen": "the polycrystal with the study's body load in "
                           "the integrand, n = 1024, fused (generated), "
                           "Jacobi (phase fused_gen)",
         "lane_fused_gen_mq": "Q2 hexes box(40) (benchmarks/q2hex_bench.py"
                              "), fused (generated, multi-point), Jacobi, "
                              "1 Newton step of <= 500 CG (phase multiqp)",
         "lane_gather": None,
         "lane_scatter": None, "lane_scatter_weighted": None}
results["lane_scatter_cm"].update(
    {"generic_" + k: v for k, v in k2_generic.items()})
summary = []
for name, r in results.items():
    entry = dict(
        name=name, route="cuda", source=f"tpufem_torch/csrc/{name}" + (
            ".cuh" if name.startswith("lane_fused_gen") else ".cu"),
        replaces=REPLACES[name], path=PATHS[name],
        launches=MAIN_LAUNCHES[name],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"],
    )
    if name in LANE_PATH:
        entry.update(launches_staged_jacobi_solve=launches[name],
                     launches_fused_jacobi_solve=launches_fused[name],
                     launches_mixed_solve=launches_mx[name],
                     launches_multiqp_solve=launches_mq[name],
                     launches_generic_mechanic2d_solve=launches_g[name],
                     launches_traction_fused_solve=launches_t["fused"][name],
                     launches_traction_staged_solve=launches_t["staged"][
                         name])
    if name == "lane_fused_gen":
        entry.update(
            launches_3d_bar_fused_solve=gen_c["fused_gen"]["launches"][name],
            launches_run_defaults=launches_tl[name],
            generated_from="the integrand's AD graphs, traced and emitted "
                           "as C (tpufem_torch/lane/fused_gen.py)")
    if name == "lane_fused_gen_mq":
        entry.update(
            launches_p2_fused_solve=p2_pair["fused"]["launches"][name],
            launches_run_defaults=launches_tl[name],
            generated_from="the folded integrand's point graphs, traced "
                           "and emitted as C (tpufem_torch/lane/"
                           "fused_gen.py:GenPhysicsMQ)")
    for k in ("refresh_ms", "refresh_plain_ms", "refresh_bound_ms",
              "jvp_ms", "jvp_plain_ms", "jvp_bound_ms", "shape",
              "prolong_ms", "prolong_plain_ms", "prolong_bound_ms",
              "gather_sum_yardstick_ms", "prolong_gather_sum_yardstick_ms",
              "conv3d_yardstick_ms", "warm_ms", "device_ms", "sum_v_ms",
              "sum_v_plain_ms", "sum_v_bound_ms", "mul_index_add_yardstick_ms",
              "ms_range", "sum_v_ms_range", "prolong_ms_range",
              "sum_v_device_ms",
              "lines_per_warp_load", "prolong_lines_per_warp_load",
              "q2hex_ms", "q2hex_ms_range", "q2hex_plain_ms",
              "q2hex_bound_ms", "q2hex_refresh_ms", "q2hex_refresh_ms_range",
              "q2hex_refresh_plain_ms", "q2hex_refresh_bound_ms",
              "q2hex_library_ms", "q2hex_library_dump_row_ms",
              "q2hex_padding_share", "padding_share", "jvp_geometry",
              "table_bytes", "table_host_seconds", "q2hex_table_bytes",
              "q2hex_table_host_seconds", "generic_ms", "generic_ms_range",
              "generic_plain_ms", "generic_bound_ms", "generic_library_ms",
              "generic_table_bytes", "generic_table_host_seconds",
              "generic_geometry", "real_bound_bytes", "real_bound_ms",
              "q2hex_real_bound_bytes", "q2hex_real_bound_ms",
              "generic_real_bound_ms",
              "geometry", "bound_ms_all_lane_cells",
              "jvp_bound_ms_all_lane_cells"):
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
