"""The structured lattice kernels K6 / K7 (2D asym-damage residual and
tangent) and K8 (3D elasticity stencil) alone on the card, at the shapes
of paths A (1024^2 cells) and B (160^3 cells).

    python -m tpufem_torch.perf.lattice_bench
    PYTHONPATH=<other tree> python <this file>   # the same on another tree

Builds the kernel library from the sources of the ``tpufem_torch`` that is
imported (so the second form times another checkout's kernels, for a
comparison of two designs in one call; it uses only the public makers
``make_residual_kernel`` / ``make_tangent_kernel`` / ``make_linear_matvec``
and the plain versions, which every tree has), holds every kernel exactly
equal to its plain version at the path shapes and at small odd ones, and
prints one JSON line: per kernel the median, least and most of TRIALS
readings, the kernel's own device time under torch.profiler (free of the
host's cost between launches) and the host's microseconds per call (K6 / K7 cold -- COLD_SETS input copies in turn, more than L2
holds -- and warm; K8 20 launches on one input of 50 MB), the byte and
flop bounds, what ptxas says of its instances (registers, spills, stack)
and its SASS: the instructions of the kernel's main loop, which handles
one cell (K6 / K7) or one interior node (K8) a thread per pass, and the
floor they give at the card's SM count and clock (an SM issues four warp
instructions, 128 lanes, a cycle). Needs a
CUDA device and nvcc; prints ``nvidia-smi``'s name and power limit first.
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # same sheet, float32 outside the tensor cores
TRIALS = 11
COLD_SETS = 8
E_S, NU_S = 1.0e6, 0.3  # the structured benchmarks' material
# flops per lattice cell, counted by hand from csrc/lattice2d.cuh and
# csrc/asym_damage.cuh (both triangles' strain, damage mean and stress or
# its directional derivative, and the six contributions the cell's v00
# node adds)
K6_FLOPS_PER_CELL, K7_FLOPS_PER_CELL = 198, 362
SHAPES_2D = ((1024, 1024), (13, 9), (1001, 517), (1, 1), (31, 7), (33, 9),
             (2047, 3))
SHAPES_3D = (((160, 160, 160), None), ((9, 7, 11), (0.1, 0.2, 0.15)),
             ((1, 1, 1), None), ((2, 2, 2), None),
             ((33, 5, 17), (0.03, 0.2, 0.06)))
# the kernel functions, as their mangled names start
KERNELS = {"lattice_residual": "_Z16lattice2d_kernelILi0E",
           "lattice_tangent": "_Z16lattice2d_kernelILi1E",
           "lattice_matvec3d": "_Z23lattice_matvec3d_kernel"}
# ... and as the profiler names them
PROFILED = {"lattice_residual": "lattice2d_kernel<0>",
            "lattice_tangent": "lattice2d_kernel<1>",
            "lattice_matvec3d": "lattice_matvec3d_kernel"}
OBJECTS = {"lattice_residual": "lattice_residual.o",
           "lattice_tangent": "lattice_tangent.o",
           "lattice_matvec3d": "lattice_matvec3d.o"}


def smi(query="name,power.limit"):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().split(
            "\n")[0]


def ptxas_of(log: str) -> dict:
    """{kernel entry: {registers, spill_bytes, stack_bytes}} from an
    ``nvcc -Xptxas -v`` log."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif entry and "stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out.setdefault(entry, {}).update(stack_bytes=nums[0],
                                             spill_bytes=sum(nums[1:]))
        elif entry and "registers" in ln:
            out.setdefault(entry, {})["registers"] = int(
                ln.split("Used ")[1].split(" registers")[0])
    return out


def _cuobjdump() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "cuobjdump")):
            return os.path.join(root, "bin", "cuobjdump")
    return "cuobjdump"


def sass_counts(obj: str, prefix: str, dump: str = None) -> dict:
    """SASS of the kernel whose mangled name starts with ``prefix`` in the
    object file ``obj``: its instructions (NOPs left out), and those of its
    main loop -- the widest backward branch's span. ``dump``: a file to
    write the object's SASS to."""
    text = subprocess.run([_cuobjdump(), "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    if dump:
        with open(dump, "w") as f:
            f.write(text)
    body, on = [], False
    for ln in text.splitlines():
        if "Function :" in ln:
            on = ln.split("Function :")[1].strip().startswith(prefix)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if on and m:
            body.append((int(m.group(1), 16), m.group(2).strip()))
    insts = [(a, s) for a, s in body if not s.split()[-1].startswith("NOP")
             and not s.startswith("NOP")]
    loop = (0, 0)
    for a, s in insts:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", s)
        if m and int(m.group(1), 16) < a and a - int(m.group(1), 16) > \
                loop[1] - loop[0]:
            loop = (int(m.group(1), 16), a)
    in_loop = sum(loop[0] <= a <= loop[1] for a, _s in insts)
    return dict(instructions=len(insts),
                main_loop_instructions=in_loop if loop[1] else None)


def k8_least_flops(consts) -> int:
    """The least flops of y = K x on K8's lattice: a product and a sum for
    every entry of each node's summed blocks sum_chi K[delta][chi] that is
    not zero (the cells a node has depend, per axis, on whether it lies on
    the low face, inside or on the high face; entries below 1e-6 of the
    largest, zero by symmetry, are not counted: 153 an interior node)."""
    blocks = [(delta, chi, np.asarray(K, np.float64))
              for delta, chi, K in consts.terms]
    tol = 1e-6 * max(np.abs(K).max() for _d, _c, K in blocks)
    chis = {"lo": (0,), "mid": (-1, 0), "hi": (-1,)}
    total = 0
    for cls in itertools.product(chis, repeat=3):  # (z, y, x)
        nodes = 1
        for c, n in zip(cls, (consts.nz, consts.ny, consts.nx)):
            nodes *= n - 1 if c == "mid" else 1
        summed = {}
        for delta, chi, K in blocks:
            if all(chi[i] in chis[cls[i]] for i in range(3)):
                summed[delta] = summed.get(delta, 0) + K
        total += 2 * nodes * sum(int(np.count_nonzero(np.abs(S) > tol))
                                 for S in summed.values())
    return total


def _median(fn, reps):
    """[median, least, most] ms per call over TRIALS readings of ``reps``
    calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(TRIALS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    ts.sort()
    return [ts[TRIALS // 2], ts[0], ts[-1]]


def _host_us(fn, reps=200):
    """Host microseconds per call of ``fn`` (the wrapper and the launch,
    no synchronize in the loop): where this nears the kernel's time,
    back-to-back timings measure the host, not the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device_us(fn, reps, part):
    """Mean device microseconds of the kernel whose (demangled) name holds
    ``part`` over ``reps`` calls of ``fn`` under torch.profiler: the card's
    time alone, whatever the host costs between launches; None if the
    profiler sees no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if part in e.key
            and e.device_time_total > 0]
    if not rows:
        return None
    return sum(e.device_time_total for e in rows) / sum(e.count for e in rows)


def _bound(nbytes, flops):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / F32_FLOPS_PER_S * 1e3
    return dict(bytes=nbytes, flops=flops, bytes_ms=b_ms, flops_ms=f_ms,
                bound_ms=max(b_ms, f_ms),
                bound_by="bytes" if b_ms >= f_ms else "operations")


def bench(dev) -> dict:
    from tpufem_torch.structured import (StructuredGrid3D,
                                         make_linear_matvec,
                                         make_residual_kernel,
                                         make_tangent_kernel)
    from tpufem_torch.structured import kernels2d as K2
    from tpufem_torch.structured import kernels3d as K3
    from tpufem_torch.forms import linear_elastic_psi

    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    # the profiler runs last: after a profiler session the host pays more
    # per launch, and K7's host time nears its device time
    res, exact, profiled = {}, [], []
    for nx, ny in SHAPES_2D:
        u = 1e-3 * torch.randn((2, ny + 1, nx + 1), device=dev, generator=g)
        u[:, : (ny + 1) // 4] = 0.0  # rows of cells on the degenerate branch
        v = torch.randn((2, ny + 1, nx + 1), device=dev, generator=g)
        d = torch.rand((ny + 1, nx + 1), device=dev, generator=g)
        for name, maker, plain, args, fl in (
                ("lattice_residual", make_residual_kernel, K2.residual_plain,
                 (u, d), K6_FLOPS_PER_CELL),
                ("lattice_tangent", make_tangent_kernel, K2.tangent_plain,
                 (u, d, v), K7_FLOPS_PER_CELL)):
            fn = maker(nx, ny, 1 / nx, 1 / ny, E_S, NU_S)
            out = fn(*args)
            torch.cuda.synchronize()
            ok = torch.equal(out, plain(*args, fn.consts))
            exact.append([name, f"{nx}x{ny}", ok])
            if (nx, ny) != SHAPES_2D[0]:
                continue
            sets = itertools.cycle([args] + [tuple(a.clone() for a in args)
                                             for _ in range(COLD_SETS - 1)])
            cold = _median(lambda: fn(*next(sets)), 8 * COLD_SETS)
            warm = _median(lambda: fn(*args), 8 * COLD_SETS)
            nb = sum(t.numel() * 4 for t in (*args, out))
            res[name] = dict(shape=f"{nx}x{ny}", cells=nx * ny, ms=cold,
                             warm_ms=warm, host_us_per_call=_host_us(
                                 lambda: fn(*args)),
                             **_bound(nb, fl * nx * ny))
            profiled.append((name, lambda f=fn, s=sets: f(*next(s)),
                             8 * COLD_SETS))
    for dims, h in SHAPES_3D:
        h = h or tuple(1 / n for n in dims)
        grid = StructuredGrid3D(
            nx=dims[0], ny=dims[1], nz=dims[2], hx=h[0], hy=h[1], hz=h[2],
            bs=3, energy_density=lambda g_, c: linear_elastic_psi(
                0.5 * (g_ + g_.T), E_S, NU_S), field_kinds={})
        mv = make_linear_matvec(grid, E_S, NU_S)
        x = torch.randn((3, dims[2] + 1, dims[1] + 1, dims[0] + 1),
                        device=dev, generator=g)
        y = mv(x)
        torch.cuda.synchronize()
        ok = torch.equal(y, K3.linear_matvec_plain(x, mv.consts))
        exact.append(["lattice_matvec3d", "x".join(map(str, dims)), ok])
        if dims != SHAPES_3D[0][0]:
            continue
        interior = int(np.prod([n - 1 for n in dims]))
        res["lattice_matvec3d"] = dict(
            shape="x".join(map(str, dims)), interior_nodes=interior,
            ms=_median(lambda: mv(x), 20), host_us_per_call=_host_us(
                lambda: mv(x), 50),
            **_bound(2 * x.numel() * 4, k8_least_flops(mv.consts)))
        profiled.append(("lattice_matvec3d", lambda m=mv, xx=x: m(xx), 20))
    for name, fn, reps in profiled:
        res[name]["profiler_device_us"] = device_us(fn, reps,
                                                     PROFILED[name])
    return dict(results=res, exact=exact)


def main():
    if not torch.cuda.is_available():
        print("lattice_bench: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from tpufem_torch.lane import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass-dir", help="write each kernel's SASS here")
    ap.add_argument("--profile-first", action="store_true",
                    help="run one torch.profiler session before timing (as "
                    "chip_smoke.py's earlier phases do)")
    opts = ap.parse_args()
    dev = torch.device("cuda", 0)
    print(smi(), flush=True)
    if opts.profile_first:
        a = torch.ones(1 << 20, device=dev)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            for _ in range(10):
                a = a * 1.0001
            torch.cuda.synchronize()
    seconds = _build.build(verbose=True)
    _build.load()
    ptx = ptxas_of(_build.build_log)
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    out = bench(dev)
    lanes_per_s = props.multi_processor_count * 128 * clock_mhz * 1e6
    for name, prefix in KERNELS.items():
        r = out["results"][name]
        r["ptxas"] = {k: v for k, v in ptx.items() if k.startswith(prefix)}
        sass = sass_counts(
            os.path.join(_build.BUILD_DIR, OBJECTS[name]), prefix,
            opts.sass_dir and os.path.join(opts.sass_dir, name + ".sass"))
        if sass["main_loop_instructions"]:
            items = r.get("interior_nodes", r.get("cells"))
            sass["instruction_floor_ms"] = (
                sass["main_loop_instructions"] * items / lanes_per_s * 1e3)
        r["sass"] = sass
    print(json.dumps(dict(
        tree=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(_build.__file__)))),
        build_seconds=seconds, sm_count=props.multi_processor_count,
        clock_max_mhz=clock_mhz, kernel_sources=sorted(
            os.path.basename(p) for p in glob.glob(
                os.path.join(_build.CSRC_DIR, "lattice*"))),
        **out)), flush=True)
    if not all(ok for _n, _s, ok in out["exact"]):
        sys.exit(1)


if __name__ == "__main__":
    main()
