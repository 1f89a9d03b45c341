"""The windowed gathers and scatters of the lane layout alone on the card,
at the tables of the n = 1024 polycrystal plan: K1 ``lane_gather_cm`` and
K5 ``lane_gather_weighted`` (the two-level restriction and prolongation),
K9 ``lane_gather`` (per v and summed over v) at K1's tables, K10
``lane_scatter`` at their transpose and K11 ``lane_scatter_weighted`` at
the prolongation's tables in the adjoint direction. K2 ``lane_scatter_cm``
has a bench of its own, ``perf/scatter_cm_bench.py``.

    python -m tpufem_torch.perf.lane_gather_bench [--tables FILE]
    PYTHONPATH=<other tree> python <this file> [--tables FILE]

Builds the kernel library from the sources of the ``tpufem_torch`` that is
imported, so the second form times another checkout's kernels (for a
comparison of two designs in one call: it uses only the public wrappers
and their plain versions, which every tree has). The tables are the ones
``polycrystal.run`` uses: the fused engine's gather table (K1) and the
two-level transfer tables (K5), built from the n = 1024 mesh with 200
grains (about a minute on the host) -- or loaded from ``--tables``, where
an earlier run saved them. Every kernel is held exactly equal to its plain
version. Prints the ``nvidia-smi`` name and power limit first, then one
JSON line per kernel: the median, least and most of TRIALS event readings
of 20 launches on one input (warm) and on COLD_SETS input copies in turn
(cold), the kernel's device time under torch.profiler, the byte and
operation bounds, what ptxas says of its instances, and, for the gathers
of K1 and K5, the mean number of distinct 128-byte lines one warp's load
touches where the 32 lanes of a slab gather straight from global memory
(and, at one line a cycle per SM, the time those loads would take).
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # same sheet, float32 outside the tensor cores
TRIALS = 11
REPS = 20
COLD_SETS = 8
N_FULL = 1024
WARP = 32
# the kernel entry of each case (a part of its name, demangled or not)
ENTRIES = {"lane_gather_cm": "lane_gather_cm_kernel",
           "lane_gather_weighted": "lane_gather_weighted_kernel",
           "lane_gather": "lane_gather_kernel",
           "lane_scatter": "lane_scatter_kernel",
           "lane_scatter_weighted": "lane_scatter_weighted_kernel"}


def build_tables(dev) -> dict:
    """The n = 1024 plan's K1 and K5 tables, on the host."""
    from tpufem_torch.cases import polycrystal
    from tpufem_torch.lane import LaneEngine
    from tpufem_torch.lane import twolevel as TL
    from tpufem_torch.perf import cg_profile

    mesh = polycrystal.generate_polycrystal(N_FULL, n_grains=200)
    F, bcs = cg_profile.damage_functional(mesh, dev, torch.float32)
    eng = LaneEngine(F, bcs, wg_own=16, fused=True, device=dev,
                     dtype=torch.float32)
    E, d = cg_profile.case_inputs(mesh)
    st, geo = TL.build_twolevel_geo(eng, {"d": d, "E": E})
    p = eng.plan
    cpu = lambda t: t.detach().to("cpu")  # noqa: E731
    return dict(
        C=eng.bs, R=p.R, wg=p.wg, V=p.nv,
        gather_starts=cpu(eng.gather_starts), gather_idx=cpu(eng.gather_idx),
        WRr=st.WRr, WRp=st.WRp, Rv=st.Rv,
        **{k: cpu(geo[k]) for k in ("r_starts", "r_idx", "r_wts",
                                    "p_starts", "p_idx", "p_wts")})


def lines_per_warp_load(starts, idx, wr: int, R: int, vbytes: int = 4):
    """(mean, total) distinct 128-byte lines of one channel's values that
    the warp loads of a direct gather touch: a warp is the 32 lanes of a
    slab at one (t, v, k), and its load reads the rows of its valid
    entries (0 <= idx < wr, starts[t] + idx < R); one slab row of 32
    values is ``32 * vbytes / 128`` lines. The mean is over the warp loads
    that read at least one row."""
    T, V, K, L = idx.shape
    ii = idx.to(torch.int64)
    rows = starts.to(torch.int64).view(T, 1, 1, 1) + ii
    valid = (ii >= 0) & (ii < wr) & (rows < R)
    rows = torch.where(valid, rows, torch.full_like(rows, -1))
    srt = rows.view(T, V, K, L // WARP, WARP).sort(-1).values
    distinct = ((srt[..., 1:] != srt[..., :-1]) & (srt[..., 1:] >= 0)).sum(-1)
    distinct = distinct + (srt[..., 0] >= 0)
    loads = int(valid.view(T, V, K, L // WARP, WARP).any(-1).sum())
    total = int(distinct.sum()) * max(WARP * vbytes // 128, 1)
    return total / max(loads, 1), total


def bound(nbytes: int, flops: int) -> dict:
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / F32_FLOPS_PER_S * 1e3
    return dict(bound_bytes=nbytes, flops=flops, bound_ms=max(b_ms, f_ms),
                bound_by="bytes" if b_ms >= f_ms else "operations")


def _events(fn, sets):
    """[median, least, most] ms per call over TRIALS readings of REPS
    calls, each call on the next of ``sets`` (argument tuples)."""
    for a in sets:
        fn(*a)
    torch.cuda.synchronize()
    ts = []
    for _ in range(TRIALS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for r in range(REPS):
            fn(*sets[r % len(sets)])
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / REPS)
    ts.sort()
    return [ts[TRIALS // 2], ts[0], ts[-1]]


def cases(tabs: dict, dev) -> dict:
    """name: (wrapper, plain version, shape of the first argument (made
    anew for each input copy), the other arguments, keywords, the window
    height the gather lines are counted for (None: not counted), the
    operations per valid table entry and channel)."""
    from tpufem_torch.lane import kernels as K

    on = lambda t: t.to(dev)  # noqa: E731
    C, R, V, wg = tabs["C"], tabs["R"], tabs["V"], tabs["wg"]
    g_st, g_ix = on(tabs["gather_starts"]), on(tabs["gather_idx"])
    T, _, kc, _ = g_ix.shape
    sk10 = V * kc
    p_ix, p_w = on(tabs["p_idx"]), on(tabs["p_wts"])
    return {
        "lane_gather_cm": (
            K.lane_gather_cm, K.lane_gather_cm_plain, (C, R, 128),
            (g_st, g_ix), dict(wr=wg, n_ch=C * V), wg, 0),
        "lane_gather_weighted/restrict": (
            K.lane_gather_weighted, K.lane_gather_weighted_plain, (C, R, 128),
            (on(tabs["r_starts"]), on(tabs["r_idx"]), on(tabs["r_wts"])),
            dict(wr=tabs["WRr"]), tabs["WRr"], 2),
        "lane_gather_weighted/prolong": (
            K.lane_gather_weighted, K.lane_gather_weighted_plain,
            (C, tabs["Rv"], 128),
            (on(tabs["p_starts"]), p_ix, p_w), dict(wr=tabs["WRp"]),
            tabs["WRp"], 2),
        "lane_gather": (
            K.lane_gather, K.lane_gather_plain, (C, R, 128), (g_st, g_ix),
            dict(wr=wg), None, 0),
        "lane_gather/sum_v": (
            K.lane_gather, K.lane_gather_plain, (C, R, 128), (g_st, g_ix),
            dict(wr=wg, sum_v=True), None, 1),
        "lane_scatter": (
            K.lane_scatter, K.lane_scatter_plain, (C, T * sk10, 128),
            (on(torch.arange(T, dtype=torch.int32) * sk10),
             g_ix.reshape(T, sk10, 128)), dict(sk=sk10, k_out=wg), None, 1),
        "lane_scatter_weighted": (
            K.lane_scatter_weighted, K.lane_scatter_weighted_plain,
            (C, T * wg, 128), (on(torch.arange(T, dtype=torch.int32) * wg),
                               p_ix, p_w),
            dict(sk=wg, k_out=tabs["WRp"], n_dest=p_ix.shape[1]), None, 2),
    }


def bench(tabs: dict, dev) -> dict:
    from tpufem_torch.perf.lattice_bench import device_us

    g = torch.Generator(device=dev)
    g.manual_seed(2468)
    C = tabs["C"]
    out = {}
    for name, (fn, plain, shape, rest, kw, wr, ops) in cases(tabs,
                                                            dev).items():
        sets = [(torch.randn(shape, device=dev, generator=g), *rest)
                for _ in range(COLD_SETS)]
        y = fn(*sets[0], **kw)
        torch.cuda.synchronize()
        exact = bool(torch.equal(y, plain(*sets[0], **kw)))
        warm = _events(lambda *a: fn(*a, **kw), sets[:1])
        cold = _events(lambda *a: fn(*a, **kw), sets)
        dus = device_us(lambda: fn(*sets[0], **kw), REPS,
                        ENTRIES[name.split("/")[0]])
        idx = [t for t in rest if t.dtype in (torch.int8, torch.int32)
               and t.dim() > 1][0]
        ii = idx.to(torch.int64)
        nvalid = int((ii >= 0).sum() if wr is None
                     else ((ii >= 0) & (ii < wr)).sum())
        nb = sum(t.numel() * t.element_size() for t in (*sets[0], y))
        r = dict(exact=exact, ms=warm[0], ms_range=warm, cold_ms=cold[0],
                 cold_ms_range=cold,
                 profiler_device_ms=None if dus is None else dus / 1e3,
                 table=list(idx.shape), idx_dtype=str(idx.dtype),
                 **bound(nb, ops * nvalid * C))
        if wr is not None:
            mean, total = lines_per_warp_load(rest[0], idx, wr, shape[1])
            r.update(wr=wr, lines_per_warp_load=mean, lines=total * C)
        out[name] = r
        del sets, y, ii
    return out


def main():
    if not torch.cuda.is_available():
        print("lane_gather_bench: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from tpufem_torch.lane import _build
    from tpufem_torch.perf.lattice_bench import ptxas_of, smi

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", help="load the tables from this file, or "
                    "build them and save them there")
    opts = ap.parse_args()
    dev = torch.device("cuda", 0)
    print(smi(), flush=True)
    seconds = _build.build(verbose=True)
    _build.load()
    ptx = {k: v for k, v in ptxas_of(_build.build_log).items()
           if any(e in k for e in ENTRIES.values())}
    if opts.tables and os.path.exists(opts.tables):
        tabs = torch.load(opts.tables)
    else:
        tabs = build_tables(dev)
        if opts.tables:
            torch.save(tabs, opts.tables)
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    res = bench(tabs, dev)
    tree = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(_build.__file__))))
    lines_per_s = props.multi_processor_count * clock_mhz * 1e6
    for name, r in res.items():
        entry = ENTRIES[name.split("/")[0]]
        r.update(kernel=name, tree=tree, build_seconds=seconds,
                 ptxas={k: v for k, v in ptx.items() if entry in k})
        if "lines" in r:
            r["direct_load_model_ms"] = r["lines"] / lines_per_s * 1e3
        print(json.dumps(r), flush=True)
    if not all(r["exact"] for r in res.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
