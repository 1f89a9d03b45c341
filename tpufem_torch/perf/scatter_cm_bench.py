"""K2 ``lane_scatter_cm`` alone on the card at the lane plans of the main
paths: the n = 1024 polycrystal (P1, C = 2, wg_own 16), the Q2-hex box(40)
of ``benchmarks/q2hex_bench.py`` (C = 3, V = 27), the generic path's
``mechanic2d`` r = 7 (square.msh, P1, C = 2, wg_own 32) and the P1-tet
box(48) plan of 272 rows (C = 3).

    python -m tpufem_torch.perf.scatter_cm_bench [--tables FILE] [--sweep]
    PYTHONPATH=<other tree> python <this file> [--tables FILE]

Builds the kernel library from the sources of the ``tpufem_torch`` that is
imported, so the second form times another checkout's K2 (for a comparison
of two designs in one call: a tree whose wrapper takes no ``table`` is run
without one). The gather tables come from ``build_lane_plan`` on the host
(about a minute) or from ``--tables``, where an earlier run saved them.
Prints the ``nvidia-smi`` name and power limit first, then one JSON line a
shape and value type: K2 held exactly equal to its plain version, the
median, least and most of TRIALS event readings of REPS launches, the
bound of the contract's bytes (src + idx + out, 3.35 TB/s) and, where the
tree has a table, that of the real entries (:func:`real_entry_bytes`),
the plain version's time, the ``index_add_`` yardstick
(:func:`index_add_yardstick`, which ``chip_smoke.py`` times too), the
padding share, the sources a row gets, and, where the tree has it, the
inverse table's bytes and host seconds (its copy from the card included).
``--sweep`` also times the kernel at other launch geometries (thread rows
a block, staged or read through L1) through
``kernels._scatter_cm_launch``. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TRIALS = 11
REPS = 20
SHAPES = ("polycrystal_n1024", "q2hex_box40", "generic_mechanic2d_r7",
          "p1tet_box48")
SWEEP_RY = (4, 8, 16, 32)


def _plan_idx(V, wg_own):
    from tpufem_torch.lane.plan import build_lane_plan

    p = build_lane_plan(V.dof_coords, np.asarray(V.dofmap), wg_own=wg_own)
    idt = np.int8 if p.wg < 127 else np.int32
    return dict(gather_idx=torch.from_numpy(np.ascontiguousarray(
        p.gather_idx.astype(idt))), wg=p.wg, C=V.bs)


def build_tables() -> dict:
    """The four plans' gather tables (T, V, K, 128), on the host."""
    from tpufem_torch.cases import polycrystal
    from tpufem_torch.config import data_path
    from tpufem_torch.mesh import box, read_gmsh, refine_uniform
    from tpufem_torch.spaces import FunctionSpace

    out = {}
    mesh = polycrystal.generate_polycrystal(1024, n_grains=200)
    out["polycrystal_n1024"] = _plan_idx(FunctionSpace.create(mesh, 1, bs=2),
                                         16)
    out["q2hex_box40"] = _plan_idx(
        FunctionSpace.create(box(40, 40, 40), 2, bs=3), 32)
    mesh = read_gmsh(data_path("square.msh"))
    for _ in range(7):
        mesh = refine_uniform(mesh)
    out["generic_mechanic2d_r7"] = _plan_idx(
        FunctionSpace.create(mesh, 1, bs=2), 32)
    out["p1tet_box48"] = _plan_idx(
        FunctionSpace.create(box(48, 48, 48, cell_type="tetra"), 1, bs=3),
        32)
    return out


def _events(fn):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(TRIALS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / REPS)
    ts.sort()
    return [ts[TRIALS // 2], ts[0], ts[-1]]


def _mean(fn, reps):
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


def index_add_yardstick(src, ix, ref, dump_row=False):
    """K2's library yardstick at a plan's shapes: a function that runs one
    ``index_add_`` computing K2's function (float atomics, so checked close
    to K2's plain version ``ref`` (C, G, wg, 128), not equal) over int64
    global indices. The padding entries (ix -1) are left out: the plain
    version adds each into a row of its own (bin, lane), so they cost it no
    collisions. With ``dump_row`` they all go to one appended row instead,
    where their atomics collide on C addresses, to show what such a
    yardstick would have counted against the kernel."""
    C, G, wg = ref.shape[0], ref.shape[1], ref.shape[2]
    V = ix.shape[1]
    dev = src.device
    ii = ix.to(torch.int64)
    lane = torch.arange(128, device=dev)
    tt = torch.arange(G, device=dev).view(G, 1, 1, 1)
    dest = ((tt * wg + ii) * 128 + lane).permute(1, 0, 2, 3).reshape(-1)
    real = (ii >= 0).expand(-1, -1, -1, 128).permute(1, 0, 2, 3).reshape(-1)
    s2 = src.reshape(V, C, -1).permute(0, 2, 1).reshape(-1, C)
    n_out = G * wg * 128
    if dump_row:
        dest = torch.where(real, dest, torch.full_like(dest, n_out))
        s2 = s2.contiguous()
    else:
        dest, s2 = dest[real], s2[real].contiguous()
    acc = torch.zeros((n_out + 1, C), dtype=src.dtype, device=dev)
    acc.index_add_(0, dest, s2)
    lib = acc[:-1].T.reshape(ref.shape)
    if float((lib - ref).abs().max()) > 1e-4 * float(ref.abs().max()):
        raise AssertionError("index_add_ yardstick disagrees")
    return lambda: acc.index_add_(0, dest, s2)


def real_entry_bytes(src, ix, table, out):
    """The bytes K2's function needs at least where padding is skipped:
    the src values of the real (v, k) entries (ix >= 0), the inverse
    table, which the kernel reads instead of idx, and out. The contract's
    bound counts all of src, idx and out."""
    n_real = int((ix >= 0).sum())
    return (n_real * out.shape[0] * src.element_size() + table.nbytes
            + out.numel() * out.element_size())


def _geometry_sweep(K, src, table, ref, C):
    """The kernel at SWEEP_RY thread rows a block, staged where the tile
    fits a block and read through L1: exact, and its event median."""
    out = []
    geo = K.scatter_cm_geometry(table.k_out, C, table.V, table.K,
                                src.element_size())
    tile = table.V * geo["cb"] * table.K * K.SCATTER_SLAB * src.element_size()
    for ry in SWEEP_RY:
        for staged in (False, True):
            if (staged and tile > K.SMEM_PER_BLOCK) or (
                    not staged and table.slots.dtype == torch.int8):
                continue
            ry_e = K._even_rows(table.k_out, ry)

            def run():
                return K._scatter_cm_launch(src, table, C, geo["cb"], ry_e,
                                            staged)
            o = run()
            torch.cuda.synchronize()
            out.append(dict(ry=ry_e, staged=staged,
                            exact=bool(torch.equal(o, ref)),
                            ms=_events(run)[0]))
    return out


def bench(tabs: dict, dev, sweep: bool) -> list:
    from tpufem_torch.lane import kernels as K

    has_table = hasattr(K, "scatter_cm_table")
    g = torch.Generator(device=dev)
    g.manual_seed(2468)
    res = []
    for name in SHAPES:
        t = tabs[name]
        ix = t["gather_idx"].to(dev)
        T, V, Kc, _ = ix.shape
        C, wg = t["C"], t["wg"]
        kw = dict(k_out=wg, n_ch=C)
        extra = {}
        if has_table:
            t0 = time.perf_counter()
            table = K.scatter_cm_table(ix, wg)
            extra.update(table_host_seconds=time.perf_counter() - t0,
                         table_bytes=table.nbytes,
                         table_slot_dtype=str(table.slots.dtype),
                         table_E=int(table.slots.shape[1]))
            kw["table"] = table
            cnt = (table.off[:, 1:].to(torch.int64)
                   - table.off[:, :-1].to(torch.int64))
            extra.update(
                empty_row_share=float((cnt == 0).double().mean()),
                most_sources_a_row=int(cnt.max()),
                mean_sources_a_nonempty_row=float(
                    cnt.sum() / max(int((cnt > 0).sum()), 1)))
        for vdt in (torch.float32, torch.float64):
            src = torch.randn((V * C, T, Kc, 128), dtype=vdt, device=dev,
                              generator=g)
            out = K.lane_scatter_cm(src, ix, **kw)
            torch.cuda.synchronize()
            ref = K.lane_scatter_cm_plain(src, ix, k_out=wg, n_ch=C)
            exact = bool(torch.equal(out, ref))
            nb = sum(x.numel() * x.element_size() for x in (src, ix, out))
            r = dict(shape=name, dtype=str(vdt), exact=exact,
                     table=[T, V, Kc, 128], idx_dtype=str(ix.dtype), C=C,
                     k_out=wg, ms=_events(lambda: K.lane_scatter_cm(
                         src, ix, **kw)),
                     plain_ms=_mean(lambda: K.lane_scatter_cm_plain(
                         src, ix, k_out=wg, n_ch=C), 2),
                     index_add_ms=_events(index_add_yardstick(src, ix,
                                                              ref)),
                     bound_bytes=nb, bound_ms=nb / HBM_BYTES_PER_S * 1e3,
                     padding_share=float((ix < 0).float().mean()), **extra)
            if has_table:
                rb = real_entry_bytes(src, ix, table, out)
                r.update(real_bound_bytes=rb,
                         real_bound_ms=rb / HBM_BYTES_PER_S * 1e3,
                         geometry=K.scatter_cm_geometry(
                             wg, C, V, Kc, src.element_size()))
                if sweep:
                    r["sweep"] = _geometry_sweep(K, src, table, ref, C)
            res.append(r)
            del src, out, ref
    return res


def main():
    if not torch.cuda.is_available():
        print("scatter_cm_bench: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from tpufem_torch.lane import _build
    from tpufem_torch.perf.lattice_bench import ptxas_of, smi

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", help="load the tables from this file, or "
                    "build them and save them there")
    ap.add_argument("--sweep", action="store_true",
                    help="also time other launch geometries")
    opts = ap.parse_args()
    dev = torch.device("cuda", 0)
    print(smi(), flush=True)
    seconds = _build.build(verbose=True)
    _build.load()
    ptx = {k: v for k, v in ptxas_of(_build.build_log).items()
           if "lane_scatter_cm_kernel" in k}
    if opts.tables and os.path.exists(opts.tables):
        tabs = torch.load(opts.tables)
    else:
        tabs = build_tables()
        if opts.tables:
            torch.save(tabs, opts.tables)
    tree = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(_build.__file__))))
    res = bench(tabs, dev, opts.sweep)
    for r in res:
        r.update(tree=tree, build_seconds=seconds)
        print(json.dumps(r), flush=True)
    print(json.dumps(dict(tree=tree, ptxas=ptx)), flush=True)
    if not all(r["exact"] and all(s["exact"] for s in r.get("sweep", ()))
               for r in res):
        sys.exit(1)


if __name__ == "__main__":
    main()
