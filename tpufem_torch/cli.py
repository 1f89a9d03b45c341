"""Runtime command-line interface of the port.

    python -m tpufem_torch mechanic2d -r 2 --rel 1e-7 --abs 5e-8
    python -m tpufem_torch polycrystal -n 1024 [--pc jacobi] [--no-fused]
        [--mixed] [--output out.xdmf]

The ``mechanic2d`` and ``polycrystal`` subcommands are ported (the
reference's ``elasticity3d`` / ``neohookean`` are queued in ROADMAP.md).
They run on the GPU (``--device cuda``, the default) and exit with an
error if there is none; ``--device cpu`` runs the same code on the host.
Each prints the Newton statistics and the reference-schema phase timing
table (FEniCSx/...cc:1199-1219); ``mechanic2d`` exits with 2 when Newton
does not converge, as the reference does.
"""

from __future__ import annotations

import argparse
import sys


def _add_solver_flags(p: argparse.ArgumentParser):
    """The solver flags both subcommands share; returns their group."""
    g = p.add_argument_group("solver (reference: -rel/-abs/-petscopts)")
    g.add_argument("--rel", type=float, default=1e-7,
                   help="Newton relative tolerance (default 1e-7)")
    g.add_argument("--abs", dest="abs_", type=float, default=5e-8,
                   help="Newton absolute tolerance (default 5e-8)")
    g.add_argument("--maxit", type=int, default=10,
                   help="Newton max iterations (default 10)")
    g.add_argument("--cg-rtol", type=float, default=1e-12,
                   help="CG relative tolerance (default 1e-12)")
    g.add_argument("--cg-maxit", type=int, default=2000,
                   help="CG max iterations (default 2000)")
    return g


def _add_mechanic2d_pc_flags(g) -> None:
    """The reference's --pc and --convergence (tpufem/cli.py:40-51)."""
    g.add_argument("--pc", default=None,
                   choices=["none", "jacobi", "chebyshev", "block_jacobi",
                            "amg", "twolevel"],
                   help="preconditioner (default jacobi, the only one "
                        "ported for mechanic2d; the others raise)")
    g.add_argument("--convergence", default="r0", choices=["r0", "du0"],
                   help="nonlinear convergence convention: r0 (MFEM) or "
                        "du0 (dolfinx); doc.tex:2065-2068")


def _solver_config(args, **overrides):
    from tpufem_torch.config import SolverConfig

    kw = dict(
        newton_rtol=args.rel, newton_atol=args.abs_,
        newton_maxit=args.maxit, cg_rtol=args.cg_rtol,
        cg_maxit=args.cg_maxit,
        preconditioner=args.pc, verbose=bool(args.verbose),
    )
    kw.update(overrides)
    return SolverConfig(**kw)


def _cmd_mechanic2d(args) -> int:
    import torch

    from tpufem_torch.cases import mechanic2d
    from tpufem_torch.config import Mechanic2DConfig

    cfg = Mechanic2DConfig(
        max_refine=args.refine, max_dam=args.max_dam,
        use_trac=not args.compression, use_ecst=args.ecst,
        mesh_path=args.mesh, degree=args.degree,
        output_dir=args.output,
        solver=_solver_config(
            args, convergence=args.convergence,
            preconditioner=args.pc if args.pc is not None else "jacobi"),
    )
    res = mechanic2d.run(
        cfg, device=args.device,
        dtype=torch.float64 if args.x64 else torch.float32,
    )
    u = res.u
    print(f"newton iterations: {res.newton_iterations}  "
          f"cg: {res.krylov_iters}")
    print(f"|u|_inf = {float(abs(u).max()):.6e}  "
          f"energy = {float(res.energy.sum()):.6e}")
    print(res.timers.report())
    return 0


def _cmd_polycrystal(args) -> int:
    import torch

    from tpufem_torch.cases import polycrystal

    res = polycrystal.run(
        args.n, n_grains=args.grains, use_ecst=args.ecst,
        solver=_solver_config(args),
        wg_own=args.wg_own, smooth_iters=args.smooth_iters,
        n_damage_chains=args.chains, fused=args.fused, mixed=args.mixed,
        output_path=args.output, device=args.device,
        dtype=torch.float64 if args.x64 else torch.float32,
    )
    print(f"dofs: {res.n_dofs}  energy = {res.energy:.6e}")
    print(f"stats: {res.stats}")
    for k, v in res.timings.items():
        print(f"  {k:<34s} {v:10.3f} s")
    return 0 if res.stats["converged"] else 2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpufem_torch",
        description="PyTorch/CUDA port of the tpufem FEM framework -- "
                    "bundled workloads",
    )
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="print the Newton trace")
    ap.add_argument("--x64", action="store_true",
                    help="float64 (reference precision) instead of float32")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; fails without one)")
    sub = ap.add_subparsers(dest="command", required=True)

    m = sub.add_parser("mechanic2d",
                       help="asym elasto-damage on a gmsh mesh "
                            "(the reference workload)")
    m.add_argument("-r", "--refine", type=int, default=0,
                   help="uniform refinements (reference -r / MAX_REFINE)")
    m.add_argument("--max-dam", type=float, default=1.0,
                   help="damage band amplitude (MAX_DAM)")
    m.add_argument("--mesh", default=None,
                   help="gmsh 2.2 mesh path (default: bundled square.msh)")
    m.add_argument("--degree", type=int, default=1, choices=[1, 2],
                   help="displacement space degree")
    m.add_argument("--compression", action="store_true",
                   help="-0.01 imposed displacement (reference: "
                        "undef USE_TRAC)")
    m.add_argument("--ecst", action="store_true",
                   help="constant E=1e6 instead of per-grain random "
                        "(USE_ECST)")
    m.add_argument("--output", default=None, help="output directory "
                   "(writes VTU + XDMF fields)")
    _add_mechanic2d_pc_flags(_add_solver_flags(m))
    m.set_defaults(fn=_cmd_mechanic2d)

    p = sub.add_parser("polycrystal",
                       help="generated Neper-like polycrystal at scale "
                            "through the lane engine")
    p.add_argument("-n", type=int, default=128,
                   help="lattice resolution of the jittered Delaunay "
                        "(128 -> ~33k dofs, 1024 -> ~2.1M)")
    p.add_argument("--grains", type=int, default=200,
                   help="number of Voronoi grains (reference: 200)")
    p.add_argument("--chains", type=int, default=30,
                   help="damaged grain-boundary chains (reference: 30)")
    p.add_argument("--smooth-iters", type=int, default=8,
                   help="damage smoothing iterations "
                        "(reference: 8*(MAX_REFINE+1))")
    p.add_argument("--wg-own", type=int, default=16)
    p.add_argument("--ecst", action="store_true")
    p.add_argument("--fused", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="residual and CG operator through the fused element "
                        "kernel lane_fused_elem (default); --no-fused runs "
                        "the staged gather / physics / scatter pipeline")
    p.add_argument("--mixed", action="store_true",
                   help="mixed precision: float64 Newton on the flat "
                        "assembler around the lane engine's CG in float32 "
                        "(float64 with --x64); reaches float64 accuracy")
    p.add_argument("--output", default=None,
                   help="output path (XDMF + one HDF5 file of heavy data)")
    _add_solver_flags(p).add_argument(
        "--pc", default="twolevel", choices=["jacobi", "twolevel"],
        help="preconditioner of the lane CG (default twolevel: the "
             "lattice-coarse two-level cycle, as in the reference)")
    p.set_defaults(fn=_cmd_polycrystal)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose:
        import logging

        from tpufem_torch.utils.log import init_logging

        init_logging(logging.DEBUG if args.verbose > 1 else logging.INFO)
    from tpufem_torch.nls import NonConvergenceError

    try:
        return args.fn(args)
    except NonConvergenceError as e:  # reference: MPI_Abort(-1234)
        print(f"NONCONVERGED: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
