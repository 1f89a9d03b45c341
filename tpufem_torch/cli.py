"""Runtime command-line interface of the port.

    python -m tpufem_torch polycrystal -n 1024 [--pc jacobi] [--no-fused]
        [--mixed]

Only the ``polycrystal`` subcommand is ported so far. It runs on the GPU
(``--device cuda``, the default) and exits with an error if there is
none; ``--device cpu`` runs the same code on the host. It prints the
Newton statistics and the reference-schema phase timing table
(FEniCSx/...cc:1199-1219).
"""

from __future__ import annotations

import argparse
import sys


def _add_solver_flags(p: argparse.ArgumentParser) -> None:
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
    g.add_argument("--pc", default="twolevel", choices=["jacobi", "twolevel"],
                   help="preconditioner of the lane CG (default twolevel: "
                        "the lattice-coarse two-level cycle, as in the "
                        "reference)")


def _solver_config(args):
    from tpufem_torch.config import SolverConfig

    return SolverConfig(
        newton_rtol=args.rel, newton_atol=args.abs_,
        newton_maxit=args.maxit, cg_rtol=args.cg_rtol,
        cg_maxit=args.cg_maxit,
        preconditioner=args.pc, verbose=bool(args.verbose),
    )


def _cmd_polycrystal(args) -> int:
    import torch

    from tpufem_torch.cases import polycrystal

    res = polycrystal.run(
        args.n, n_grains=args.grains, use_ecst=args.ecst,
        solver=_solver_config(args),
        wg_own=args.wg_own, smooth_iters=args.smooth_iters,
        n_damage_chains=args.chains, fused=args.fused, mixed=args.mixed,
        device=args.device,
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
    _add_solver_flags(p)
    p.set_defaults(fn=_cmd_polycrystal)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
