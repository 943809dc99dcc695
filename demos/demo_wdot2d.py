"""Demo: weighted 2D DOT with obstacles (equivalent of ``demo_wdot2d.m``).

Default config matches the reference: nt=nx=ny=129, tol=1e-3, 3 levels,
love-heart barrier, inPALM.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--problem",
        default="love-heart",
        choices=[
            "example1", "example2", "example3", "example4", "circle",
            "circle2", "example6", "maze14", "love-heart",
        ],
    )
    ap.add_argument(
        "--barrier",
        default="love-heart",
        choices=["love-heart", "circle-pillar", "maze14", "example6", "none"],
    )
    ap.add_argument("--weight", default="barrier",
                    choices=["barrier", "circle", "circleInv"])
    ap.add_argument("--nx", type=int, default=129)
    ap.add_argument("--nt", type=int, default=129)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--method", default="inPALM",
                    choices=["inPALM", "ALG2", "acc-ADMM"])
    ap.add_argument("--maxit", type=int, default=10000)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--export", default=None,
                    help="publication export: .pdf/.png/.jpg frame series or .gif")
    ap.add_argument("--plot", default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    from dotsocp.models import wdot2d as W
    from dotsocp.multilevel.solve import solve_dot
    from dotsocp.multilevel.level import check_mass_conservation

    nx = ny = args.nx
    nt = args.nt
    rho0, rho1 = W.get_example_w2d(args.problem, nx, ny)

    barrier = None
    mask = None
    if args.barrier != "none":
        barrier = {
            "love-heart": W.barrier_love_heart,
            "circle-pillar": W.barrier_circle_pillar,
            "maze14": W.barrier_maze14,
            "example6": W.barrier_example6,
        }[args.barrier]()
        rho0, rho1, mask = W.ensure_barrier_validity(rho0, rho1, barrier)

    if args.weight == "barrier":
        weight = W.get_weight_by_barrier(nx, ny, nt, barrier)
    elif args.weight == "circle":
        weight = W.gene_weight_circle(nt, nx, ny)
    else:
        weight = W.gene_weight_circle_inv(nt, nx, ny)

    out, hml, h = solve_dot(
        rho0, rho1, nt, args.levels,
        {"tol": args.tol, "maxit": args.maxit}, args.method,
        weight=weight, barrier=barrier,
    )
    print("=" * 64)
    print(f"Mass conservation: {'OK' if out['mass_ok'] else 'VIOLATED'}")
    check_mass_conservation(np.asarray(out["rho"]), verbose=True)
    print("Final KKT:", h["kkt"][-1])
    if args.plot:
        from dotsocp.viz.plots import show_evolution_2d

        show_evolution_2d(out["rho"], "contourf",
                          f"Density evolution of {args.method}",
                          barrier_mask=mask, save=args.plot)
        print("saved", args.plot)
    if args.export:
        from dotsocp.viz.plots import export_evolution_2d

        paths = export_evolution_2d(out["rho"], args.export, mode="contourf",
                                    barrier_mask=mask)
        print("exported", *paths)


if __name__ == "__main__":
    main()
