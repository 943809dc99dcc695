"""Demo: 2D dynamic optimal transport (equivalent of ``demo_dot2d.m``).

Default config matches the reference: nt=33, nx=ny=129, tol=1e-4, 3 levels,
DOTmark 4-stitch densities, algorithm selectable among all six.
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
        default="DOTmark_4stitch",
        choices=[
            "example1", "example2", "example3", "example4", "example5",
            "example7", "circle", "DOTmark_4stitch",
        ],
    )
    ap.add_argument("--nx", type=int, default=129)
    ap.add_argument("--ny", type=int, default=0, help="defaults to nx")
    ap.add_argument("--nt", type=int, default=33)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument(
        "--method",
        default="inPALM",
        choices=["PALM", "inPALM", "ALG2", "acc-ADMM", "sGS-inPALM", "acc-sGS-ADMM"],
    )
    ap.add_argument("--maxit", type=int, default=3000)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--refine-tol", type=float, default=None,
                    help="mixed precision: f32 multilevel + f64 tail to "
                         "this KKT tolerance (enables x64)")
    ap.add_argument("--export", default=None,
                    help="publication export: .pdf/.png/.jpg frame series or .gif")
    ap.add_argument("--plot", default=None, help="save evolution plot to path")
    ap.add_argument("--images", nargs=2, default=None,
                    help="solve between two image files instead of --problem")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64 or args.refine_tol is not None:
        jax.config.update("jax_enable_x64", True)

    from dotsocp.models.examples import get_example_2d, get_example_from_images
    from dotsocp.multilevel.solve import solve_dot
    from dotsocp.multilevel.level import check_mass_conservation

    ny = args.ny or args.nx
    if args.images:
        rho0, rho1 = get_example_from_images(args.images[0], args.images[1],
                                             args.nx, ny)
    else:
        rho0, rho1 = get_example_2d(args.problem, args.nx, ny)
    out, hml, h = solve_dot(
        rho0, rho1, args.nt, args.levels,
        {"tol": args.tol, "maxit": args.maxit,
         **({"refine_tol": args.refine_tol}
            if args.refine_tol is not None else {})}, args.method,
    )
    print("=" * 64)
    print(f"Mass conservation: {'OK' if out['mass_ok'] else 'VIOLATED'}")
    check_mass_conservation(np.asarray(out["rho"]), verbose=True)
    print("Final KKT:", h["kkt"][-1])
    from dotsocp.utils.objective import transport_cost
    print(f"W2^2 (Benamou-Brenier energy): "
          f"{transport_cost(out['rho'], [out['Ey'], out['Ex']]):.6f}")
    if args.plot:
        from dotsocp.viz.plots import show_evolution_2d

        show_evolution_2d(out["rho"], "imshow",
                          f"Density evolution of {args.method}", save=args.plot)
        print("saved", args.plot)
    if args.export:
        from dotsocp.viz.plots import export_evolution_2d

        paths = export_evolution_2d(out["rho"], args.export, mode="imshow",
                                    barrier_mask=None)
        print("exported", *paths)


if __name__ == "__main__":
    main()
