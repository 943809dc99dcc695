"""Demo: 3D dynamic optimal transport — a capability beyond the reference.

The dimension-generic core (ops/engine.py, cone width 2 + 4*3 = 14, 4-axis
matmul-DCT) solves (nt, nz, ny, nx) grids with the same multilevel inPALM
machinery as 1D/2D. Default config: 33^3 x nt=17, tol 1e-4, 2 levels.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="gaussian",
                    choices=["gaussian", "split8"])
    ap.add_argument("--n", type=int, default=33, help="spatial points/axis")
    ap.add_argument("--nt", type=int, default=17)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--method", default="inPALM",
                    choices=["PALM", "inPALM", "ALG2", "acc-ADMM"])
    ap.add_argument("--maxit", type=int, default=3000)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--plot", default=None,
                    help="save a slices-over-time plot to path")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)

    from dotsocp.models.examples import get_example_3d
    from dotsocp.multilevel.level import check_mass_conservation
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_3d(args.problem, args.n, args.n, args.n)
    out, hml, h = solve_dot(
        rho0, rho1, args.nt, args.levels,
        {"tol": args.tol, "maxit": args.maxit}, args.method,
    )
    print("=" * 64)
    print(f"Mass conservation: {'OK' if out['mass_ok'] else 'VIOLATED'}")
    check_mass_conservation(np.asarray(out["rho"]), verbose=True)
    print("Final KKT:", h["kkt"][-1])
    from dotsocp.utils.objective import transport_cost
    print(f"W2^2 (Benamou-Brenier energy): "
          f"{transport_cost(out['rho'], list(out['E'])):.6f}")
    if args.plot:
        from dotsocp.viz.plots import show_evolution_3d

        show_evolution_3d(np.asarray(out["rho"]), save=args.plot)
        print(f"saved {args.plot}")


if __name__ == "__main__":
    main()
