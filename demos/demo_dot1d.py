"""Demo: 1D dynamic optimal transport (equivalent of ``demo_dot1d.m``).

Default config matches the reference: nt=33, nx=1025, tol=1e-5, 3 levels,
inPALM, Gaussian pair.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="gaussian", choices=["gaussian", "box"])
    ap.add_argument("--nx", type=int, default=1025)
    ap.add_argument("--nt", type=int, default=33)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--method", default="inPALM")
    ap.add_argument("--maxit", type=int, default=3000)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--f64", action="store_true", default=True,
                    help="run in float64 (default: the reference 1D tol of "
                         "1e-5 is below float32 reach)")
    ap.add_argument("--f32", dest="f64", action="store_false")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed precision: f32 multilevel to 1e-4, then a "
                         "float64 refinement tail to --tol on the finest "
                         "level (f32 stalls near 1e-4)")
    ap.add_argument("--plot", default=None, help="save evolution plot to path")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64 or args.mixed:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from dotsocp.models.examples import get_example_1d
    from dotsocp.multilevel.solve import solve_dot
    from dotsocp.multilevel.level import check_mass_conservation

    rho0, rho1 = get_example_1d(args.problem, args.nx)
    if args.mixed:
        opts = {"tol": max(args.tol, 1e-4), "maxit": args.maxit,
                "refine_tol": args.tol}
        dtype = jnp.float32
    else:
        opts = {"tol": args.tol, "maxit": args.maxit}
        dtype = None
    out, hml, h = solve_dot(
        rho0, rho1, args.nt, args.levels, opts, args.method, dtype=dtype,
    )
    print("=" * 64)
    print(f"Mass conservation: {'OK' if out['mass_ok'] else 'VIOLATED'}")
    check_mass_conservation(np.asarray(out["rho"]), verbose=True)
    print("Final KKT:", h["kkt"][-1])
    from dotsocp.utils.objective import transport_cost
    print(f"W2^2 (Benamou-Brenier energy): "
          f"{transport_cost(out['rho'], [out['Ex']]):.6f}")
    if args.plot:
        from dotsocp.viz.plots import show_evolution_1d

        show_evolution_1d(out["rho"], "join", save=args.plot)
        print("saved", args.plot)


if __name__ == "__main__":
    main()
