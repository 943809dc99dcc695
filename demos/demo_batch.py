"""Demo: fleet solve — many independent 2D transport problems through
``solve_fleet`` (a capability the reference lacks). ``--mode auto`` (the
default) picks sequential / lockstep / mesh-sharded from the problem size
and device count (the BASELINE.md fleet decision table).
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--nx", type=int, default=65)
    ap.add_argument("--nt", type=int, default=17)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "sequential", "lockstep", "sharded"],
                    help="fleet execution mode (auto = decision table)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from dotsocp.models.examples import get_example_2d
    from dotsocp.parallel.batch import solve_fleet

    rng = np.random.default_rng(0)
    r0s, r1s = [], []
    base0, base1 = get_example_2d("example2", args.nx, args.nx)
    for b in range(args.batch):
        shift = int(rng.integers(0, args.nx // 4))
        r0s.append(np.roll(base0, shift, axis=1))
        r1s.append(np.roll(base1, -shift, axis=0))

    out = solve_fleet(
        np.stack(r0s), np.stack(r1s), args.nt,
        {"tol": args.tol, "maxit": 3000},
        level_n=args.levels, dtype=jnp.float32, mode=args.mode,
    )
    print("mode:", out["mode"])
    print("per-instance max KKT:", np.asarray(out["kkt"])[:, [0, 2, 5, 6]].max(axis=1))
    print("converged:", out["done"], "at final-level iteration", out["done_it"])
    print(f"fleet time: {out['time']:.2f}s ({args.batch / out['time']:.2f} inst/s)")


if __name__ == "__main__":
    main()
