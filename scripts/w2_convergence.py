"""W2 convergence study (VERDICT r4 item 7): Gaussian-pair W2^2 error vs
closed form as the grid refines — turns the single-size "within X%" checks
of tests/test_objective.py into an order-of-accuracy measurement.

Gaussian choices keep the box truncation negligible (>= 4.3 sigma to the
nearest boundary, ~1e-5 tail mass) so the measured error is the
discretization error of the staggered scheme + recovery, not the
truncated-Gaussian bias:
  1D: N(0.35, 0.07^2) -> N(0.65, 0.05^2), W2^2 = 0.09 + 0.0004 = 0.0904
  2D: N((0.35,0.35), 0.07^2 I) -> N((0.65,0.65), 0.05^2 I),
      W2^2 = 2*0.09 + 2*0.0004 = 0.1808
Both space and time refine together (h and ht halve per step) so a single
order comes out of the ratios.

Run:  python scripts/w2_convergence.py [--dim 1|2] [--tol 1e-6]
"""
import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=1, choices=[1, 2])
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--sizes", type=str, default=None,
                    help="comma-separated nx list (nt = (nx-1)/4 + 1)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from dotsocp.models.examples import _gaussian2d, _normalize
    from dotsocp.multilevel.solve import solve_dot
    from dotsocp.utils.objective import (
        gaussian_w2_squared, transport_cost,
    )

    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",")]
    else:
        sizes = [65, 129, 257, 513] if args.dim == 1 else [65, 129, 257]

    m0, m1, s0, s1 = 0.35, 0.65, 0.07, 0.05
    if args.dim == 1:
        ref = gaussian_w2_squared(m0, m1, s0, s1)
    else:
        ref = gaussian_w2_squared((m0, m0), (m1, m1), s0, s1)
    print(f"dim={args.dim}  ref W2^2 = {ref:.6f}")

    prev = None
    for nx in sizes:
        nt = (nx - 1) // 4 + 1
        x = np.linspace(0.0, 1.0, nx)
        if args.dim == 1:
            rho0 = _normalize(np.exp(-0.5 * ((x - m0) / s0) ** 2))
            rho1 = _normalize(np.exp(-0.5 * ((x - m1) / s1) ** 2))
        else:
            g0 = _gaussian2d(nx, nx, m0, m0, s0)
            g1 = _gaussian2d(nx, nx, m1, m1, s1)
            rho0, rho1 = _normalize(g0), _normalize(g1)
        t0 = time.time()
        out, _, h = solve_dot(
            rho0, rho1, nt, 2, {"tol": args.tol, "maxit": 20000},
            "inPALM", dtype=jnp.float64, verbose=False,
        )
        Es = [out["Ex"]] if args.dim == 1 else [out["Ey"], out["Ex"]]
        w2 = transport_cost(out["rho"], Es)
        err = abs(w2 - ref) / ref
        order = (math.log2(prev / err) if prev else float("nan"))
        print(f"nx={nx:5d} nt={nt:4d}  W2^2={w2:.6f}  relerr={err:.3e}  "
              f"order={order:.2f}  kkt={float(max(h['kkt'][-1][i] for i in (0,2,5,6))):.1e}"
              f"  {time.time()-t0:.1f}s", flush=True)
        prev = err


if __name__ == "__main__":
    main()
