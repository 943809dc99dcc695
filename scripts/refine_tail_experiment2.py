"""Round-4 refine-tail experiment: can the f64 tail (1e-4 -> 1e-6) get
under ~1100 fine-level iterations? (VERDICT r3 item 3; baseline measured
round 3: inPALM tail 1169 iters on example1 65^2x17, example2 hits the
10k cap; acc-ADMM with the default restart=100 LOSES — anchor restarts
discard high-accuracy momentum.)

Matrix here: tail = inPALM baseline vs acc-ADMM with long/no restart
periods (the knob the round-3 experiment never varied).

  python scripts/refine_tail_experiment2.py
"""
import os
import sys, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np          # noqa: E402
import jax.numpy as jnp     # noqa: E402

from dotsocp.multilevel.solve import solve_dot  # noqa: E402
from dotsocp.models.examples import get_example_2d  # noqa: E402


def run(problem, n, nt, refine_method, restart=100):
    rho0, rho1 = get_example_2d(problem, n, n)
    out, hml, h = solve_dot(
        rho0, rho1, nt, 2,
        {"tol": 1e-4, "maxit": 10000, "refine_tol": 1e-6,
         "refine_method": refine_method, "restart": restart,
         "reuse_solvers": False, "driver": "device"},
        "inPALM", dtype=jnp.float32, verbose=False,
    )
    tail = out["levels"][-1]
    k = h["kkt"][-1]
    return tail["iters"], tail["time"], float(np.max(k[[0, 2, 5, 6]]))


CASES = [
    ("inPALM", 100),
    ("acc-ADMM", 500),
    ("acc-ADMM", 2000),
    ("acc-ADMM", 10**9),
]

for problem, n, nt in (("example1", 65, 17), ("example2", 65, 17)):
    print(f"--- {problem} {n}x{n}x{nt}, f32 2-level + f64 tail to 1e-6",
          flush=True)
    for m, rs in CASES:
        try:
            t0 = time.time()
            iters, t, kk = run(problem, n, nt, m, rs)
            print(f"  tail={m:10s} restart={rs:>10}: {iters:5d} iters, "
                  f"{t:7.1f}s, final KKT {kk:.2e}  (wall {time.time()-t0:.0f}s)",
                  flush=True)
        except Exception as e:
            print(f"  tail={m:10s} restart={rs:>10}: FAILED "
                  f"{type(e).__name__}: {e}", flush=True)
