"""Which algorithm should run the f64 refine tail?

ROADMAP round-2 gap 3: the f32 -> f64 refinement tail (1e-4 -> 1e-6) costs
~2250 inPALM iterations and the warm start only saves ~12%. The acc-ADMM
family has an O(1/k) ergodic rate with Halpern anchoring — this experiment
measures whether switching the TAIL method (multilevel stays inPALM)
shortens it. CPU f64, two problems, tail tolerance 1e-6.

  python scripts/refine_tail_experiment.py

RESULT (recorded 2026-08, this machine): acc-ADMM does NOT shorten the
tail — example1: 1569 iters / 41.9 s vs inPALM 1169 iters / 19.7 s;
example2: both hit the 10k cap (KKT 2.1e-6 vs 1.7e-6, inPALM ahead).
Halpern anchoring restarts every 100 iterations, which discards the
high-accuracy momentum exactly where the tail needs it. Default tail
method stays the sweep's method; ``refine_method`` remains available.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np          # noqa: E402
import jax.numpy as jnp     # noqa: E402

from dotsocp.multilevel.solve import solve_dot  # noqa: E402
from dotsocp.models.examples import get_example_2d  # noqa: E402


def run(problem, n, nt, refine_method):
    rho0, rho1 = get_example_2d(problem, n, n)
    out, hml, h = solve_dot(
        rho0, rho1, nt, 2,
        {"tol": 1e-4, "maxit": 10000, "refine_tol": 1e-6,
         "refine_method": refine_method, "reuse_solvers": False,
         "driver": "host"},
        "inPALM", dtype=jnp.float32, verbose=False,
    )
    tail = out["levels"][-1]
    k = h["kkt"][-1]
    return tail["iters"], tail["time"], float(np.max(k[[0, 2, 5, 6]]))


for problem, n, nt in (("example2", 65, 17), ("example1", 65, 17)):
    print(f"--- {problem} {n}x{n}x{nt}, f32 2-level + f64 tail to 1e-6")
    for m in ("inPALM", "acc-ADMM"):
        try:
            iters, t, kk = run(problem, n, nt, m)
            print(f"  tail={m:10s}: {iters:5d} iters, {t:7.1f}s, "
                  f"final KKT {kk:.2e}")
        except Exception as e:
            print(f"  tail={m:10s}: FAILED {type(e).__name__}: {e}")
