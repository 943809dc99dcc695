"""f32 robustness sweep: every bundled 2D example at the headline config
(129x129x33, tol 1e-4, 3 levels, inPALM, f32, device driver).

The f32 KKT floor sits near 1e-4 (BASELINE.md), which is exactly the
headline tolerance — this sweep proves the f32 path converges (rather than
stalls) on each bundled problem, including the hard ones (example3's
exp-exp density, circle's discontinuous discs). Results are recorded in
BASELINE.md; the CI-sized counterpart is tests/test_f32_robustness.py.

Run on GPU:   python scripts/f32_sweep.py
Run on CPU:   python scripts/f32_sweep.py --cpu
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from dotsocp.utils.cache import enable_compilation_cache

enable_compilation_cache()
import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from dotsocp.models.examples import get_example_2d
from dotsocp.multilevel.solve import solve_dot

EXAMPLES = ["example1", "example2", "example3", "example4", "example5",
            "example7", "circle", "DOTmark_4stitch"]
NT, N, TOL, LEVELS = 33, 129, 1e-4, 3

rows = []
for name in EXAMPLES:
    rho0, rho1 = get_example_2d(name, N, N)
    t0 = time.time()
    out, hml, _ = solve_dot(
        rho0, rho1, NT, LEVELS,
        {"tol": TOL, "driver": "device", "maxit": 3000, "prewarm": name == EXAMPLES[0]},
        "inPALM", dtype=jnp.float32, verbose=False,
    )
    kkt = np.asarray(hml["kkt"][-1])
    stop = float(np.max(kkt[[0, 2, 5, 6]]))
    iters = [l["iters"] for l in out["levels"]]
    converged = stop < TOL and iters[-1] < 3000
    rows.append({
        "example": name,
        "iters": iters,
        "final_kkt_max": stop,
        "mass_ok": bool(out["mass_ok"]),
        "converged": bool(converged),
        "time_s": round(out["total_time"], 3),
    })
    print(json.dumps(rows[-1]), flush=True)

ok = all(r["converged"] and r["mass_ok"] for r in rows)
print(f"\nall converged in f32 at tol {TOL}: {ok}")
