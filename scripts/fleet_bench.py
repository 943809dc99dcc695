"""Fleet-throughput benchmark: B independent 129x129x33 DOT instances
solved in lockstep on one device (the embarrassingly-parallel BASELINE.md
axis; the reference has no batch mode at all).

Eight *different* bundled problems (example1/2/3/4/circle/DOTmark + two
distinct gaussian-pair variants) so the per-instance sigma tables, rescale
triggers, and convergence iterations genuinely diverge — the lockstep
driver's branch-free machinery (parallel/batch.py) is what's being
exercised, not eight copies of one trajectory.

Config per instance mirrors the headline bench (demo_dot2d.m:10-17):
nt=33, 129x129, tol 1e-4, 3 levels, inPALM. Reports instances/s and the
ratio to solving the same 8 problems sequentially with the single-instance
device driver.

Run:  python scripts/fleet_bench.py            (GPU)
      python scripts/fleet_bench.py --cpu      (CPU smoke, small grid)
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CPU = "--cpu" in sys.argv
if CPU:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import jax.numpy as jnp
import numpy as np

from dotsocp.utils.cache import enable_compilation_cache
from dotsocp.models.examples import get_example_2d, _gaussian2d, _normalize
from dotsocp.parallel.batch import pick_fleet_mode, solve_batch, solve_fleet
from dotsocp.multilevel.solve import solve_dot

enable_compilation_cache()

N = 33 if CPU else int(os.environ.get("FLEET_N", "129"))
NT = 9 if CPU else int(os.environ.get("FLEET_NT", "33"))
TOL = 1e-3 if CPU else float(os.environ.get("FLEET_TOL", "1e-4"))
LEVELS = 2 if CPU else int(os.environ.get("FLEET_LEVELS", "3"))


def make_fleet(n):
    if os.environ.get("FLEET_HOMOG"):
        # homogeneous fleet: isolates batched-step amortization from the
        # lockstep straggler cost (all instances converge together)
        pairs = [get_example_2d("DOTmark_4stitch", n, n)] * 8
        r0 = np.stack([np.asarray(a) for a, _ in pairs])
        r1 = np.stack([np.asarray(b) for _, b in pairs])
        return ["DOTmark_4stitch"] * 8, r0, r1
    probs = ["example1", "example2", "example3", "example4", "circle",
             "DOTmark_4stitch"]
    pairs = [get_example_2d(p, n, n) for p in probs]
    # two gaussian variants with different separations -> different sigma paths
    def gpair(a, b, s):
        return (_normalize(_gaussian2d(n, n, a[0], a[1], s)),
                _normalize(_gaussian2d(n, n, b[0], b[1], s)))

    pairs.append(gpair((0.3, 0.3), (0.7, 0.7), 0.08))
    pairs.append(gpair((0.2, 0.5), (0.8, 0.5), 0.12))
    r0 = np.stack([np.asarray(a) for a, _ in pairs])
    r1 = np.stack([np.asarray(b) for _, b in pairs])
    return probs + ["gauss_diag", "gauss_horiz"], r0, r1


def main():
    names, r0, r1 = make_fleet(N)
    B = r0.shape[0]
    opts = {"tol": TOL, "maxit": 3000}

    # warm pass (compile), then the timed pass
    solve_batch(r0, r1, NT, opts, "inPALM", dtype=jnp.float32,
                level_n=LEVELS, verbose=False)
    t0 = time.monotonic()
    out = solve_batch(r0, r1, NT, opts, "inPALM", dtype=jnp.float32,
                      level_n=LEVELS, verbose=False)
    fleet_t = time.monotonic() - t0

    # sequential comparison: same 8 problems, single-instance device driver
    seq_t = 0.0
    seq_iters = []
    for b in range(B):
        o, _, _ = solve_dot(r0[b], r1[b], NT, LEVELS,
                            {"tol": TOL, "maxit": 3000, "driver": "device",
                             "prewarm": b == 0},
                            "inPALM", dtype=jnp.float32, verbose=False)
        seq_t += o["total_time"]
        seq_iters.append(sum(l["iters"] for l in o["levels"]))

    # the ergonomic front door: solve_fleet(mode='auto') must pick the
    # winning mode from the decision table (>= best single mode)
    auto_mode = pick_fleet_mode(B, (N, N), NT, len(jax.devices()))
    t0 = time.monotonic()
    out_auto = solve_fleet(r0, r1, NT, opts, "inPALM", dtype=jnp.float32,
                           level_n=LEVELS, mode="auto", verbose=False)
    auto_t = time.monotonic() - t0

    done_it = out["done_it"].tolist()
    result = {
        "metric": f"fleet_B{B}_dot2d_{N}x{N}x{NT}_tol{TOL:g}_{LEVELS}level",
        "fleet_seconds": round(fleet_t, 3),
        "instances_per_s": round(B / fleet_t, 3),
        "sequential_seconds": round(seq_t, 3),
        "speedup_vs_sequential": round(seq_t / fleet_t, 2),
        "auto_mode": out_auto["mode"],
        "auto_seconds": round(auto_t, 3),
        "auto_solve_seconds": round(float(out_auto["time"]), 3),
        "auto_instances_per_s": round(B / auto_t, 3),
        "all_done": bool(out["done"].all()),
        "final_level_done_iters": done_it,
        "seq_total_iters": seq_iters,
        "device": str(jax.devices()[0]),
    }
    assert out_auto["mode"] == auto_mode
    print(json.dumps(result))
    for n_, d in zip(names, done_it):
        print(f"  {n_:18s} final-level iters {d}")


if __name__ == "__main__":
    main()
