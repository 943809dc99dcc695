"""Generate golden KKT-trajectory fixtures for canonical configs.

Run from the repo root on the CPU backend (the same environment CI uses):

    python tests/golden/generate.py

Each fixture records, for the HOST driver in float64 (the readable
reference implementation of the sigma/rescale/cadence machinery,
``algorithms/driver.py``), the full run history per level: per-check KKT
7-vectors, check iteration numbers, pdGap, per-level iteration totals and
the final sigma. Any behavioural drift in the sigma tables, rescale state
machine, cadence logic, scaling, or multilevel plumbing changes these and
fails tests/test_golden.py. Image-based configs force the procedural
densities so the fixture is environment-independent.

The MATLAB reference cannot execute here (binary MEX kernels, no MATLAB);
these fixtures pin OUR trajectory — the cross-implementation checks are
the per-operator unit tests and the C++ golden oracle (tests/test_native.py).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
os.environ["DOTSOCP_RESOURCES"] = "procedural"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


CONFIGS = {
    # name: (family, problem, space_n, nt, levels, tol, method, opts)
    "dot1d_gaussian_129x9_l2_inpalm": ("1d", "gaussian", 129, 9, 2, 1e-5, "inPALM", {}),
    "dot2d_example1_65x17_l2_inpalm": ("2d", "example1", 65, 17, 2, 1e-4, "inPALM", {}),
    "dot2d_example2_65x17_l2_accadmm": ("2d", "example2", 65, 17, 2, 1e-4, "acc-ADMM", {}),
    "dot2d_dotmark_65x17_l2_inpalm": ("2d", "DOTmark_4stitch", 65, 17, 2, 1e-4, "inPALM", {}),
    "dot2d_example2_65x17_l2_sgsinpalm": ("2d", "example2", 65, 17, 2, 1e-4, "sGS-inPALM", {}),
    "wdot2d_loveheart_65x17_l2_inpalm": ("w2d", "love-heart", 65, 17, 2, 1e-3, "inPALM", {}),
}


def run_config(name):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from dotsocp.multilevel.solve import solve_dot

    family, problem, n, nt, levels, tol, method, extra = CONFIGS[name]
    opts = {"tol": tol, "driver": "host", **extra}
    kwargs = {}
    if family == "1d":
        from dotsocp.models.examples import get_example_1d

        rho0, rho1 = get_example_1d(problem, n)
    elif family == "2d":
        from dotsocp.models.examples import get_example_2d

        rho0, rho1 = get_example_2d(problem, n, n)
    else:
        from dotsocp.models.wdot2d import (
            barrier_love_heart,
            ensure_barrier_validity,
            get_example_w2d,
            get_weight_by_barrier,
        )

        rho0, rho1 = get_example_w2d(problem, n, n)
        barrier = barrier_love_heart()
        weight = get_weight_by_barrier(n, n, nt, barrier)
        rho0, rho1, _ = ensure_barrier_validity(rho0, rho1, barrier)
        kwargs = {"weight": weight, "barrier": barrier}

    out, hml, h = solve_dot(rho0, rho1, nt, levels, opts, method,
                            dtype=jnp.float64, verbose=False, **kwargs)
    return {
        "kkt": np.asarray(hml["kkt"], np.float64),
        "iter": np.asarray(hml["iter"], np.int64),
        "pdGap": np.asarray(hml["pdGap"], np.float64),
        "level_iters": np.asarray([l["iters"] for l in out["levels"]], np.int64),
        "mass_ok": np.asarray(bool(out["mass_ok"])),
    }


def main():
    out_dir = os.path.dirname(os.path.abspath(__file__))
    for name in CONFIGS:
        rec = run_config(name)
        path = os.path.join(out_dir, name + ".npz")
        np.savez_compressed(path, **rec)
        print(f"{name}: levels={rec['level_iters'].tolist()} "
              f"checks={len(rec['iter'])} final_kkt136="
              f"{rec['kkt'][-1][[0, 2, 5]]}")


if __name__ == "__main__":
    main()
