"""f32 robustness at the headline tolerance, CI-sized (65x65x17).

The f32 KKT floor is ~1e-4 (BASELINE.md) — the same magnitude as the
reference's default 2D tolerance (``demo_dot2d.m:13``), so a stall would
silently produce a non-converged "result". Every bundled 2D example must
reach tol in f32, conserve mass, and not exhaust maxit. The full-size
sweep (129x129x33 on the accelerator) lives in scripts/f32_sweep.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from dotsocp.models.examples import get_example_2d
from dotsocp.multilevel.solve import solve_dot

EXAMPLES = ["example1", "example2", "example3", "example4", "example5",
            "example7", "circle", "DOTmark_4stitch"]

TOL = 1e-4


@pytest.mark.parametrize(
    "name",
    [pytest.param(n, marks=pytest.mark.slow) if n == "example1" else n
     for n in EXAMPLES],
)
def test_f32_converges_at_headline_tol(name):
    rho0, rho1 = get_example_2d(name, 65, 65)
    out, hml, _ = solve_dot(
        rho0, rho1, 17, 3,
        {"tol": TOL, "driver": "device", "maxit": 3000},
        "inPALM", dtype=jnp.float32, verbose=False,
    )
    kkt = np.asarray(hml["kkt"][-1])
    stop = float(np.max(kkt[[0, 2, 5, 6]]))
    iters = [l["iters"] for l in out["levels"]]
    assert stop < TOL, f"{name}: f32 stalled at KKT {stop:.2e}"
    assert iters[-1] < 3000, f"{name}: exhausted maxit {iters}"
    assert bool(out["mass_ok"])
