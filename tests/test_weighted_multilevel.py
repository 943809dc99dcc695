"""Weighted multilevel: barrier weights restrict in log space, densities
re-validate per level, and the 2-level solve reaches tolerance with host
and device drivers agreeing."""
import numpy as np
import pytest

from dotsocp.models import wdot2d as W
from dotsocp.multilevel.solve import solve_dot


@pytest.fixture(scope="module")
def problem():
    nx = ny = 33
    nt = 17
    rho0, rho1 = W.get_example_w2d("love-heart", nx, ny)
    barrier = W.barrier_love_heart()
    weight = W.get_weight_by_barrier(nx, ny, nt, barrier)
    rho0, rho1, mask = W.ensure_barrier_validity(rho0, rho1, barrier)
    return rho0, rho1, nt, weight, barrier, mask


@pytest.mark.slow
def test_weighted_two_level_host_device_parity(problem):
    rho0, rho1, nt, weight, barrier, mask = problem
    results = {}
    for drv in ("host", "device"):
        out, _, h = solve_dot(
            rho0, rho1, nt, 2, {"tol": 1e-3, "maxit": 4000, "driver": drv},
            "inPALM", weight=weight, barrier=barrier, verbose=False,
        )
        k = h["kkt"][-1]
        assert max(k[0], k[2], k[5]) < 1e-3
        assert out["mass_ok"]
        results[drv] = [L["iters"] for L in out["levels"]]
    assert results["host"] == results["device"]


def test_solver_cache_weight_key_is_content_based(problem):
    """Two separately-built identical weights must produce the SAME cache
    key (an id()-keyed cache would miss), and a different-valued weight a
    DIFFERENT key (an id()-keyed cache could serve a stale kernel after the
    first weight's addresses are recycled)."""
    import jax.numpy as jnp

    from dotsocp.algorithms.driver import SolveOptions
    from dotsocp.multilevel.level import initialize
    from dotsocp.multilevel.solve import _solver_cache_key

    rho0, rho1, nt, weight, barrier, mask = problem
    nx = ny = rho0.shape[0]
    w_same = W.get_weight_by_barrier(nx, ny, nt, barrier)
    w_diff = W.get_weight_by_barrier(nx, ny, nt, None)
    o = SolveOptions(tol=1e-3, maxit=10, sigma=1.0, tau=1.9)

    def key(w):
        lv = initialize(rho0, rho1, nt, dtype=jnp.float32, weight=w)
        return _solver_cache_key("inPALM", lv, o, jnp.float32, "device",
                                 None, None, "flat")

    assert key(weight) == key(w_same)
    assert key(weight) != key(w_diff)


def test_weighted_multilevel_keeps_mass_out_of_barrier(problem):
    rho0, rho1, nt, weight, barrier, mask = problem
    out, _, _ = solve_dot(
        rho0, rho1, nt, 2, {"tol": 1e-3, "maxit": 4000},
        "inPALM", weight=weight, barrier=barrier, verbose=False,
    )
    rho = np.asarray(out["rho"])
    from scipy.ndimage import binary_erosion

    interior = binary_erosion(mask, iterations=2)
    if interior.any():
        assert np.abs(rho[:, interior]).max() < 0.1
