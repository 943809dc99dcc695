"""Per-phase roofline profiling must cover all six algorithms
(``record_time`` parity: the reference prints timing columns per
algorithm — Step_1_1_FFT / Step_1_1_sGS / Halpern etc.)."""
import jax.numpy as jnp
import numpy as np
import pytest

from dotsocp.models.examples import get_example_2d
from dotsocp.multilevel.solve import solve_dot

ALGS = ["inPALM", "ALG2", "PALM", "acc-ADMM", "sGS-inPALM", "acc-sGS-ADMM"]


@pytest.mark.parametrize("method", ALGS)
def test_profile_phases_all_algorithms(method):
    rho0, rho1 = get_example_2d("example2", 17, 17)
    out, _, _ = solve_dot(
        rho0, rho1, 5, 1,
        {"tol": 1e-2, "maxit": 30, "profile": True, "driver": "device"},
        method, dtype=jnp.float32, verbose=False,
    )
    rep = out["levels"][-1]
    assert "phases" in rep, rep.get("phases_error")
    phases = rep["phases"]
    sgs = "sGS" in method
    assert ("phi_sgs_sweep" if sgs else "phi_dct_solve") in phases
    for key in ("cone_projection", "q_step", "multiplier", "kkt_battery",
                "full_step_fused"):
        assert key in phases
    if method.startswith("acc"):
        assert "halpern_averaging" in phases
    for name, row in phases.items():
        assert np.isfinite(row["ms"]) and row["ms"] >= 0.0, (name, row)


def test_profile_weighted():
    from dotsocp.models import wdot2d as W

    n, nt = 17, 5
    rho0, rho1 = W.get_example_w2d("example1", n, n)
    barrier = W.barrier_circle_pillar()
    weight = W.get_weight_by_barrier(n, n, nt, barrier)
    rho0, rho1, _ = W.ensure_barrier_validity(rho0, rho1, barrier)
    out, _, _ = solve_dot(
        rho0, rho1, nt, 1,
        {"tol": 1e-2, "maxit": 30, "profile": True, "driver": "device"},
        "inPALM", weight=weight, barrier=barrier, dtype=jnp.float32,
        verbose=False,
    )
    phases = out["levels"][-1].get("phases")
    assert phases and "q_step" in phases and "phi_dct_solve" in phases
