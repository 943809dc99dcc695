"""The device-resident while_loop driver must reproduce the host driver's
decision trajectory exactly: same iteration counts, same check points, same
final residuals (they encode the same reference state machine)."""
import numpy as np
import pytest

from dotsocp.models.examples import get_example_2d
from dotsocp.multilevel.solve import solve_dot


@pytest.mark.parametrize("method", [
    "inPALM",
    "ALG2",
    "PALM",
    "acc-ADMM",
])
def test_device_matches_host(method):
    rho0, rho1 = get_example_2d("example2", 33, 33)
    outs = {}
    for drv in ("host", "device"):
        out, _, h = solve_dot(
            rho0, rho1, nt=9, level_n=1,
            opts={"tol": 1e-4, "maxit": 3000, "driver": drv},
            method=method, verbose=False,
        )
        outs[drv] = (out, h)
    (oh, hh), (od, hd) = outs["host"], outs["device"]
    assert oh["levels"][0]["iters"] == od["levels"][0]["iters"]
    np.testing.assert_array_equal(hh["iter"], hd["iter"])
    np.testing.assert_allclose(hh["kkt"], hd["kkt"], rtol=1e-5, atol=1e-12)
    # device sigma-table math runs in f32 (host: f64) -> harmless 1e-7-level
    # drift in the recovered field
    np.testing.assert_allclose(
        np.asarray(oh["rho"]), np.asarray(od["rho"]), rtol=1e-3, atol=1e-4
    )


def _sgs_parity(method, maxit):
    rho0, rho1 = get_example_2d("example2", 33, 33)
    outs = {}
    for drv in ("host", "device"):
        out, _, h = solve_dot(
            rho0, rho1, nt=9, level_n=1,
            opts={"tol": 1e-4, "maxit": maxit, "driver": drv},
            method=method, verbose=False,
        )
        outs[drv] = (out, h)
    (oh, hh), (od, hd) = outs["host"], outs["device"]
    assert oh["levels"][0]["iters"] == od["levels"][0]["iters"]
    # maxit-capped runs: the two drivers differ in whether one extra KKT
    # check is recorded AT it == maxit (off-cadence final check); the
    # trajectory itself must agree on the common prefix.
    n = min(len(hh["iter"]), len(hd["iter"]))
    assert abs(len(hh["iter"]) - len(hd["iter"])) <= 1
    for h_ in (hh, hd):
        if len(h_["iter"]) > n:
            assert int(h_["iter"][-1]) == maxit
    np.testing.assert_array_equal(hh["iter"][:n], hd["iter"][:n])
    np.testing.assert_allclose(hh["kkt"][:n], hd["kkt"][:n],
                               rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("method", ["sGS-inPALM", "acc-sGS-ADMM"])
def test_sgs_device_matches_host_fast(method):
    """Fast-tier slice of the sGS win-count parity (VERDICT r4 item 6):
    a maxit-capped run still crosses the win-count sigma machinery, the
    cadence scaling and several rescales — trajectory equality on the
    capped prefix is the same oracle at a fraction of the wall."""
    _sgs_parity(method, maxit=1200)


@pytest.mark.slow
def test_sgs_device_matches_host():
    """The on-device sGS win-count sigma machinery reproduces the host
    driver's trajectory exactly (full run to tol)."""
    _sgs_parity("sGS-inPALM", maxit=6000)


@pytest.mark.slow
def test_acc_sgs_device_matches_host():
    _sgs_parity("acc-sGS-ADMM", maxit=6000)


@pytest.mark.slow
def test_device_multilevel():
    rho0, rho1 = get_example_2d("example1", 33, 33)
    out, _, h = solve_dot(
        rho0, rho1, nt=9, level_n=3,
        opts={"tol": 1e-4, "maxit": 3000, "driver": "device"},
        method="inPALM", verbose=False,
    )
    k = h["kkt"][-1]
    assert max(k[0], k[2], k[5], k[6]) < 1e-4
    assert out["mass_ok"]
