"""Multi-process distributed execution (SURVEY.md section 2.5; the
BASELINE multi-host target needs a real ``jax.distributed`` code path, not
just a single-process virtual mesh).

Spawns TWO fresh CPU processes (4 virtual devices each) that join one
8-device global mesh via ``jax.distributed.initialize`` + gloo collectives
and run the same spatially-sharded multilevel solve through the device
driver. Both processes must produce identical trajectories, and the
trajectory must match a single-process (8-virtual-device) run of the same
problem — i.e. crossing the process boundary changes nothing.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LEVELS, MAXIT, TOL, ALGO = 1, 400, 1e-3, "inPALM"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_solve_matches_single_process():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    # spawned workers must not inherit the test session's forced-CPU
    # XLA_FLAGS device count; the worker sets its own (4 per process)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "dotsocp.parallel.distributed",
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(i),
             "--local-devices", "4", "--levels", str(LEVELS),
             "--maxit", str(MAXIT), "--tol", str(TOL),
             "--algorithm", ALGO],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=_REPO,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # exact PID of a process we spawned
    results = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        lines = [l for l in out.splitlines() if l.startswith("DIST_RESULT ")]
        assert lines, f"no DIST_RESULT line:\n{out[-3000:]}"
        rec = json.loads(lines[-1][len("DIST_RESULT "):])
        results[rec["process"]] = rec

    assert set(results) == {0, 1}
    r0, r1 = results[0], results[1]
    assert r0["global_devices"] == r1["global_devices"] == 8
    # both processes see the same global computation
    assert r0["iters"] == r1["iters"]
    np.testing.assert_array_equal(r0["kkt"], r1["kkt"])
    assert r0["mass_ok"] and r1["mass_ok"]

    # and the cross-process mesh run matches a single-process solve
    import jax.numpy as jnp

    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_2d("example2", 33, 33)
    out, hml, _ = solve_dot(
        rho0, rho1, 9, LEVELS,
        {"tol": TOL, "maxit": MAXIT, "driver": "device"},
        ALGO, dtype=jnp.float32, verbose=False,
    )
    assert [l["iters"] for l in out["levels"]] == r0["iters"]
    ref_kkt = np.asarray(hml["kkt"][-1][[0, 2, 5, 6]])
    np.testing.assert_allclose(r0["kkt"], ref_kkt, rtol=0.05, atol=1e-7)
