"""Multi-process (multi-host) execution: ``jax.distributed`` wiring.

The reference is strictly single-process; SURVEY.md section 2.5 and the
BASELINE multi-host target (>= 70% scaling efficiency at 2+ hosts) require
a real multi-process code path: every process calls
:func:`initialize_distributed`, after which ``jax.devices()`` is the GLOBAL
device list and a :class:`~jax.sharding.Mesh` built over it spans hosts.
The solver needs no further changes — the device-resident drivers make
only deterministic, replicated control decisions (chunked while_loops,
scalar KKT fetches), so every process takes identical branches, and the
halo engine's ppermute / the KKT psum reductions ride the cross-process
collective backend (NCCL on GPUs, gloo on CPU).

Usage (one command per host/process):

    python demos/demo_dot2d.py --coordinator host0:1234 \
        --num-processes 2 --process-id $I --mesh

Validated by ``tests/test_distributed.py``: two spawned CPU processes
(4 virtual devices each -> one 8-device global mesh) run the same sharded
multilevel solve and must produce identical trajectories.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
    platform: Optional[str] = None,
) -> dict:
    """Join (or form) a multi-process JAX runtime.

    Must run before any jax operation. Arguments default to the
    ``DOTSOCP_COORDINATOR`` / ``DOTSOCP_NUM_PROCESSES`` /
    ``DOTSOCP_PROCESS_ID`` env vars (and through
    ``jax.distributed.initialize``'s own auto-detection for managed
    clusters). ``local_device_count`` forces N virtual CPU devices per
    process (testing without hardware); ``platform='cpu'`` selects the
    gloo collective backend so cross-process psum/ppermute work on CPU.

    Returns a summary dict (process_id, process_count, local/global
    device counts).
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "DOTSOCP_COORDINATOR"
    )
    if num_processes is None and "DOTSOCP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DOTSOCP_NUM_PROCESSES"])
    if process_id is None and "DOTSOCP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DOTSOCP_PROCESS_ID"])

    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={local_device_count}"
            ).strip()
    if platform:
        jax.config.update("jax_platforms", platform)
    if platform == "cpu":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return {
        "process_id": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_coordinator() -> bool:
    """True on the process that should own side effects (logging, plot and
    checkpoint writes). Call only after jax is initialized."""
    import jax

    return jax.process_index() == 0


# ---------------------------------------------------------------------------
# self-test worker (spawned by tests/test_distributed.py and
# __graft_entry__.dryrun_multiprocess): joins a 2-process CPU cluster and
# runs a sharded multilevel solve, printing one parseable RESULT line.
# ---------------------------------------------------------------------------

def _selftest_worker(coordinator: str, num_processes: int, process_id: int,
                     local_devices: int, levels: int, maxit: int,
                     tol: float, algorithm: str) -> None:
    info = initialize_distributed(
        coordinator, num_processes, process_id,
        local_device_count=local_devices, platform="cpu",
    )
    import json

    import jax.numpy as jnp
    import numpy as np

    from ..models.examples import get_example_2d
    from ..multilevel.solve import solve_dot
    from .sharding import make_mesh

    rho0, rho1 = get_example_2d("example2", 33, 33)
    mesh = make_mesh(axis_names=("y", "x"))
    out, hml, _ = solve_dot(
        rho0, rho1, 9, levels,
        {"tol": tol, "maxit": maxit, "driver": "device", "mesh": mesh},
        algorithm, dtype=jnp.float32, verbose=False,
    )
    rec = {
        "process": info["process_id"],
        "global_devices": info["global_devices"],
        "mesh": dict(mesh.shape),
        "iters": [l["iters"] for l in out["levels"]],
        "kkt": np.asarray(hml["kkt"][-1][[0, 2, 5, 6]]).tolist(),
        "mass_ok": bool(out["mass_ok"]),
    }
    print("DIST_RESULT " + json.dumps(rec), flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--local-devices", type=int, default=4)
    p.add_argument("--levels", type=int, default=1)
    p.add_argument("--maxit", type=int, default=200)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--algorithm", default="inPALM")
    a = p.parse_args(argv)
    _selftest_worker(a.coordinator, a.num_processes, a.process_id,
                     a.local_devices, a.levels, a.maxit, a.tol, a.algorithm)


if __name__ == "__main__":
    main()
