"""Test configuration: CPU backend with 8 virtual devices + float64.

Multi-chip sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count), the standard way to test pjit
layouts without a pod. x64 is enabled so operator identities can be checked
to near machine precision; solver tests exercise f32 paths explicitly.
"""
import os

# Tests run on the CPU (8 virtual devices), whatever accelerator the machine
# has; the GPU run is ``python chip_smoke.py``. Set both the env var and
# jax.config (below), before any backend initializes.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (full pyramid; default selection is "
        "the <5 min fast set — use for behavior-touching changes)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight multilevel/halo/distributed tests, deselected "
        "by default; enable with --runslow or DOTSOCP_RUN_SLOW=1",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU. Such a test decides inside a fixture, "
        "never at import, and skips here with a reason; the card itself is "
        "checked by python chip_smoke.py (none exist today: the Triton "
        "kernel runs in interpret mode on the CPU)",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("DOTSOCP_RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow; use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
