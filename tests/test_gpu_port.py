"""What the GPU port put outside the kernels: the roofline table, the
compile-cache location, transfer precision, and chip_smoke.py's contract
(refusing to run without a GPU or outside a checkout)."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dotsocp.utils import cache, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Dev:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


@pytest.mark.parametrize("platform,kind,expected", [
    ("gpu", "NVIDIA H100 80GB HBM3", 3350.0),
    ("gpu", "Some Unknown GPU", ValueError),
    ("cpu", "cpu", None),
])
def test_roofline_lookup(platform, kind, expected):
    dev = _Dev(platform, kind)
    if expected is ValueError:
        with pytest.raises(ValueError, match="no peak bandwidth"):
            profiling.roofline_gbps(dev)
    else:
        assert profiling.roofline_gbps(dev) == expected


def test_profile_rows_on_cpu_have_no_roofline_share():
    from dotsocp.algorithms.core import LevelConfig
    from dotsocp.algorithms.variants import InPALMKernels
    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.level import initial_scaling, initialize

    rho0, rho1 = get_example_2d("example2", 9, 9)
    lv = initialize(rho0, rho1, 5, dtype=jnp.float32)
    initial_scaling(lv, scaling=True)
    k = InPALMKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E,
                                  dtype=jnp.float32, layout="flat"))
    rows = profiling.profile_phases(k, k.prep(lv.as_dict(), 1.0), iters=2)
    assert rows["q_step"]["gbps"] > 0
    assert all("pct_roofline" not in r for r in rows.values())


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compilation_cache() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in seen  # JAX reads the env
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = cache.enable_compilation_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert seen["jax_compilation_cache_dir"] == path
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_transfer_matmuls_ask_for_highest_precision():
    from dotsocp.multilevel.transfer import _apply_axis

    M = np.ones((3, 5), np.float32)
    jaxpr = jax.make_jaxpr(lambda x: _apply_axis(M, x, 1))(
        jnp.ones((4, 5, 6), jnp.float32))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        prec = e.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu_only_process():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert "dotsocp" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_last_line_has_contract_keys():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    line = chip_smoke.result_line(_Dev("gpu", "NVIDIA H100 80GB HBM3"), 1)
    assert line == {"ok": True, "device": {"platform": "gpu",
                                           "kind": "NVIDIA H100 80GB HBM3",
                                           "count": 1}}
