"""The fused Triton z-step kernel (interpret mode on CPU) against the
plain z-step it replaces, and the rule that selects it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dotsocp.algorithms import core
from dotsocp.algorithms.core import LevelConfig
from dotsocp.ops.cone import proj_soc
from dotsocp.ops.engine import make_ops
from dotsocp.ops.geometry import Geometry
from dotsocp.ops.staggered import Staggered
from dotsocp.ops.zstep_triton import make_zstep


@pytest.mark.parametrize("space,block", [
    ((9, 17), 64),     # 2D, blocks straddle rows and the last is partial
    ((33,), 16),       # 1D
    ((5, 7, 9), 128),  # 3D: three stride shifts, C = 14
])
def test_zstep_kernel_matches_plain(space, block):
    geom = Geometry(nt=5, space=space)
    ops = make_ops(geom, jnp.float32, "flat")
    rng = np.random.default_rng(0)
    q = ops.stag_to_internal(Staggered(
        q0=rng.standard_normal(geom.q0_shape).astype(np.float32),
        bs=tuple(rng.standard_normal(geom.b_shape(a)).astype(np.float32)
                 for a in range(geom.ndim_space))))
    beta = jnp.asarray(rng.standard_normal(
        geom.z_shape[:2] + (ops.S,)).astype(np.float32))
    ref = proj_soc(ops.bfd(q, 0.7, 0.3) - beta)
    fn = make_zstep(geom.nt, ops.S, ops.strides, block=block, interpret=True)
    got = jax.jit(fn)(q.q0, list(q.bs), beta, 0.7, 0.3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-6, atol=2e-6)


def test_step_with_zstep_kernel_matches_plain_step():
    """Kernels._step with the kernel in place tracks the plain step over
    several iterations (f32 rounding only)."""
    from dotsocp.algorithms.variants import InPALMKernels
    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.level import initial_scaling, initialize

    rho0, rho1 = get_example_2d("example2", 17, 17)
    lv = initialize(rho0, rho1, 7, dtype=jnp.float32)
    initial_scaling(lv, scaling=True)
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                      dtype=jnp.float32, layout="flat")
    k0, k1 = InPALMKernels(cfg), InPALMKernels(cfg)
    assert k0._zstep_kernel is None  # CPU: the plain z-step
    k1._zstep_kernel = make_zstep(lv.geom.nt, k1.ops.S, k1.ops.strides,
                           block=64, interpret=True)
    s0 = k0.prep(lv.as_dict(), sigma=1.0)
    s1 = k1.prep(lv.as_dict(), sigma=1.0)
    for _ in range(5):
        s0 = k0.run_one(s0)
        s1 = k1.run_one(s1)
    for a, b in zip(jax.tree.leaves(s0), jax.tree.leaves(s1)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=2e-5, atol=2e-6)


class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform,layout,dtype,expected", [
    ("gpu", "flat", jnp.float32, True),
    ("gpu", "3d", jnp.float32, False),
    ("gpu", "flat", jnp.float64, False),
    ("cpu", "flat", jnp.float32, False),
])
def test_zstep_kernel_selection(monkeypatch, platform, layout, dtype,
                                expected):
    monkeypatch.setattr(core.jax, "devices", lambda *a: [_Dev(platform)])
    cfg = LevelConfig(geom=Geometry(nt=5, space=(9, 9)), D=1.0, E=1.0,
                      dtype=dtype, layout=layout)
    assert core._zstep_kernel_applies(cfg) is expected


def test_zstep_kernel_batched_under_vmap():
    """The lockstep fleet (parallel/batch.py) vmaps the step, kernel
    included, over instances with per-instance scales."""
    geom = Geometry(nt=5, space=(9, 17))
    ops = make_ops(geom, jnp.float32, "flat")
    rng = np.random.default_rng(1)
    B = 3
    q0 = jnp.asarray(rng.standard_normal((B, 4, ops.S)), jnp.float32)
    bs = [jnp.asarray(rng.standard_normal((B, 5, ops.S)), jnp.float32)
          for _ in range(2)]
    beta = jnp.asarray(rng.standard_normal((B, 10, 4, ops.S)), jnp.float32)
    sbf = jnp.asarray([0.7, 0.5, 0.9], jnp.float32)
    fn = make_zstep(5, ops.S, ops.strides, block=64, interpret=True)
    got = jax.jit(jax.vmap(fn))(q0, bs, beta, sbf, 0.3 * jnp.ones(B))
    ref = jax.vmap(lambda a, b, c, s: proj_soc(
        ops.bfd(Staggered(q0=a, bs=tuple(b)), s, 0.3) - c))(q0, bs, beta, sbf)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-6, atol=2e-6)
