"""Distributed tests on the 8-virtual-device CPU mesh: the sharded solver
step must match the single-device step to tolerance (the standard way to
validate pjit layouts without a pod — SURVEY.md section 4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dotsocp.algorithms.core import LevelConfig
from dotsocp.algorithms.variants import InPALMKernels
from dotsocp.models.examples import get_example_2d
from dotsocp.multilevel.level import initial_scaling, initialize
from dotsocp.parallel.sharding import (
    constrain,
    factorize,
    make_mesh,
    make_sharded_step,
    state_shardings,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _setup(dtype=jnp.float64):
    rho0, rho1 = get_example_2d("example2", 17, 17)
    lv = initialize(rho0, rho1, 5, dtype=dtype)
    initial_scaling(lv, scaling=True)
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9, dtype=dtype)
    k = InPALMKernels(cfg)
    s = k.prep(lv.as_dict(), sigma=1.0)
    return k, s


def test_factorize():
    assert sorted(factorize(8, 3)) == [2, 2, 2]
    assert np.prod(factorize(6, 3)) == 6
    assert np.prod(factorize(1, 3)) == 1


@pytest.mark.slow
def test_sharded_step_matches_single_device():
    k, s = _setup()
    mesh = make_mesh(8)
    step = make_sharded_step(k, mesh, batched=True)

    batch = mesh.shape["batch"]
    bstate = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (batch,) + x.shape).copy(), s
    )
    # several sharded steps vs the same number of single-device steps
    ref = s
    out = bstate
    for _ in range(3):
        ref = k.run_one(ref)
        out = step(out)
    for name in ("phi", "z"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out, name))
        for i in range(batch):
            np.testing.assert_allclose(b[i], a, rtol=1e-10, atol=1e-12)
    a = np.asarray(ref.q.q0)
    b = np.asarray(out.q.q0)
    for i in range(batch):
        np.testing.assert_allclose(b[i], a, rtol=1e-10, atol=1e-12)


@pytest.mark.slow
def test_t_sharded_step_matches_single_device():
    """Time-axis (long-axis) sharding: mesh (t, y, x) — SURVEY.md section 5's
    "long-context" analogue. BF couples adjacent time slabs only, so the
    t halo is one slab; the DCT-in-t runs as a distributed matmul."""
    k, s = _setup()
    mesh = make_mesh(8, axis_names=("t", "y", "x"))
    step = make_sharded_step(k, mesh, batched=False)

    ref = s
    out = s
    for _ in range(3):
        ref = k.run_one(ref)
        out = step(out)
    np.testing.assert_allclose(
        np.asarray(out.phi), np.asarray(ref.phi), rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out.z), np.asarray(ref.z), rtol=1e-10, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out.q.q0), np.asarray(ref.q.q0), rtol=1e-10, atol=1e-12
    )


@pytest.mark.slow
def test_sharded_kkt_matches():
    k, s = _setup()
    mesh = make_mesh(8)
    sh = state_shardings(mesh, batched=True)
    batch = mesh.shape["batch"]
    s = k.run_one(s)
    bstate = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (batch,) + x.shape).copy(), s
    )

    @jax.jit
    def kkt_sharded(st):
        return jax.vmap(k._kkt)(constrain(st, sh))

    ref = jax.device_get(k.kkt(s))
    out = jax.device_get(kkt_sharded(bstate))
    np.testing.assert_allclose(out["kkt_org"][0], ref["kkt_org"], rtol=1e-9)
    np.testing.assert_allclose(out["pdGap"][0], ref["pdGap"], rtol=1e-9)


def test_sharded_multilevel_solve_matches_trajectory():
    """End-to-end spatially-sharded multilevel solve through the device
    driver (opts['mesh']): the trajectory — per-level iteration counts,
    final KKT, recovered density — must match the single-device run
    (sigma updates and rescales included; only collective-reduction
    rounding differs)."""
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_2d("example2", 33, 33)
    opts = {"tol": 1e-4, "driver": "device"}
    out1, hml1, _ = solve_dot(rho0, rho1, 9, 2, dict(opts), "inPALM",
                              dtype=jnp.float32, verbose=False)
    mesh = make_mesh(8, axis_names=("y", "x"))
    out2, hml2, _ = solve_dot(rho0, rho1, 9, 2, dict(opts, mesh=mesh),
                              "inPALM", dtype=jnp.float32, verbose=False)
    i1 = [l["iters"] for l in out1["levels"]]
    i2 = [l["iters"] for l in out2["levels"]]
    assert i1 == i2
    assert bool(out2["mass_ok"])
    np.testing.assert_allclose(
        hml1["kkt"][-1], hml2["kkt"][-1], rtol=0.05, atol=1e-7
    )
    # pointwise f32 density agreement: collective reduction order differs
    # per run, and a ~500-iteration f32 solve amplifies it locally; the
    # trajectory (iters, KKT) above is the strict check, the field check
    # is at the mass-conservation acceptance scale (1e-2)
    np.testing.assert_allclose(
        np.asarray(out1["rho"]), np.asarray(out2["rho"]), atol=1e-2
    )


@pytest.mark.slow
def test_dryrun_entrypoints():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    g.dryrun_multichip(8)
