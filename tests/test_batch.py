"""Batched-instance driver: all instances converge, and each matches a
single-instance solve of the same problem."""
import pytest
import jax.numpy as jnp
import numpy as np

from dotsocp.models.examples import get_example_2d
from dotsocp.multilevel.solve import solve_dot
from dotsocp.parallel.batch import solve_batch


@pytest.mark.slow
def test_batch_converges_and_matches_single():
    a, b = get_example_2d("example2", 33, 33)
    c, d = get_example_2d("example1", 33, 33)
    r0 = np.stack([a, c])
    r1 = np.stack([b, d])
    out = solve_batch(
        r0, r1, nt=9, opts={"tol": 1e-4, "maxit": 3000},
        dtype=jnp.float64, verbose=False,
    )
    assert out["done"].all()
    assert (out["kkt"][:, [0, 2, 5, 6]].max(axis=1) < 1e-4).all()

    # instance 0 vs a standalone device solve of the same problem
    single, _, _ = solve_dot(
        a, b, 9, 1, {"tol": 1e-4, "maxit": 3000, "driver": "device"},
        "inPALM", dtype=jnp.float64, verbose=False,
    )
    rho_b = np.asarray(out["rho"][0])
    rho_s = np.asarray(single["rho"])
    rel = np.linalg.norm(rho_b - rho_s) / np.linalg.norm(rho_s)
    # batched mode aligns rescales to the check cadence (documented
    # deviation) -> same solution within solver tolerance
    assert rel < 1e-2, rel


@pytest.mark.slow
def test_batch_multilevel():
    a, b = get_example_2d("example2", 33, 33)
    c, d = get_example_2d("example1", 33, 33)
    out = solve_batch(
        np.stack([a, c]), np.stack([b, d]), nt=9, level_n=3,
        opts={"tol": 1e-4, "maxit": 3000}, dtype=jnp.float64, verbose=False,
    )
    assert out["done"].all()
    assert (out["kkt"][:, [0, 2, 5, 6]].max(axis=1) < 1e-4).all()


def test_pick_fleet_mode_decision_table():
    from dotsocp.parallel.batch import pick_fleet_mode

    # 2+ devices -> shard the batch axis
    assert pick_fleet_mode(8, (129, 129), 33, 8) == "sharded"
    # one device, saturating instance (the 129^2x33 headline) -> sequential
    assert pick_fleet_mode(8, (129, 129), 33, 1) == "sequential"
    # one device, small instances -> lockstep
    assert pick_fleet_mode(8, (33, 33), 9, 1) == "lockstep"
    # a single problem never shards the batch axis
    assert pick_fleet_mode(1, (129, 129), 33, 8) == "sequential"


@pytest.mark.slow
def test_solve_fleet_modes_agree():
    """sequential and lockstep fleet modes must both converge the same
    fleet; auto must select a valid mode and return the mode it ran."""
    from dotsocp.parallel.batch import solve_fleet

    rho0, rho1 = get_example_2d("example2", 17, 17)
    B = 3
    r0 = np.stack([np.roll(np.asarray(rho0), s, axis=1) for s in range(B)])
    r1 = np.stack([np.asarray(rho1)] * B)
    opts = {"tol": 1e-3, "maxit": 1500}
    outs = {}
    for mode in ("sequential", "lockstep", "auto"):
        out = solve_fleet(r0, r1, 9, opts, "inPALM", dtype=jnp.float32,
                          mode=mode, verbose=False)
        assert out["done"].all(), (mode, out["kkt"])
        outs[mode] = out
    assert outs["auto"]["mode"] in ("sequential", "lockstep", "sharded")
    # both modes solve the same problems to the same tolerance (lockstep
    # aligns rescales to the check cadence — a documented deviation, so
    # the solutions agree to solver tolerance, not bitwise)
    np.testing.assert_allclose(
        np.asarray(outs["sequential"]["rho"]),
        np.asarray(outs["lockstep"]["rho"]), atol=1e-1,
    )


def test_batch_spatial_combined_multilevel():
    """Combined dp x spatial decomposition (VERDICT r4 item 8): the same
    multilevel fleet under a (batch, y, x) mesh — batch axis sharded at
    the jit boundary, spatial axes constrained in-jit (the BASELINE.json
    scale config: "sharded over a pod slice + batched independent
    instances") — must track the unsharded lockstep trajectory."""
    from dotsocp.parallel.sharding import make_mesh

    a, b = get_example_2d("example2", 33, 33)
    c, d = get_example_2d("example1", 33, 33)
    r0 = np.stack([a, c])
    r1 = np.stack([b, d])
    opts = {"tol": 1e-3, "maxit": 800}
    ref = solve_batch(r0, r1, nt=9, opts=dict(opts), level_n=2,
                      dtype=jnp.float32, verbose=False)
    mesh = make_mesh(8, axis_names=("batch", "y", "x"))
    assert mesh.shape["y"] * mesh.shape["x"] > 1  # real spatial split
    got = solve_batch(r0, r1, nt=9, opts=dict(opts), level_n=2,
                      mesh=mesh, dtype=jnp.float32, verbose=False)
    assert got["done"].all()
    assert got["iters"] == ref["iters"]
    np.testing.assert_array_equal(np.asarray(got["done_it"]),
                                  np.asarray(ref["done_it"]))
    np.testing.assert_allclose(np.asarray(got["kkt"]),
                               np.asarray(ref["kkt"]), rtol=2e-2, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got["rho"]),
                               np.asarray(ref["rho"]), rtol=0, atol=5e-4)


def test_batch_spatial_requires_shaped_layout():
    from dotsocp.parallel.sharding import make_mesh

    a, b = get_example_2d("example2", 17, 17)
    r0 = np.stack([a, a])
    r1 = np.stack([b, b])
    mesh = make_mesh(8, axis_names=("batch", "y", "x"))
    with pytest.raises(ValueError, match="layout"):
        solve_batch(r0, r1, nt=5,
                    opts={"tol": 1e-2, "maxit": 50, "layout": "flat"},
                    mesh=mesh, dtype=jnp.float32, verbose=False)


def test_batch_only_mesh_with_size1_spatial_axes_keeps_flat():
    """A mesh whose y/x axes are size 1 is batch-only: the layout stays
    'flat' (fused path) instead of flipping to '3d' on axis NAMES alone —
    and an explicit flat layout is accepted."""
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices()[:2]).reshape(2, 1, 1)
    mesh = Mesh(devs, axis_names=("batch", "y", "x"))
    a, b = get_example_2d("example2", 17, 17)
    r0 = np.stack([a, a])
    r1 = np.stack([b, b])
    out = solve_batch(r0, r1, nt=5,
                      opts={"tol": 1e-2, "maxit": 200, "layout": "flat"},
                      mesh=mesh, dtype=jnp.float32, verbose=False)
    assert out["done"].all()
