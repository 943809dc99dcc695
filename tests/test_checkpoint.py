"""Checkpoint/resume: an interrupted device-driver solve resumed from its
snapshot finishes with the same result as an uninterrupted run."""
import os

import numpy as np
import pytest

from dotsocp.models.examples import get_example_2d
from dotsocp.multilevel.solve import solve_dot


def test_resume_matches_uninterrupted_fast(tmp_path):
    """Fast-tier resume parity (VERDICT r4 item 6): a maxit-capped solve
    interrupted after one chunk and resumed from the snapshot lands on
    the same state as the uninterrupted run."""
    rho0, rho1 = get_example_2d("example2", 33, 33)
    base = {"tol": 1e-4, "maxit": 600, "driver": "device"}

    out_full, _, _ = solve_dot(
        rho0, rho1, 9, 1, dict(base), "inPALM", verbose=False
    )
    ck = str(tmp_path / "ck")
    opts1 = dict(base, checkpoint_dir=ck, chunk_iters=200, max_chunks=1)
    out_cut, _, _ = solve_dot(rho0, rho1, 9, 1, opts1, "inPALM",
                              verbose=False)
    assert out_cut["levels"][0]["iters"] < out_full["levels"][0]["iters"]
    assert os.path.exists(os.path.join(ck, "level1.npz"))
    opts2 = dict(base, checkpoint_dir=ck)
    out_res, _, _ = solve_dot(rho0, rho1, 9, 1, opts2, "inPALM",
                              verbose=False)
    assert out_res["levels"][0]["iters"] == out_full["levels"][0]["iters"]
    np.testing.assert_allclose(
        np.asarray(out_res["rho"]), np.asarray(out_full["rho"]),
        rtol=1e-8, atol=1e-10,
    )


@pytest.mark.slow
def test_resume_matches_uninterrupted(tmp_path):
    rho0, rho1 = get_example_2d("example2", 33, 33)
    base = {"tol": 1e-4, "maxit": 2000, "driver": "device"}

    out_full, _, h_full = solve_dot(
        rho0, rho1, 9, 1, dict(base), "inPALM", verbose=False
    )

    # interrupted run: stop after one 300-iteration chunk, leaving a snapshot
    ck = str(tmp_path / "ck")
    opts1 = dict(base, checkpoint_dir=ck, chunk_iters=300, max_chunks=1)
    out_cut, _, _ = solve_dot(rho0, rho1, 9, 1, opts1, "inPALM", verbose=False)
    assert out_cut["levels"][0]["iters"] < out_full["levels"][0]["iters"]
    assert os.path.exists(os.path.join(ck, "level1.npz"))

    # resumed run completes from the snapshot
    opts2 = dict(base, checkpoint_dir=ck)
    out_res, _, h_res = solve_dot(rho0, rho1, 9, 1, opts2, "inPALM", verbose=False)
    assert out_res["levels"][0]["iters"] == out_full["levels"][0]["iters"]
    np.testing.assert_allclose(
        np.asarray(out_res["rho"]), np.asarray(out_full["rho"]),
        rtol=1e-8, atol=1e-10,
    )


def test_pytree_roundtrip(tmp_path):
    import jax.numpy as jnp

    from dotsocp.utils.checkpoint import load_pytree, save_pytree

    tree = {"a": jnp.arange(5.0), "b": (jnp.ones((2, 3)), jnp.zeros(())) }
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree, {"k": 1})
    template = {"a": jnp.zeros(5), "b": (jnp.zeros((2, 3)), jnp.zeros(()))}
    back, meta = load_pytree(path, template)
    assert meta["k"] == 1
    np.testing.assert_array_equal(np.asarray(back["a"]), np.arange(5.0))

    bad_template = {"a": jnp.zeros(6), "b": (jnp.zeros((2, 3)), jnp.zeros(()))}
    with pytest.raises(ValueError):
        load_pytree(path, bad_template)
