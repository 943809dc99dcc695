"""Mixed-precision refinement (opts['refine_tol']): f32 multilevel warm
start + float64 tail on the finest level — the supported route to
reference-grade tolerances (1e-5/1e-6), below the f32 KKT floor
(~1e-4)."""
import numpy as np
import jax.numpy as jnp

from dotsocp.multilevel.level import check_mass_conservation
from dotsocp.multilevel.solve import solve_dot


def _problem(n, seed=0):
    rng = np.random.RandomState(seed)
    rho0 = rng.rand(n, n) + 0.5
    rho1 = rng.rand(n, n) + 0.5
    return rho0 / rho0.mean(), rho1 / rho1.mean()


def test_refine_reaches_tight_tol_with_mass():
    rho0, rho1 = _problem(17)
    out, hml, h = solve_dot(
        rho0, rho1, 5, 1,
        {"tol": 1e-4, "maxit": 3000, "refine_tol": 1e-6,
         "reuse_solvers": False},
        "inPALM", dtype=jnp.float32, verbose=False,
    )
    k = h["kkt"][-1]
    assert max(k[i] for i in (0, 2, 5, 6)) < 1e-6
    assert out["rho"].dtype == jnp.float64
    assert out["mass_ok"]
    assert check_mass_conservation(np.asarray(out["rho"]), tol=1e-4)
    assert out["levels"][-1].get("refine") is True


def test_refine_matches_pure_f64_solution():
    rho0, rho1 = _problem(17, seed=3)
    opts = {"tol": 1e-4, "maxit": 4000, "reuse_solvers": False}
    out_r, _, h_r = solve_dot(
        rho0, rho1, 5, 1, {**opts, "refine_tol": 1e-6},
        "inPALM", dtype=jnp.float32, verbose=False,
    )
    out_d, _, h_d = solve_dot(
        rho0, rho1, 5, 1, {**opts, "tol": 1e-6},
        "inPALM", dtype=jnp.float64, verbose=False,
    )
    # both at KKT 1e-6: the recovered densities agree to solver accuracy
    np.testing.assert_allclose(
        np.asarray(out_r["rho"]), np.asarray(out_d["rho"]), atol=5e-4
    )


def test_refine_method_override():
    """opts['refine_method'] runs the f64 tail under a different algorithm
    (measured in scripts/refine_tail_experiment.py — the option exists for
    experimentation; the default stays the sweep's own method)."""
    rho0, rho1 = _problem(17, seed=1)
    out, hml, h = solve_dot(
        rho0, rho1, 5, 1,
        {"tol": 1e-4, "maxit": 4000, "refine_tol": 1e-6,
         "refine_method": "acc-ADMM", "reuse_solvers": False},
        "inPALM", dtype=jnp.float32, verbose=False,
    )
    k = h["kkt"][-1]
    assert max(k[i] for i in (0, 2, 5, 6)) < 1e-6
    assert out["mass_ok"]
    assert "ADMM" in h["method"]  # solver display name: "Accelerated ADMM ..."


def test_refine_method_invalid():
    import pytest

    rho0, rho1 = _problem(17)
    with pytest.raises(ValueError, match="refine_method"):
        solve_dot(
            rho0, rho1, 5, 1,
            {"tol": 1e-3, "maxit": 200, "refine_tol": 1e-4,
             "refine_method": "nonsense", "reuse_solvers": False},
            "inPALM", dtype=jnp.float32, verbose=False,
        )


def test_refine_split_dct_two_phase():
    """refine_dct_split=True runs the tail on split-f32 DCT matmuls down
    to the path's ~4e-6 KKT floor, then true-f64 DCT to the target
    (two phases below the floor). 'auto' never selects it, so this test
    forces the flag."""
    rho0, rho1 = _problem(17, seed=2)
    out, hml, h = solve_dot(
        rho0, rho1, 5, 1,
        {"tol": 1e-4, "maxit": 6000, "refine_tol": 1e-6,
         "refine_dct_split": True, "reuse_solvers": False},
        "inPALM", dtype=jnp.float32, verbose=False,
    )
    k = h["kkt"][-1]
    assert max(k[i] for i in (0, 2, 5, 6)) < 1e-6
    assert out["mass_ok"]
    assert "split-DCT" in hml["method"] or "refine" in hml["method"]
    # the combined report counts both phases
    assert out["levels"][-1].get("refine") is True


def test_refine_ir_dct_single_phase():
    """refine_dct_split='ir' (what 'auto' selects below 1e-6): the
    whole f64 tail runs as ONE phase on f32 DCTs + f64-residual iterative
    refinement (ops/poisson.py:_solve_ir) — split-level per-iteration cost
    with no accuracy floor, so targets below the split path's ~2e-8*n
    floor need no true-f64 phase."""
    rho0, rho1 = _problem(17, seed=4)
    out, hml, h = solve_dot(
        rho0, rho1, 5, 1,
        {"tol": 1e-4, "maxit": 6000, "refine_tol": 1e-6,
         "refine_dct_split": "ir", "reuse_solvers": False},
        "inPALM", dtype=jnp.float32, verbose=False,
    )
    k = h["kkt"][-1]
    assert max(k[i] for i in (0, 2, 5, 6)) < 1e-6
    assert out["mass_ok"]
    assert "IR-DCT" in h["method"]
    assert out["levels"][-1].get("refine") is True
    assert check_mass_conservation(np.asarray(out["rho"]), tol=1e-4)


def test_refine_under_mesh_uses_plain_f64():
    """Under a mesh the halo engine supports only the plain f64 DCT
    ('auto' must NOT pick IR/split — their strategies are bypassed by the
    pad-extended halo transform, which would silently hand the tail
    f32-grade phi). The tail still converges, on the plain path."""
    import jax

    from dotsocp.parallel.sharding import make_mesh

    if len(jax.devices()) < 4:
        import pytest

        pytest.skip("needs >= 4 devices")
    rho0, rho1 = _problem(17, seed=5)
    mesh = make_mesh(4, axis_names=("y", "x"))
    out, hml, h = solve_dot(
        rho0, rho1, 5, 1,
        {"tol": 1e-3, "maxit": 6000, "refine_tol": 1e-5, "mesh": mesh,
         "reuse_solvers": False},
        "inPALM", dtype=jnp.float32, verbose=False,
    )
    k = h["kkt"][-1]
    assert max(k[i] for i in (0, 2, 5, 6)) < 1e-5
    assert "IR-DCT" not in h["method"] and "split" not in h["method"]
    assert out["mass_ok"]


def test_refine_ir_rejected_under_mesh():
    import pytest

    from dotsocp.parallel.sharding import make_mesh

    rho0, rho1 = _problem(17, seed=6)
    mesh = make_mesh(4, axis_names=("y", "x"))
    with pytest.raises(ValueError, match="halo layout"):
        solve_dot(
            rho0, rho1, 5, 1,
            {"tol": 1e-3, "maxit": 100, "refine_tol": 1e-5, "mesh": mesh,
             "refine_dct_split": "ir", "reuse_solvers": False},
            "inPALM", dtype=jnp.float32, verbose=False,
        )
