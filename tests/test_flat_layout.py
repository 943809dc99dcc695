"""Flat-layout engine parity (ops/engine.py): the lane-packed layout must
reproduce the shaped ops to machine precision — same arithmetic, same
order, ghost slots exactly zero (see OpsFlat docstring)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dotsocp.algorithms.core import LevelConfig
from dotsocp.algorithms.variants import (
    AccADMMKernels,
    InPALMKernels,
    PALMKernels,
)
from dotsocp.multilevel.level import initialize, initial_scaling
from dotsocp.models.wdot2d import get_weight_by_barrier
from dotsocp.ops.engine import OpsFlat, Ops3D
from dotsocp.ops.geometry import Geometry
from dotsocp.ops.staggered import Staggered


def _rand_problem(shape, seed=0):
    rng = np.random.RandomState(seed)
    rho0 = rng.rand(*shape) + 0.5
    rho1 = rng.rand(*shape) + 0.5
    return rho0 / rho0.mean(), rho1 / rho1.mean()


def _rand_stag(geom, rng, dtype=jnp.float64):
    return Staggered(
        q0=jnp.asarray(rng.randn(*geom.q0_shape), dtype),
        bs=tuple(
            jnp.asarray(rng.randn(*geom.b_shape(a)), dtype)
            for a in range(geom.ndim_space)
        ),
    )


@pytest.mark.parametrize("space", [(9,), (9, 11), (5, 7, 9)])
def test_flat_ops_match_shaped(space):
    geom = Geometry(nt=7, space=space)
    rng = np.random.RandomState(3)
    o3 = Ops3D(geom, jnp.float64)
    of = OpsFlat(geom, jnp.float64)

    phi = jnp.asarray(rng.randn(*geom.phi_shape))
    st = _rand_stag(geom, rng)
    z = jnp.asarray(rng.randn(*geom.z_shape))

    # grad
    g3 = o3.grad(phi)
    gf = of.stag_from_internal(of.grad(of.phi_to_internal(phi)))
    for a, b in zip(jax.tree.leaves(g3), jax.tree.leaves(gf)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # ghost slots of the flat grad are exactly zero
    gfi = of.grad(of.phi_to_internal(phi))
    for a in range(geom.ndim_space):
        ghost = np.asarray(gfi.bs[a]) * (1.0 - np.asarray(of.masks[a]))
        assert np.all(ghost == 0.0)

    # grad_T
    t3 = o3.grad_T(st)
    tf = of.phi_from_internal(of.grad_T(of.stag_to_internal(st)))
    np.testing.assert_allclose(np.asarray(t3), np.asarray(tf), rtol=0, atol=0)

    # bfd / bfd_T
    b3 = o3.bfd(st, 0.7, 1.3)
    bf = of.z_from_internal(of.bfd(of.stag_to_internal(st), 0.7, 1.3))
    np.testing.assert_array_equal(np.asarray(b3), np.asarray(bf))

    a3 = o3.bfd_T(z, 0.7)
    af = of.stag_from_internal(of.bfd_T(of.z_to_internal(z), 0.7))
    for a, b in zip(jax.tree.leaves(a3), jax.tree.leaves(af)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # adjointness on the flat layout itself
    q2 = of.bfd_T(of.z_to_internal(z), 0.7)
    lhs = jnp.vdot(of.bfd(of.stag_to_internal(st), 0.7, 0.0), of.z_to_internal(z))
    rhs = st.dot(of.stag_from_internal(q2))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)

    # diag matches on real slots
    d3 = o3.oper_q_diag(0.5, 0.3, None)
    df = of.oper_q_diag(0.5, 0.3, None)
    np.testing.assert_array_equal(
        np.asarray(d3.q0).reshape(geom.nt - 1, -1), np.asarray(df.q0)
    )

    # poisson solve
    p3 = o3.make_poisson(0.5)
    pf = of.make_poisson(0.5)
    rhs_arr = jnp.asarray(rng.randn(*geom.phi_shape))
    s3 = p3.solve(rhs_arr)
    sf = pf.solve(of.phi_to_internal(rhs_arr))
    np.testing.assert_allclose(
        np.asarray(s3), np.asarray(of.phi_from_internal(sf)), atol=1e-12
    )


@pytest.mark.slow
@pytest.mark.parametrize("kcls", [InPALMKernels, PALMKernels, AccADMMKernels])
def test_flat_kernels_trajectory_matches_3d(kcls):
    rho0, rho1 = _rand_problem((17, 17))

    def run(layout):
        lv = initialize(rho0, rho1, 9, dtype=jnp.float64)
        initial_scaling(lv, scaling=True)
        cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                          dtype=jnp.float64, layout=layout)
        k = kcls(cfg)
        s = k.prep(lv.as_dict(), sigma=1.0)
        for _ in range(15):
            s = k.run_one(s) if hasattr(k, "run_one") else None
            if s is None:
                break
        if not hasattr(k, "run_one"):
            s = k.run_segment(k.prep(lv.as_dict(), sigma=1.0), 15)
        res = jax.device_get(k.kkt(s))
        var = k.finalize(s, lv.as_dict())
        return res, var

    r3, v3 = run("3d")
    rf, vf = run("flat")
    np.testing.assert_allclose(r3["kkt_org"], rf["kkt_org"], rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(v3["phi"]), np.asarray(vf["phi"]), atol=1e-12
    )
    for a, b in zip(jax.tree.leaves(v3["q"]), jax.tree.leaves(vf["q"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_flat_weighted_matches_3d():
    rho0, rho1 = _rand_problem((17, 17), seed=5)
    weight = get_weight_by_barrier(
        17, 17, 9, lambda x, y: (np.abs(x - 0.5) < 0.1) & (y < 0.6)
    )

    def run(layout):
        lv = initialize(rho0, rho1, 9, dtype=jnp.float64,
                        weight=weight.astype(jnp.float64))
        initial_scaling(lv, scaling=True)
        cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                          weighted=True, check_prim_dual_feas=False,
                          dtype=jnp.float64, layout=layout)
        k = InPALMKernels(cfg, lv.weight)
        s = k.run_segment(k.prep(lv.as_dict(), sigma=1.0), 12)
        return jax.device_get(k.kkt(s))

    r3 = run("3d")
    rf = run("flat")
    np.testing.assert_allclose(r3["kkt_org"], rf["kkt_org"], rtol=1e-10,
                               atol=1e-14)


@pytest.mark.slow
def test_solve_dot_flat_default_converges():
    """solve_dot's default layout (flat) reaches the same iteration count
    as the shaped layout on a small 2-level problem."""
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = _rand_problem((17, 17), seed=7)
    outs = {}
    for layout in ("3d", "flat"):
        out, _, h = solve_dot(
            rho0, rho1, 9, 2,
            {"tol": 1e-4, "maxit": 600, "layout": layout,
             "reuse_solvers": False},
            "inPALM", dtype=jnp.float64, verbose=False,
        )
        outs[layout] = (tuple(l["iters"] for l in out["levels"]),
                        np.asarray(out["rho"]))
    assert outs["3d"][0] == outs["flat"][0]
    np.testing.assert_allclose(outs["3d"][1], outs["flat"][1], atol=1e-8)
