"""Halo-exchange layout engine (ops/halo_engine.py): the padded shard_map
stencils must match the shaped Ops3D operators exactly, and an end-to-end
sharded solve through it must reproduce the single-device trajectory."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dotsocp.ops.engine import Ops3D, make_ops
from dotsocp.ops.geometry import Geometry
from dotsocp.ops.staggered import Staggered
from dotsocp.parallel.sharding import make_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def setup2d():
    geom = Geometry(nt=5, space=(17, 17))
    mesh = make_mesh(8, axis_names=("y", "x"))
    o3 = Ops3D(geom, jnp.float64)
    oh = make_ops(geom, jnp.float64, "halo", mesh)
    rng = np.random.RandomState(0)
    phi = jnp.asarray(rng.randn(5, 17, 17))
    st = Staggered(
        q0=jnp.asarray(rng.randn(4, 17, 17)),
        bs=(jnp.asarray(rng.randn(5, 16, 17)),
            jnp.asarray(rng.randn(5, 17, 16))),
    )
    z = jnp.asarray(rng.randn(10, 4, 17, 17))
    return geom, o3, oh, phi, st, z


def test_halo_grad(setup2d):
    _, o3, oh, phi, _, _ = setup2d
    g3 = o3.grad(phi)
    gh = oh.stag_from_internal(oh.grad(oh.phi_to_internal(phi)))
    np.testing.assert_array_equal(np.asarray(g3.q0), np.asarray(gh.q0))
    for a, b in zip(g3.bs, gh.bs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_halo_grad_T(setup2d):
    _, o3, oh, _, st, _ = setup2d
    t3 = o3.grad_T(st)
    th = oh.phi_from_internal(oh.grad_T(oh.stag_to_internal(st)))
    np.testing.assert_array_equal(np.asarray(t3), np.asarray(th))


def test_halo_bfd(setup2d):
    _, o3, oh, _, st, _ = setup2d
    b3 = o3.bfd(st, 1.3, 0.7)
    bh = oh.z_from_internal(oh.bfd(oh.stag_to_internal(st), 1.3, 0.7))
    np.testing.assert_array_equal(np.asarray(b3), np.asarray(bh))


def test_halo_bfd_pads_stay_zero(setup2d):
    """The +scale_d constant must not leak into pad cells (z/beta pads rely
    on proj_soc(0) = 0 staying zero through the whole iteration)."""
    geom, _, oh, _, st, _ = setup2d
    zi = oh.bfd(oh.stag_to_internal(st), 1.3, 0.7)
    pads = np.asarray(zi)[:, :, geom.space[0]:, :]
    np.testing.assert_array_equal(pads, 0.0)
    pads = np.asarray(zi)[:, :, :, geom.space[1]:]
    np.testing.assert_array_equal(pads, 0.0)


def test_halo_bfd_T(setup2d):
    _, o3, oh, _, _, z = setup2d
    c3 = o3.bfd_T(z, 0.9)
    ch = oh.stag_from_internal(oh.bfd_T(oh.z_to_internal(z), 0.9))
    np.testing.assert_array_equal(np.asarray(c3.q0), np.asarray(ch.q0))
    for a, b in zip(c3.bs, ch.bs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_halo_poisson(setup2d):
    _, o3, oh, phi, _, _ = setup2d
    p3 = o3.make_poisson(1.0)
    ph = oh.make_poisson(1.0)
    s3 = p3.solve(phi, scale=0.5)
    sh = oh.phi_from_internal(ph.solve(oh.phi_to_internal(phi), scale=0.5))
    np.testing.assert_allclose(np.asarray(s3), np.asarray(sh),
                               rtol=1e-13, atol=1e-14)


def test_halo_1d_ops():
    geom = Geometry(nt=5, space=(33,))
    mesh = make_mesh(8, axis_names=("x",))
    o3 = Ops3D(geom, jnp.float64)
    oh = make_ops(geom, jnp.float64, "halo", mesh)
    rng = np.random.RandomState(1)
    st = Staggered(q0=jnp.asarray(rng.randn(4, 33)),
                   bs=(jnp.asarray(rng.randn(5, 32)),))
    z = jnp.asarray(rng.randn(6, 4, 33))
    b3 = o3.bfd(st, 1.1, 0.3)
    bh = oh.z_from_internal(oh.bfd(oh.stag_to_internal(st), 1.1, 0.3))
    np.testing.assert_array_equal(np.asarray(b3), np.asarray(bh))
    c3 = o3.bfd_T(z, 0.8)
    ch = oh.stag_from_internal(oh.bfd_T(oh.z_to_internal(z), 0.8))
    np.testing.assert_array_equal(np.asarray(c3.q0), np.asarray(ch.q0))
    np.testing.assert_array_equal(np.asarray(c3.bs[0]), np.asarray(ch.bs[0]))


def test_halo_sgs_sweep_matches_jnp(setup2d):
    """HaloSGS (one shard_map, ppermute halo pulls per half-sweep) must
    reproduce the single-device red-black sweep exactly."""
    from dotsocp.ops.halo_engine import HaloSGS
    from dotsocp.ops.sgs import make_sgs

    geom, _, oh, phi, _, _ = setup2d
    ref = make_sgs(geom, D=1.0, dtype=jnp.float64)
    hal = HaloSGS(oh, D=1.0)
    rng = np.random.RandomState(3)
    rhs = jnp.asarray(rng.randn(*geom.phi_shape))
    d2 = jnp.asarray(0.64)
    a = ref.sweep(phi, rhs, its=2, d2=d2)
    b = oh.phi_from_internal(
        hal.sweep(oh.phi_to_internal(phi), oh.phi_to_internal(rhs), its=2,
                  d2=d2)
    )
    np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                               rtol=1e-12, atol=1e-13)
    # pads must stay exactly zero through the sweep
    pi = hal.sweep(oh.phi_to_internal(phi), oh.phi_to_internal(rhs), d2=d2)
    np.testing.assert_array_equal(np.asarray(pi)[:, geom.space[0]:, :], 0.0)
    # block residual norm parity
    ra = ref.residual_color_a_norm(a, rhs, 0.1, d2=d2)
    rb = hal.residual_color_a_norm(
        oh.phi_to_internal(a), oh.phi_to_internal(rhs), 0.1, d2=d2)
    np.testing.assert_allclose(float(rb), float(ra), rtol=1e-10)


@pytest.fixture(scope="module")
def setup_t():
    """(t, y, x) mesh: the time axis joins the halo padding discipline."""
    geom = Geometry(nt=9, space=(9, 17))
    mesh = make_mesh(8, axis_names=("t", "y", "x"))
    assert mesh.shape["t"] == 2
    o3 = Ops3D(geom, jnp.float64)
    oh = make_ops(geom, jnp.float64, "halo", mesh)
    rng = np.random.RandomState(7)
    phi = jnp.asarray(rng.randn(*geom.phi_shape))
    st = Staggered(
        q0=jnp.asarray(rng.randn(*geom.q0_shape)),
        bs=(jnp.asarray(rng.randn(*geom.b_shape(0))),
            jnp.asarray(rng.randn(*geom.b_shape(1)))),
    )
    z = jnp.asarray(rng.randn(*geom.z_shape))
    return geom, o3, oh, phi, st, z


def test_halo_t_ops_match(setup_t):
    """grad / grad_T / bfd / bfd_T / poisson / t_node_interp with a sharded
    time axis must equal the shaped single-device operators."""
    geom, o3, oh, phi, st, z = setup_t
    assert oh.sharded_t and oh.Pt % 2 == 0
    g3, gh = o3.grad(phi), oh.grad(oh.phi_to_internal(phi))
    gh = oh.stag_from_internal(gh)
    np.testing.assert_array_equal(np.asarray(g3.q0), np.asarray(gh.q0))
    for a, b in zip(g3.bs, gh.bs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    t3 = o3.grad_T(st)
    th = oh.phi_from_internal(oh.grad_T(oh.stag_to_internal(st)))
    np.testing.assert_array_equal(np.asarray(t3), np.asarray(th))
    b3 = o3.bfd(st, 1.3, 0.7)
    bh = oh.z_from_internal(oh.bfd(oh.stag_to_internal(st), 1.3, 0.7))
    np.testing.assert_array_equal(np.asarray(b3), np.asarray(bh))
    c3 = o3.bfd_T(z, 0.9)
    ch = oh.stag_from_internal(oh.bfd_T(oh.z_to_internal(z), 0.9))
    np.testing.assert_array_equal(np.asarray(c3.q0), np.asarray(ch.q0))
    for a, b in zip(c3.bs, ch.bs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    p3 = o3.make_poisson(1.0)
    ph = oh.make_poisson(1.0)
    s3 = p3.solve(phi, scale=0.5)
    sh = oh.phi_from_internal(ph.solve(oh.phi_to_internal(phi), scale=0.5))
    np.testing.assert_allclose(np.asarray(s3), np.asarray(sh),
                               rtol=1e-12, atol=1e-13)
    n3 = o3.t_node_interp(st.q0)
    q0i = oh.stag_to_internal(st).q0
    nh = oh._slice_space(oh.t_node_interp(q0i), t_real=geom.nt)
    np.testing.assert_array_equal(np.asarray(n3), np.asarray(nh))


def test_halo_t_sgs_sweep(setup_t):
    """HaloSGS with a sharded t axis (ppermute on all three axes)."""
    from dotsocp.ops.halo_engine import HaloSGS
    from dotsocp.ops.sgs import make_sgs

    geom, _, oh, phi, _, _ = setup_t
    ref = make_sgs(geom, D=1.0, dtype=jnp.float64)
    hal = HaloSGS(oh, D=1.0)
    rng = np.random.RandomState(11)
    rhs = jnp.asarray(rng.randn(*geom.phi_shape))
    d2 = jnp.asarray(1.21)
    a = ref.sweep(phi, rhs, its=2, d2=d2)
    b = oh.phi_from_internal(
        hal.sweep(oh.phi_to_internal(phi), oh.phi_to_internal(rhs), its=2,
                  d2=d2)
    )
    np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                               rtol=1e-12, atol=1e-13)


def test_halo_sgs_solve_matches_trajectory():
    """sGS-inPALM under a spatial mesh (halo is now the default mesh
    layout) must reproduce the single-device trajectory — the sweep, its
    block residual, and the win-count sigma machinery all agree."""
    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_2d("example2", 33, 33)
    opts = {"tol": 1e-3, "driver": "device", "maxit": 2000}
    out1, hml1, _ = solve_dot(rho0, rho1, 9, 1, dict(opts), "sGS-inPALM",
                              dtype=jnp.float32, verbose=False)
    mesh = make_mesh(8, axis_names=("y", "x"))
    out2, hml2, _ = solve_dot(rho0, rho1, 9, 1, dict(opts, mesh=mesh),
                              "sGS-inPALM", dtype=jnp.float32, verbose=False)
    i1 = [l["iters"] for l in out1["levels"]]
    i2 = [l["iters"] for l in out2["levels"]]
    assert i1 == i2
    assert bool(out2["mass_ok"])
    np.testing.assert_allclose(hml1["kkt"][-1], hml2["kkt"][-1],
                               rtol=0.05, atol=1e-7)


def test_halo_t_solve_matches_trajectory():
    """End-to-end inPALM on a (t, y, x) mesh through the halo engine."""
    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_2d("example2", 17, 17)
    opts = {"tol": 1e-3, "driver": "device"}
    out1, hml1, _ = solve_dot(rho0, rho1, 9, 1, dict(opts), "inPALM",
                              dtype=jnp.float32, verbose=False)
    mesh = make_mesh(8, axis_names=("t", "y", "x"))
    out2, hml2, _ = solve_dot(rho0, rho1, 9, 1, dict(opts, mesh=mesh),
                              "inPALM", dtype=jnp.float32, verbose=False)
    i1 = [l["iters"] for l in out1["levels"]]
    i2 = [l["iters"] for l in out2["levels"]]
    assert i1 == i2
    assert bool(out2["mass_ok"])
    np.testing.assert_allclose(hml1["kkt"][-1], hml2["kkt"][-1],
                               rtol=0.05, atol=1e-7)


def test_halo_3d_ops_match():
    """3D grids through the halo engine on a (z, y, x) mesh — the engine
    is dimension-generic; C = 14 cone columns."""
    geom = Geometry(nt=5, space=(9, 9, 17))
    mesh = make_mesh(8, axis_names=("z", "y", "x"))
    o3 = Ops3D(geom, jnp.float64)
    oh = make_ops(geom, jnp.float64, "halo", mesh)
    rng = np.random.RandomState(5)
    phi = jnp.asarray(rng.randn(*geom.phi_shape))
    st = Staggered(
        q0=jnp.asarray(rng.randn(*geom.q0_shape)),
        bs=tuple(jnp.asarray(rng.randn(*geom.b_shape(a))) for a in range(3)),
    )
    z = jnp.asarray(rng.randn(*geom.z_shape))
    g3, gh = o3.grad(phi), oh.stag_from_internal(oh.grad(oh.phi_to_internal(phi)))
    np.testing.assert_array_equal(np.asarray(g3.q0), np.asarray(gh.q0))
    for a, b in zip(g3.bs, gh.bs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    t3 = o3.grad_T(st)
    th = oh.phi_from_internal(oh.grad_T(oh.stag_to_internal(st)))
    np.testing.assert_array_equal(np.asarray(t3), np.asarray(th))
    b3 = o3.bfd(st, 1.3, 0.7)
    bh = oh.z_from_internal(oh.bfd(oh.stag_to_internal(st), 1.3, 0.7))
    np.testing.assert_array_equal(np.asarray(b3), np.asarray(bh))
    c3 = o3.bfd_T(z, 0.9)
    ch = oh.stag_from_internal(oh.bfd_T(oh.z_to_internal(z), 0.9))
    np.testing.assert_array_equal(np.asarray(c3.q0), np.asarray(ch.q0))
    for a, b in zip(c3.bs, ch.bs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    p3, ph = o3.make_poisson(1.0), oh.make_poisson(1.0)
    np.testing.assert_allclose(
        np.asarray(oh.phi_from_internal(
            ph.solve(oh.phi_to_internal(phi), scale=0.5))),
        np.asarray(p3.solve(phi, scale=0.5)), rtol=1e-12, atol=1e-13)


def test_halo_3d_solve_matches_trajectory():
    """End-to-end 3D solve on a (z, y, x) mesh (halo is the default) vs
    single-device, plus a PARTIAL (y, x) mesh leaving nz unsharded."""
    from dotsocp.models.examples import get_example_3d
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_3d("gaussian", 9, 9, 9)
    opts = {"tol": 5e-3, "driver": "device", "maxit": 600}
    out1, hml1, _ = solve_dot(rho0, rho1, 5, 1, dict(opts), "inPALM",
                              dtype=jnp.float32, verbose=False)
    i1 = [l["iters"] for l in out1["levels"]]
    for names in (("z", "y", "x"), ("y", "x")):
        mesh = make_mesh(8 if len(names) == 3 else 4, axis_names=names)
        out2, hml2, _ = solve_dot(rho0, rho1, 5, 1, dict(opts, mesh=mesh),
                                  "inPALM", dtype=jnp.float32, verbose=False)
        i2 = [l["iters"] for l in out2["levels"]]
        assert i1 == i2, (names, i1, i2)
        np.testing.assert_allclose(hml1["kkt"][-1], hml2["kkt"][-1],
                                   rtol=0.05, atol=1e-7)


def test_halo_solve_matches_trajectory():
    """Full multilevel solve on the halo layout (opts mesh + layout='halo')
    vs the single-device run: identical iteration counts, close KKT."""
    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_2d("example2", 33, 33)
    opts = {"tol": 1e-4, "driver": "device"}
    out1, hml1, _ = solve_dot(rho0, rho1, 9, 2, dict(opts), "inPALM",
                              dtype=jnp.float32, verbose=False)
    mesh = make_mesh(8, axis_names=("y", "x"))
    out2, hml2, _ = solve_dot(rho0, rho1, 9, 2,
                              dict(opts, mesh=mesh, layout="halo"),
                              "inPALM", dtype=jnp.float32, verbose=False)
    i1 = [l["iters"] for l in out1["levels"]]
    i2 = [l["iters"] for l in out2["levels"]]
    assert i1 == i2
    assert bool(out2["mass_ok"])
    np.testing.assert_allclose(hml1["kkt"][-1], hml2["kkt"][-1],
                               rtol=0.05, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out1["rho"]),
                               np.asarray(out2["rho"]), atol=1e-2)
