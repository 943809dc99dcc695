"""Native golden kernels vs the JAX operator core: independent C++
implementations must agree bitwise-to-f64-roundoff with the XLA ops."""
import numpy as np
import jax.numpy as jnp
import pytest

from dotsocp.ops.geometry import Geometry
from dotsocp.ops.staggered import Staggered
from dotsocp.ops.cone import bfd, bfd_T, proj_soc
from dotsocp.ops.sgs import make_sgs

native = pytest.importorskip("dotsocp.native")


@pytest.fixture(scope="module")
def geom():
    return Geometry(nt=6, space=(7, 9))


def _rand_staggered(geom, rng):
    return Staggered(
        q0=jnp.asarray(rng.standard_normal(geom.q0_shape)),
        bs=tuple(
            jnp.asarray(rng.standard_normal(geom.b_shape(a))) for a in range(2)
        ),
    )


def test_native_proj_soc(rng):
    z = rng.standard_normal((10, 40))
    ours = np.asarray(proj_soc(jnp.asarray(z)))
    gold = native.proj_soc(z)
    np.testing.assert_allclose(ours, gold, atol=1e-14)


def test_native_bfd(geom, rng):
    q = _rand_staggered(geom, rng)
    s_bf, s_d = 0.63, 1.7
    ours = np.asarray(bfd(geom, q, s_bf, s_d))
    nt, (ny, nx) = geom.nt, geom.space
    gold = native.bfd2d(
        np.asarray(q.q0), np.asarray(q.bs[0]), np.asarray(q.bs[1]),
        nt, ny, nx, s_bf, s_d,
    )
    np.testing.assert_allclose(ours, gold, atol=1e-14)


def test_native_bfd_conj(geom, rng):
    x = rng.standard_normal((10,) + geom.q0_shape)
    s_bf = 0.63
    ours = bfd_T(geom, jnp.asarray(x), s_bf)
    nt, (ny, nx) = geom.nt, geom.space
    q0, by, bx = native.bfd_conj2d(x, nt, ny, nx, s_bf)
    np.testing.assert_allclose(np.asarray(ours.q0), q0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(ours.bs[0]), by, atol=1e-13)
    np.testing.assert_allclose(np.asarray(ours.bs[1]), bx, atol=1e-13)


def test_native_sgs(geom, rng):
    D = 0.83
    sgs = make_sgs(geom, D=D, dtype=jnp.float64)
    phi = rng.standard_normal(geom.phi_shape)
    rhs = rng.standard_normal(geom.phi_shape)
    ours = np.asarray(sgs.sweep(jnp.asarray(phi), jnp.asarray(rhs), its=2))
    gold = native.rb_sgs(phi, rhs, scale=D * D, its=2)
    np.testing.assert_allclose(ours, gold, atol=1e-12)
