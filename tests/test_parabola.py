"""Legacy parabolic projection (``ProjParab.m``): root-solver parity with
numpy's companion-matrix roots and projection properties."""
import jax.numpy as jnp
import numpy as np

from dotsocp.ops.parabola import proj_parab


def test_matches_polyroot_and_idempotent(rng):
    q = rng.standard_normal((100, 5)) * 2
    out = np.asarray(proj_parab(jnp.asarray(q)))
    for i in range(0, 100, 7):
        a = q[i, 0]
        nb = np.linalg.norm(q[i, 1:])
        roots = np.roots([1, 8 - a, 16 - 8 * a, -16 * a - 2 * nb])
        lam = max(roots[np.abs(roots.imag) < 1e-9].real.max(), 0.0)
        ref = np.concatenate([[a - lam], q[i, 1:] / (1 + lam)])
        np.testing.assert_allclose(out[i], ref, atol=1e-8)
    out2 = np.asarray(proj_parab(jnp.asarray(out)))
    np.testing.assert_allclose(out2, out, atol=1e-10)
