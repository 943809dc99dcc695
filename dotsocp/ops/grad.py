"""Forward-difference gradient A and its adjoint as padded-shift stencils.

The reference materializes A as a sparse Kronecker-product matrix
(``socp/dot2d/utils/initialize.m:35-39,67-87``) and computes ``A*phi`` /
``A'*v`` as spmv. On an accelerator a sparse matrix is the wrong tool: both directions
are pure forward/backward difference stencils, expressed here as slicing and
zero-padding so XLA fuses them into neighbouring element-wise work.

``A^T A`` equals the (negative) space-time Neumann Laplacian, which is what
makes the phi-step a DCT solve (see :mod:`dotsocp.ops.poisson`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .geometry import Geometry
from .staggered import Staggered


def _diff(x: jax.Array, axis: int, h: float) -> jax.Array:
    """(x[i+1] - x[i]) / h along ``axis``."""
    n = x.shape[axis]
    lo = jax.lax.slice_in_dim(x, 0, n - 1, axis=axis)
    hi = jax.lax.slice_in_dim(x, 1, n, axis=axis)
    return (hi - lo) / h


def _diff_adjoint(u: jax.Array, axis: int, h: float, n: int) -> jax.Array:
    """Adjoint of :func:`_diff`: out[j] = (u[j-1] - u[j]) / h, u padded with 0.

    ``u`` has ``n-1`` entries along ``axis``; the output has ``n``.
    """
    pad_lo = [(0, 0)] * u.ndim
    pad_lo[axis] = (1, 0)
    pad_hi = [(0, 0)] * u.ndim
    pad_hi[axis] = (0, 1)
    return (jnp.pad(u, pad_lo) - jnp.pad(u, pad_hi)) / h


def grad(geom: Geometry, phi: jax.Array) -> Staggered:
    """A phi: forward differences onto the staggered grid.

    q0 = D_t phi (time-staggered), bs[a] = D_a phi (face-staggered).
    Mirrors ``model.grad * phi`` with grad from ``initialize.m:35-39``.
    """
    q0 = _diff(phi, 0, geom.ht)
    bs = tuple(
        _diff(phi, 1 + a, geom.hs(a)) for a in range(geom.ndim_space)
    )
    return Staggered(q0=q0, bs=bs)


def grad_T(geom: Geometry, st: Staggered) -> jax.Array:
    """A^T applied to a staggered field, returning a centered field."""
    out = _diff_adjoint(st.q0, 0, geom.ht, geom.nt)
    for a in range(geom.ndim_space):
        out = out + _diff_adjoint(st.bs[a], 1 + a, geom.hs(a), geom.space[a])
    return out
