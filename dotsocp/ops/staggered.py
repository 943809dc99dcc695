"""Staggered-grid field container (q, alpha, weights live on this layout).

Replaces the reference's flat concatenated vectors with ``qInd`` offsets
(``socp/dot2d/utils/initialize.m:17-20``) by a small pytree holding the
time-staggered block and one face-staggered block per spatial axis.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Staggered(NamedTuple):
    """q-layout field: q0 on time-staggered cells, bs[a] on faces of axis a.

    Shapes (see :class:`~dotsocp.ops.geometry.Geometry`):
      q0:    (nt-1, *space)
      bs[a]: (nt, ..., n_a - 1, ...)
    """

    q0: jax.Array
    bs: Tuple[jax.Array, ...]

    # -- arithmetic (pytree-wise; operator-based so numpy leaves stay on
    # host and jax leaves stay traced/on-device) -------------------------
    def __add__(self, other: "Staggered") -> "Staggered":
        return jax.tree.map(lambda a, b: a + b, self, other)

    def __sub__(self, other: "Staggered") -> "Staggered":
        return jax.tree.map(lambda a, b: a - b, self, other)

    def __mul__(self, other) -> "Staggered":
        if isinstance(other, Staggered):
            return jax.tree.map(lambda a, b: a * b, self, other)
        return jax.tree.map(lambda x: x * other, self)

    __rmul__ = __mul__

    def __truediv__(self, other) -> "Staggered":
        if isinstance(other, Staggered):
            return jax.tree.map(lambda a, b: a / b, self, other)
        return jax.tree.map(lambda x: x / other, self)

    def __neg__(self) -> "Staggered":
        return jax.tree.map(lambda x: -x, self)

    # -- reductions ------------------------------------------------------
    def sqnorm(self) -> jax.Array:
        """Sum of squares over all blocks (the flat-vector ||.||^2)."""
        parts = [jnp.sum(jnp.square(self.q0))]
        parts += [jnp.sum(jnp.square(b)) for b in self.bs]
        return sum(parts)

    def dot(self, other: "Staggered") -> jax.Array:
        # jnp.sum(a*b), not vdot: vdot ravels, and flattening a spatially
        # sharded array forces a full all-gather under GSPMD
        parts = [jnp.sum(self.q0 * other.q0)]
        parts += [jnp.sum(a * b) for a, b in zip(self.bs, other.bs)]
        return sum(parts)

    @property
    def dtype(self):
        return self.q0.dtype

    def astype(self, dtype) -> "Staggered":
        return jax.tree.map(lambda x: x.astype(dtype), self)


def zeros(geom, dtype=jnp.float32) -> Staggered:
    return Staggered(
        q0=jnp.zeros(geom.q0_shape, dtype),
        bs=tuple(jnp.zeros(geom.b_shape(a), dtype) for a in range(geom.ndim_space)),
    )


def ones(geom, dtype=jnp.float32) -> Staggered:
    return Staggered(
        q0=jnp.ones(geom.q0_shape, dtype),
        bs=tuple(jnp.ones(geom.b_shape(a), dtype) for a in range(geom.ndim_space)),
    )


def from_flat(geom, vec, dtype=None) -> Staggered:
    """Build from the reference's flat MATLAB ordering (for tests/parity).

    The reference stacks [q0; bx; by] with each block a column-major flatten
    of a (ny, nx, nt) MATLAB array; our arrays are (nt, ny, nx), i.e. the
    MATLAB array with the time axis moved to the front.
    """
    import numpy as np

    vec = np.asarray(vec)
    out_blocks = []
    off = 0
    shapes = [geom.q0_shape] + [geom.b_shape(a) for a in range(geom.ndim_space)]
    for shp in shapes:
        n = int(np.prod(shp))
        # MATLAB block shape = (*space, nt); ours = (nt, *space).
        mshape = shp[1:] + (shp[0],)
        block = np.moveaxis(vec[off : off + n].reshape(mshape, order="F"), -1, 0)
        out_blocks.append(jnp.asarray(block, dtype=dtype))
        off += n
    return Staggered(q0=out_blocks[0], bs=tuple(out_blocks[1:]))


def to_flat(st: Staggered):
    """Inverse of :func:`from_flat` (reference flat ordering)."""
    import numpy as np

    blocks = [st.q0] + list(st.bs)
    return np.concatenate(
        [np.moveaxis(np.asarray(b), 0, -1).flatten(order="F") for b in blocks]
    )
