"""Red-black symmetric Gauss-Seidel smoother for the scaled space-time
Neumann Laplacian  (D^2 * A^T A + eps I) phi = rhs.

JAX equivalent of the reference's ``mexsGS`` binary (compiled from
``mexRBsGSscaling.cpp``; called at ``solver_socp_sGSinPALM.m:205`` with
``scaleLap = D^2`` and 1 sweep). Red-black coloring makes each half-sweep a
masked Jacobi update — a pure stencil + select that XLA vectorizes across the
full grid, and the natural halo-exchange form for spatial sharding (unlike
the global DCT solve, this path only talks to +-1 neighbours).

One symmetric sweep = forward (B, A) + backward (A, B) half-sweeps, which
collapses to B, A, B since repeating a color with unchanged neighbours is a
no-op. Color A is the class containing the grid origin — the class whose
residual the reference monitors (``solver_socp_sGSinPALM.m:213-217``,
``tmp_resi_sGS(1:2:end)``); ending on color B keeps that residual nonzero,
matching the reference's observable behaviour.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import Geometry


def _axis_h2inv(geom: Geometry):
    """1/h^2 per array axis (t first)."""
    ns = (geom.nt,) + geom.space
    return [float((n - 1) ** 2) for n in ns]


def checkerboard(geom: Geometry) -> np.ndarray:
    """Parity mask over (nt, *space); True = color A (contains the origin,
    the reference's odd-linear-index class)."""
    ns = (geom.nt,) + geom.space
    acc = np.zeros((), dtype=np.int64)
    for ax, n in enumerate(ns):
        shape = [1] * len(ns)
        shape[ax] = n
        acc = acc + np.arange(n).reshape(shape)
    return (acc % 2) == 0


class RedBlackSGS(NamedTuple):
    inv_diag: jax.Array   # 1 / diag(M), phi-shaped
    mask_a: jax.Array     # bool, color A
    h2inv: Tuple[float, ...]
    scale: float          # D^2

    def _neighbor_sum(self, phi: jax.Array) -> jax.Array:
        """sum of neighbor values weighted by 1/h^2 per axis (zero beyond
        the boundary — Neumann drops the missing neighbor)."""
        out = jnp.zeros_like(phi)
        for ax, w in enumerate(self.h2inv):
            n = phi.shape[ax]
            lo = jax.lax.slice_in_dim(phi, 0, n - 1, axis=ax)
            hi = jax.lax.slice_in_dim(phi, 1, n, axis=ax)
            pad_lo = [(0, 0)] * phi.ndim
            pad_lo[ax] = (1, 0)
            pad_hi = [(0, 0)] * phi.ndim
            pad_hi[ax] = (0, 1)
            # left neighbor phi[p-1] + right neighbor phi[p+1]
            out = out + w * (jnp.pad(lo, pad_lo) + jnp.pad(hi, pad_hi))
        return out

    def _half_sweep(self, phi: jax.Array, rhs: jax.Array, color_a: bool,
                    d2=None) -> jax.Array:
        """``d2`` overrides the baked D^2 scale at trace time (build the
        smoother with D=1 and pass the traced level constant here, so the
        executable does not depend on the per-level D)."""
        scale = self.scale if d2 is None else d2
        inv_diag = self.inv_diag if d2 is None else self.inv_diag / d2
        new = (rhs + scale * self._neighbor_sum(phi)) * inv_diag
        mask = self.mask_a if color_a else ~self.mask_a
        return jnp.where(mask, new, phi)

    def sweep(self, phi: jax.Array, rhs: jax.Array, its: int = 1,
              d2=None) -> jax.Array:
        """``its`` symmetric red-black sweeps (B, A, B)."""
        for _ in range(its):
            phi = self._half_sweep(phi, rhs, color_a=False, d2=d2)
            phi = self._half_sweep(phi, rhs, color_a=True, d2=d2)
            phi = self._half_sweep(phi, rhs, color_a=False, d2=d2)
        return phi

    def residual(self, phi: jax.Array, rhs: jax.Array, d2=None) -> jax.Array:
        """rhs - M phi (full grid)."""
        scale = self.scale if d2 is None else d2
        inv_diag = self.inv_diag if d2 is None else self.inv_diag / d2
        diag_term = phi / inv_diag
        return rhs - diag_term + scale * self._neighbor_sum(phi)

    def residual_color_a_norm(self, phi, rhs, h, d2=None) -> jax.Array:
        """sqrt(h) * || (rhs - M phi)[color A] || — the monitored sGS-block
        residual (``solver_socp_sGSinPALM.m:216``)."""
        r = jnp.where(self.mask_a, self.residual(phi, rhs, d2=d2), 0.0)
        return jnp.sqrt(h * jnp.sum(jnp.square(r)))


def make_sgs(geom: Geometry, D: float, eps: float = 0.0, dtype=jnp.float32) -> RedBlackSGS:
    ns = (geom.nt,) + geom.space
    h2inv = _axis_h2inv(geom)
    diag = np.zeros(ns)
    for ax, w in enumerate(h2inv):
        deg = np.full(ns[ax], 2.0)
        deg[0] = deg[-1] = 1.0
        shape = [1] * len(ns)
        shape[ax] = ns[ax]
        diag = diag + w * deg.reshape(shape)
    diag = float(D) ** 2 * diag + eps
    return RedBlackSGS(
        inv_diag=jnp.asarray(1.0 / diag, dtype),
        mask_a=jnp.asarray(checkerboard(geom)),
        h2inv=tuple(h2inv),
        scale=float(D) ** 2,
    )
