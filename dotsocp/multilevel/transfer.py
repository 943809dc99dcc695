"""Multilevel transfer operators: restriction of densities/weights and
prolongation of (phi, beta) to the next finer grid.

The reference's 2-D 9-point full-weighting restriction with boundary
renormalization (``socp/dot2d/utils/downSample_phi.m``, third-party Jialin
Liu) is exactly the separable application of the 1-D stencil
[1/4, 1/2, 1/4] with boundary rows [2/3, 1/3] (cf. the 1-D version
``socp/dot1d/utils/downSample_phi.m``), so we implement the 1-D operator
once and apply it per axis — dimension-generic, each axis application a
small dense matmul.

Prolongations (``socp/dot2d/utils/interpolate.m``): phi is linear on the
centered grid in every axis (t, y, x); z-layout fields (beta) are
nearest-neighbour in t (each coarse time interval covers two fine ones) and
linear in space. Staggered weights (wdot2d) restrict with the normalized
transposes of those prolongations (``socp/wdot2d/utils/downSample_q.m``),
in log space for barrier weights (``downSample_barrier.m``).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.geometry import Geometry
from ..ops.staggered import Staggered


# ---------------------------------------------------------------------------
# 1-D operators as dense matrices (n <= ~1025: negligible)
# ---------------------------------------------------------------------------

def restrict_matrix_fw(n_fine: int) -> np.ndarray:
    """Full-weighting restriction (n_fine odd) -> (n_fine+1)//2 points:
    interior [1/4, 1/2, 1/4], boundaries [2/3, 1/3]."""
    n_c = (n_fine - 1) // 2 + 1
    R = np.zeros((n_c, n_fine))
    R[0, 0] = 2.0 / 3.0
    R[0, 1] = 1.0 / 3.0
    R[-1, -1] = 2.0 / 3.0
    R[-1, -2] = 1.0 / 3.0
    for i in range(1, n_c - 1):
        j = 2 * i
        R[i, j - 1] = 0.25
        R[i, j] = 0.5
        R[i, j + 1] = 0.25
    return R


def prolong_matrix_linear(n_coarse: int) -> np.ndarray:
    """Linear prolongation on a centered axis: n -> 2(n-1)+1
    (``downSample_q.m: gene_prolongMat1dim_linear``)."""
    n_f = 2 * (n_coarse - 1) + 1
    P = np.zeros((n_f, n_coarse))
    for j in range(n_coarse):
        P[2 * j, j] = 1.0
    for j in range(n_coarse - 1):
        P[2 * j + 1, j] = 0.5
        P[2 * j + 1, j + 1] = 0.5
    return P


def prolong_matrix_nearest(n_coarse: int) -> np.ndarray:
    """Nearest prolongation on a staggered axis: n -> 2n
    (``downSample_q.m: gene_prolongMat1dim_nearest``)."""
    P = np.zeros((2 * n_coarse, n_coarse))
    for j in range(n_coarse):
        P[2 * j, j] = 1.0
        P[2 * j + 1, j] = 1.0
    return P


def _normalized_restriction(P: np.ndarray) -> np.ndarray:
    """R = transpose(P / column_sums(P)) (``downSample_q.m:10-12``)."""
    return (P / P.sum(axis=0, keepdims=True)).T


def _apply_axis(M, x, axis):
    # HIGHEST: the default f32 matmul precision on a GPU may be TF32
    # (~1e-3 relative), which would perturb every level's warm start
    y = jnp.tensordot(jnp.asarray(M, x.dtype), x, axes=[[1], [axis]],
                      precision=jax.lax.Precision.HIGHEST)
    return jnp.moveaxis(y, 0, axis)


# ---------------------------------------------------------------------------
# densities
# ---------------------------------------------------------------------------

def restrict_density(rho: jax.Array) -> jax.Array:
    """Full-weighting restriction of a spatial density over every axis."""
    for ax in range(rho.ndim):
        rho = _apply_axis(restrict_matrix_fw(rho.shape[ax]), rho, ax)
    return rho


# ---------------------------------------------------------------------------
# phi / beta prolongation (jump to next level)
# ---------------------------------------------------------------------------

def prolong_phi(phi: jax.Array) -> jax.Array:
    """Linear interpolation of the centered potential in every axis
    (``interpolate.m: interpolate_phi``)."""
    for ax in range(phi.ndim):
        phi = _apply_axis(prolong_matrix_linear(phi.shape[ax]), phi, ax)
    return phi


def prolong_z_like(z: jax.Array) -> jax.Array:
    """Prolongation of a (C, nt-1, *space) cone-layout field: nearest in t,
    linear in space, per column (``interpolate.m: interpolate_tStagger``).

    Matches the reference's order: duplicate in t, then interpolate space.
    """
    # t: nearest (axis 1)
    z = _apply_axis(prolong_matrix_nearest(z.shape[1]), z, 1)
    for ax in range(2, z.ndim):
        z = _apply_axis(prolong_matrix_linear(z.shape[ax]), z, ax)
    return z


# ---------------------------------------------------------------------------
# staggered-field restriction (wdot2d weights / q-like fields)
# ---------------------------------------------------------------------------

def restrict_staggered(st: Staggered, log_space: bool = False) -> Staggered:
    """Restriction of a q-layout field to the next coarser staggered grid.

    ``log_space=True`` reproduces ``downSample_barrier.m`` (geometric mean,
    so 1e6 walls survive coarsening); ``False`` is ``downSample_q.m``.
    """
    def xform(x):
        return jnp.log(x) if log_space else x

    def unxform(x):
        return jnp.exp(x) if log_space else x

    def apply_block(block, stag_axis):
        y = xform(block)
        for ax in range(block.ndim):
            n = block.shape[ax]
            if ax == stag_axis:
                R = _normalized_restriction(prolong_matrix_nearest(n // 2))
            else:
                R = _normalized_restriction(prolong_matrix_linear((n - 1) // 2 + 1))
            y = _apply_axis(R, y, ax)
        return unxform(y)

    q0 = apply_block(st.q0, 0)  # t-staggered: nearest along axis 0
    bs = tuple(
        apply_block(b, 1 + a) for a, b in enumerate(st.bs)
    )
    return Staggered(q0=q0, bs=bs)
