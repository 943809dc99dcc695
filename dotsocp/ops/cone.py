"""Per-cell cone operators: BF gather, its adjoint, Lorentz projection, and
the diagonal of I + (E/D)^2 F* B* B F.

JAX equivalents of the reference's four shipped C++ MEX kernels
(``mexBFd``, ``mexBFdConj``, ``mexProjSoc`` — semantics reconstructed at the
call sites ``solver_socp_inPALM.m:133,199,205`` and the diagonal identity
``socp/dot2d/utils/oper_q.m``). All are expressed as padded shifts and
element-wise math so XLA fuses them into single memory-bound passes.

Cone-column convention (C = 2 + 4d columns per time-staggered cell):

  col 0      : scaleD - scaleBF * q0[cell]            (head of the Lorentz cone)
  cols 1+4a..4+4a (axis a): scaleBF/sqrt(2) * the four face values of b_a
               bounding the cell — order [t-lo,x-lo], [t-lo,x-hi],
               [t-hi,x-lo], [t-hi,x-hi]; out-of-domain faces contribute 0
  col C-1    : scaleD + scaleBF * q0[cell]

With d-entries (1,...,1) in cols {0, C-1} this reproduces the reference's
z-row identity  z_head^2 - sum(z_rest^2) = -4 q0 - (1/2) sum(face b)^2, i.e.
the discrete constraint f(q) = q0 + (1/8) sum_8 u^2 <= 0
(``solver_socp_inPALM.m:2-5``, ``utils/hist_violation_q_2d.m:4``).
The KKT-6 residual depends on cols 1..4d being exactly the b-part
(``compute_kkt_dot_complement.m:3`` uses z(:, 2:9)).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .geometry import Geometry
from .staggered import Staggered

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _pad_axis(x: jax.Array, axis: int, lo: int, hi: int) -> jax.Array:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (lo, hi)
    return jnp.pad(x, pad)


def bfd(geom: Geometry, q: Staggered, scale_bf, scale_d) -> jax.Array:
    """z2 = scale_bf * (BF q) + scale_d * d, shape (C, nt-1, *space).

    Equivalent of ``mexBFd(z2, q, nt, nx, ny, scaleBF, scaleD)``
    (``solver_socp_inPALM.m:133,212``).
    """
    cols = []
    head = scale_d - scale_bf * q.q0
    cols.append(head)
    s = scale_bf * _INV_SQRT2
    for a in range(geom.ndim_space):
        # pad faces of axis a on both sides -> aligned with cell centers
        bp = _pad_axis(q.bs[a], 1 + a, 1, 1)  # (nt, ..., n_a+1, ...)
        n_a = geom.space[a]
        x_lo = jax.lax.slice_in_dim(bp, 0, n_a, axis=1 + a)
        x_hi = jax.lax.slice_in_dim(bp, 1, n_a + 1, axis=1 + a)
        for t_sel in (slice(0, geom.nt - 1), slice(1, geom.nt)):
            cols.append(s * x_lo[t_sel])
            cols.append(s * x_hi[t_sel])
    tail = scale_d + scale_bf * q.q0
    cols.append(tail)
    return jnp.stack(cols, axis=0)


def bfd_T(geom: Geometry, x: jax.Array, scale_bf) -> Staggered:
    """q2 = scale_bf * (BF)^T x — scatter-free adjoint of the gather.

    Equivalent of ``mexBFdConj(q2, x, nt, nx, ny, scaleBF)``
    (``solver_socp_inPALM.m:205,225``; also the alpha warm start at
    ``utils/jump_nextLevel.m:16``). Written as shifted adds so no scatter is
    ever materialized.
    """
    q0 = scale_bf * (x[-1] - x[0])
    s = scale_bf * _INV_SQRT2
    bs = []
    col = 1
    for a in range(geom.ndim_space):
        acc = None
        for t_lo in (True, False):
            for x_lo in (True, False):
                xi = x[col]
                col += 1
                # time: cells (nt-1) -> face time-nodes (nt)
                y = _pad_axis(xi, 0, 0 if t_lo else 1, 1 if t_lo else 0)
                # space: cells (n_a) -> padded faces (n_a + 1)
                y = _pad_axis(y, 1 + a, 0 if x_lo else 1, 1 if x_lo else 0)
                acc = y if acc is None else acc + y
        # drop the two ghost faces
        n_a = geom.space[a]
        acc = jax.lax.slice_in_dim(acc, 1, n_a, axis=1 + a)
        bs.append(s * acc)
    return Staggered(q0=q0, bs=tuple(bs))


def proj_soc(v: jax.Array) -> jax.Array:
    """Row-wise projection onto the Lorentz cone K = {z: z[0] >= ||z[1:]||}.

    Equivalent of ``mexProjSoc(out, in)`` (``solver_socp_inPALM.m:199,240``).
    Branch-free: coef = clip((1 + z0/||w||)/2, 0, 1); head = max(z0, coef*||w||)
    covers interior / boundary-projection / zero cases including ||w|| = 0.
    """
    z0 = v[0]
    w = v[1:]
    nrm2 = jnp.sum(jnp.square(w), axis=0)
    nrm = jnp.sqrt(nrm2)
    safe = jnp.where(nrm > 0, nrm, 1.0)
    coef = jnp.clip(0.5 * (1.0 + z0 / safe), 0.0, 1.0)
    head = jnp.maximum(z0, coef * nrm)
    # when nrm == 0 the tail is 0 regardless of coef
    tail = coef[None] * w
    return jnp.concatenate([head[None], tail], axis=0)


def oper_q_diag(
    geom: Geometry, D, E, weight: Staggered | None = None, dtype=None
) -> Staggered:
    """Diagonal of  D_w^* D_w + (E/D)^2 F^* B^* B F  on the staggered grid.

    Unweighted (weight None, i.e. w = 1) this is ``socp/dot2d/utils/oper_q.m``:
    1 + 2(E/D)^2 in the interior, 1 + (E/D)^2 on the two boundary time
    slabs of the face blocks. Weighted it is ``socp/wdot2d/utils/oper_q.m``:
    the identity 1 is replaced by w^2 — both cases are base + w^2.
    """
    if weight is not None:
        dtype = weight.dtype
    tmp = jnp.asarray((E / D) ** 2, dtype=dtype)
    q0 = jnp.full(geom.q0_shape, 2.0 * tmp, dtype=dtype)
    bs = []
    for a in range(geom.ndim_space):
        b = jnp.full(geom.b_shape(a), 2.0 * tmp, dtype=dtype)
        # boundary time slabs participate in only one cell
        b = b.at[0].set(tmp)
        b = b.at[-1].set(tmp)
        bs.append(b)
    base = Staggered(q0=q0, bs=tuple(bs))
    if weight is None:
        return base + Staggered(
            q0=jnp.ones_like(base.q0), bs=tuple(jnp.ones_like(b) for b in base.bs)
        )
    return base + weight * weight
