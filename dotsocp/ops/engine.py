"""Layout engines for the solver hot loop: classic shaped arrays vs the
flat layout.

``OpsFlat`` stores every field with its *spatial axes flattened into one
trailing axis* of S = prod(space) elements, like the reference's MEX
kernels, which iterate flat vectors (``socp/dot2d/utils/initialize.m:
17-20``). It was built for a device that pads a 2^k + 1 trailing axis to
a multiple of 128; whether it still earns its code on an H100, against
the shaped layout, is not measured yet (ROADMAP design debt 3). It keeps
staggered face blocks in cell-shaped arrays with an explicit **ghost
slot** (coordinate n_a - 1 along axis a) pinned to zero:

- all element-wise solver algebra is unchanged (ghost zeros are preserved
  by every step once grad/bfd_T re-mask their outputs);
- a spatial shift by one cell along axis a is a flat shift by stride_a,
  and the zero padding of the flat shift lands exactly where the staggered
  boundary needs zeros, so the BF gather, its adjoint, grad and grad^T
  need no per-element masks — only the two producers of face arrays
  (grad, bfd_T) multiply their output by a per-axis ghost mask;
- values are bitwise identical to the shaped ops (same operations in the
  same order; masking only writes exact zeros into ghost slots).

``Ops3D`` wraps the original shaped operators behind the same interface so
:class:`~dotsocp.algorithms.core.Kernels` is layout-agnostic. The shaped
layout remains the default for sharded/spmd paths (halo partitioning is
annotated on the 2-D spatial axes) and for the sGS family (the red-black
sweep wants the shaped field).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import Geometry
from .staggered import Staggered
from . import staggered as stg
from .grad import grad as grad3, grad_T as grad_T3
from .cone import bfd as bfd3, bfd_T as bfd_T3, oper_q_diag as oper_q_diag3
from .poisson import make_dct_poisson

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _t_node_interp_concat(x):
    """Time-staggered -> time-node interpolation with zero-padded ends
    (``compute_kkt_dot_complement.m`` movmean): (nt-1, ...) -> (nt, ...)."""
    zslab = jnp.zeros((1,) + x.shape[1:], x.dtype)
    padded = jnp.concatenate([zslab, x, zslab], axis=0)
    return 0.5 * (padded[:-1] + padded[1:])


class Ops3D:
    """Shaped-array engine: thin wrapper over the original operators."""

    layout = "3d"

    def __init__(self, geom: Geometry, dtype):
        self.geom = geom
        self.dtype = dtype

    # -- operators --------------------------------------------------------
    def grad(self, phi):
        return grad3(self.geom, phi)

    def grad_T(self, st):
        return grad_T3(self.geom, st)

    def bfd(self, q, scale_bf, scale_d):
        return bfd3(self.geom, q, scale_bf, scale_d)

    def bfd_T(self, x, scale_bf):
        return bfd_T3(self.geom, x, scale_bf)

    def oper_q_diag(self, D, E, weight: Optional[Staggered]):
        return oper_q_diag3(self.geom, D, E, weight, dtype=self.dtype)

    def make_poisson(self, D, split: bool = False):
        return make_dct_poisson(self.geom, D=D, dtype=self.dtype,
                                split=split)

    def face_interp(self, x, a: int):
        """Average a node-positioned field onto the faces of axis a."""
        ax = 1 + a
        n_a = self.geom.space[a]
        lo = jax.lax.slice_in_dim(x, 0, n_a - 1, axis=ax)
        hi = jax.lax.slice_in_dim(x, 1, n_a, axis=ax)
        return 0.5 * (lo + hi)

    def t_node_interp(self, x):
        return _t_node_interp_concat(x)

    def demean(self, phi):
        return phi - jnp.mean(phi)

    # -- layout conversions (identity) -------------------------------------
    def stag_to_internal(self, st: Staggered) -> Staggered:
        return st

    def stag_from_internal(self, st: Staggered) -> Staggered:
        return st

    def weight_to_internal(self, w: Staggered) -> Staggered:
        return w

    def z_to_internal(self, z):
        return z

    def z_from_internal(self, z):
        return z

    def phi_to_internal(self, phi):
        return phi

    def phi_from_internal(self, phi):
        return phi


class OpsFlat:
    """Flat-space engine: fields carry (time, S) with S = prod(space)."""

    layout = "flat"

    def __init__(self, geom: Geometry, dtype):
        self.geom = geom
        self.dtype = dtype
        d = geom.ndim_space
        self.S = int(np.prod(geom.space))
        strides = []
        for a in range(d):
            strides.append(int(np.prod(geom.space[a + 1:])))
        self.strides = tuple(strides)
        # ghost mask per axis: 0.0 where coord_a == n_a - 1 (the ghost face
        # slot), 1.0 elsewhere. Stored as a constant (S,) array: reading it
        # costs S * itemsize/pass, ~1.5% of a face array.
        masks = []
        for a in range(d):
            coord = (np.arange(self.S) // self.strides[a]) % geom.space[a]
            masks.append(jnp.asarray(
                (coord != geom.space[a] - 1).astype(np.dtype(jnp.dtype(dtype).name))
            ))
        self.masks = tuple(masks)

    # -- flat shifts --------------------------------------------------------
    def _sfwd(self, x, a: int):
        """y[..., i] = x[..., i - stride_a] (zeros shifted in)."""
        k = self.strides[a]
        pad = [(0, 0)] * (x.ndim - 1) + [(k, 0)]
        return jnp.pad(x, pad)[..., : self.S]

    def _sbwd(self, x, a: int):
        """y[..., i] = x[..., i + stride_a] (zeros shifted in)."""
        k = self.strides[a]
        pad = [(0, 0)] * (x.ndim - 1) + [(0, k)]
        return jnp.pad(x, pad)[..., k:]

    # -- operators ----------------------------------------------------------
    def grad(self, phi):
        """A phi. phi: (nt, S) -> Staggered(q0 (nt-1, S), bs[a] (nt, S))."""
        geom = self.geom
        q0 = (phi[1:] - phi[:-1]) / geom.ht
        bs = tuple(
            ((self._sbwd(phi, a) - phi) / geom.hs(a)) * self.masks[a]
            for a in range(geom.ndim_space)
        )
        return Staggered(q0=q0, bs=bs)

    def grad_T(self, st: Staggered):
        """A^T. Ghost-zero faces supply the boundary zeros of the adjoint
        differences, so no masks are needed here."""
        geom = self.geom
        q0 = st.q0
        pad_lo = jnp.pad(q0, [(1, 0)] + [(0, 0)] * (q0.ndim - 1))
        pad_hi = jnp.pad(q0, [(0, 1)] + [(0, 0)] * (q0.ndim - 1))
        out = (pad_lo - pad_hi) / geom.ht
        for a in range(geom.ndim_space):
            b = st.bs[a]
            out = out + (self._sfwd(b, a) - b) / geom.hs(a)
        return out

    def bfd(self, q: Staggered, scale_bf, scale_d):
        """z2 = scale_bf * (BF q) + scale_d * d. Ghost-zero faces make the
        boundary cells read exact zeros through the flat shifts."""
        geom = self.geom
        nt = geom.nt
        cols = [scale_d - scale_bf * q.q0]
        s = scale_bf * _INV_SQRT2
        for a in range(geom.ndim_space):
            x_lo = self._sfwd(q.bs[a], a)   # face j-1 at cell j (0 at j=0)
            x_hi = q.bs[a]                  # face j at cell j (ghost: 0)
            for t_sel in (slice(0, nt - 1), slice(1, nt)):
                cols.append(s * x_lo[t_sel])
                cols.append(s * x_hi[t_sel])
        cols.append(scale_d + scale_bf * q.q0)
        return jnp.stack(cols, axis=0)

    def bfd_T(self, x, scale_bf) -> Staggered:
        """q2 = scale_bf * (BF)^T x; ghost slots re-zeroed by the axis mask."""
        geom = self.geom
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
                    y = self._sbwd(xi, a) if x_lo else xi
                    tpad = [(0, 1)] if t_lo else [(1, 0)]
                    y = jnp.pad(y, tpad + [(0, 0)] * (y.ndim - 1))
                    acc = y if acc is None else acc + y
            bs.append((s * acc) * self.masks[a])
        return Staggered(q0=q0, bs=tuple(bs))

    def oper_q_diag(self, D, E, weight: Optional[Staggered]) -> Staggered:
        """Same values as the shaped ``oper_q.m`` diagonal on real slots;
        ghost slots get the interior value (harmless: every numerator that
        multiplies 1/diag is exactly zero there)."""
        geom = self.geom
        dtype = self.dtype if weight is None else weight.dtype
        tmp = jnp.asarray((E / D) ** 2, dtype=dtype)
        q0 = jnp.full((geom.nt - 1, self.S), 2.0 * tmp, dtype=dtype)
        bs = []
        for a in range(geom.ndim_space):
            b = jnp.full((geom.nt, self.S), 2.0 * tmp, dtype=dtype)
            b = b.at[0].set(tmp)
            b = b.at[-1].set(tmp)
            bs.append(b)
        base = Staggered(q0=q0, bs=tuple(bs))
        if weight is None:
            return base + Staggered(
                q0=jnp.ones_like(base.q0),
                bs=tuple(jnp.ones_like(b) for b in base.bs),
            )
        return base + weight * weight

    def make_poisson(self, D, split: bool = False):
        inner = make_dct_poisson(self.geom, D=D, dtype=self.dtype,
                                 split=split)
        return _FlatPoisson(inner, self.geom)

    def face_interp(self, x, a: int):
        """0.5 * (x[j] + x[j+1]) at face slot j. The ghost slot holds
        garbage from the next row; every consumer multiplies it by a
        ghost-zero face array."""
        return 0.5 * (x + self._sbwd(x, a))

    def t_node_interp(self, x):
        return _t_node_interp_concat(x)

    def demean(self, phi):
        return phi - jnp.mean(phi)

    # -- layout conversions --------------------------------------------------
    def stag_to_internal(self, st: Staggered) -> Staggered:
        geom = self.geom
        q0 = st.q0.reshape((geom.nt - 1, self.S))
        bs = []
        for a in range(geom.ndim_space):
            pad = [(0, 0)] * st.bs[a].ndim
            pad[1 + a] = (0, 1)
            bs.append(jnp.pad(st.bs[a], pad).reshape((geom.nt, self.S)))
        return Staggered(q0=q0, bs=tuple(bs))

    def stag_from_internal(self, st: Staggered) -> Staggered:
        geom = self.geom
        q0 = st.q0.reshape((geom.nt - 1,) + geom.space)
        bs = []
        for a in range(geom.ndim_space):
            b = st.bs[a].reshape((geom.nt,) + geom.space)
            bs.append(jax.lax.slice_in_dim(b, 0, geom.space[a] - 1, axis=1 + a))
        return Staggered(q0=q0, bs=tuple(bs))

    def weight_to_internal(self, w: Staggered) -> Staggered:
        """Ghost slots padded with 1.0 (any finite value works: they only
        ever multiply exact zeros)."""
        geom = self.geom
        q0 = w.q0.reshape((geom.nt - 1, self.S))
        bs = []
        for a in range(geom.ndim_space):
            pad = [(0, 0)] * w.bs[a].ndim
            pad[1 + a] = (0, 1)
            bs.append(
                jnp.pad(w.bs[a], pad, constant_values=1.0).reshape(
                    (geom.nt, self.S)
                )
            )
        return Staggered(q0=q0, bs=tuple(bs))

    def z_to_internal(self, z):
        return z.reshape(z.shape[:2] + (self.S,))

    def z_from_internal(self, z):
        geom = self.geom
        return z.reshape(z.shape[:2] + geom.space)

    def phi_to_internal(self, phi):
        return phi.reshape((phi.shape[0], self.S))

    def phi_from_internal(self, phi):
        return phi.reshape((phi.shape[0],) + self.geom.space)


class _FlatPoisson:
    """DCT Poisson solve on the flat layout: reshape to shaped axes for the
    per-axis matmuls (phi-sized relayouts) and back."""

    def __init__(self, inner, geom: Geometry):
        self.inner = inner
        self.geom = geom

    @property
    def mats(self):
        return self.inner.mats

    @property
    def inv_kernel(self):
        return self.inner.inv_kernel

    def solve(self, rhs, scale=None):
        shaped = rhs.reshape((rhs.shape[0],) + self.geom.space)
        out = self.inner.solve(shaped, scale=scale)
        return out.reshape(rhs.shape)


def make_ops(geom: Geometry, dtype, layout: str, mesh=None):
    if layout == "flat":
        return OpsFlat(geom, dtype)
    if layout == "halo":
        from .halo_engine import OpsHalo

        return OpsHalo(geom, dtype, mesh)
    return Ops3D(geom, dtype)
