"""Halo-exchange layout engine: shaped arrays padded to mesh-divisible
sizes, with the five stencil ops (grad, grad^T, BF gather, BF^T adjoint,
face interpolation) running under ``shard_map`` with explicit one-slab
``ppermute`` halo pulls.

Why this exists (measured, DESIGN.md section 8): on the discretization's
odd 2^k+1 grids GSPMD shards unevenly and lowers the pad+slice shift
patterns of :class:`Ops3D`/:class:`OpsFlat` to **full-axis all-gathers** —
~10 MB per step at 65x65x17 on a y=4,x=2 mesh, ~640 MB/step extrapolated to
the 513^2x65 target, ~20x the true halo requirement. Padding every spatial
axis to a mesh-divisible size makes the shards even, and the shifts become
exactly one boundary row/column exchanged with the neighbour shard.

Layout contract (mirrors the flat engine's ghost-slot discipline,
``ops/engine.py``):

- centered fields are (nt, *P) with P_a = k_a * ceil(n_a / k_a); entries at
  coord_a >= n_a are structural zeros;
- staggered face blocks are stored cell-shaped (nt, *P) with the ghost slot
  coord_a == n_a - 1 *and* the padding pinned to zero;
- the two producers of face arrays (grad, bfd_T) re-mask their outputs; bfd
  masks its whole cone block (the +scale_d constant must not leak into pad
  cells); every other solver operation is element-wise and preserves the
  zeros, so KKT norms / dot products over padded arrays are exact.

The phi-step stays the exact matmul-DCT solve (the decision of DESIGN.md
section 8): the DCT matrices are zero-extended to the padded sizes, which
keeps coefficients and outputs zero on the pads while XLA partitions the
matmuls as plain sharded contractions.

Reference parity: the operators compute the same quantities as
``mexBFd``/``mexBFdConj``/``oper_poisson3dim``/``initialize.m:35-39`` —
see :mod:`dotsocp.ops.cone` / :mod:`dotsocp.ops.grad` for the
per-op citations; this module only changes the execution layout.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
try:  # jax >= 0.4.35 top-level export; the experimental path is deprecated
    from jax import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs, check_rep=False):
        # the top-level API renamed check_rep -> check_vma (jax 0.7+)
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=check_rep)
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from .geometry import Geometry
from .staggered import Staggered
from .poisson import make_dct_poisson

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _axis_vec(length: int, real: int, ndim: int, axis: int, dtype):
    """Broadcastable 1-D mask: 1.0 where coord < real, else 0.0."""
    v = np.zeros(length, np.dtype(jnp.dtype(dtype).name))
    v[:real] = 1.0
    shape = [1] * ndim
    shape[axis] = length
    return jnp.asarray(v.reshape(shape))


def _shift_local(xl, ax: int, name, k: int, fwd: bool):
    """One-slab halo shift on a shard-local array (usable inside a larger
    ``shard_map`` body): y[i] = x[i-1] along ``ax`` (``fwd``) or x[i+1],
    with zeros entering at the global ends (``lax.ppermute`` fills
    un-sourced receivers with zeros). ``k`` = mesh extent of ``name``;
    k == 1 degrades to a plain pad-shift with no collective."""
    nl = xl.shape[ax]
    if k == 1:
        pad = [(0, 0)] * xl.ndim
        if fwd:
            pad[ax] = (1, 0)
            return lax.slice_in_dim(jnp.pad(xl, pad), 0, nl, axis=ax)
        pad[ax] = (0, 1)
        return lax.slice_in_dim(jnp.pad(xl, pad), 1, nl + 1, axis=ax)
    if fwd:
        edge = lax.slice_in_dim(xl, nl - 1, nl, axis=ax)
        recv = lax.ppermute(edge, name, [(i, i + 1) for i in range(k - 1)])
        body = lax.slice_in_dim(xl, 0, nl - 1, axis=ax)
        return jnp.concatenate([recv, body], axis=ax)
    edge = lax.slice_in_dim(xl, 0, 1, axis=ax)
    recv = lax.ppermute(edge, name, [(i, i - 1) for i in range(1, k)])
    body = lax.slice_in_dim(xl, 1, nl, axis=ax)
    return jnp.concatenate([body, recv], axis=ax)


class OpsHalo:
    """Shaped engine on mesh-divisible padded grids with shard_map halos.

    When the mesh carries a ``t`` axis (the workload's "long-context" axis,
    SURVEY.md section 5), the time dimension joins the same padded
    ghost-slot discipline: phi/c pad nt -> Pt, and every time-staggered
    array (q0, z, beta, diag) is stored with the SAME padded extent Pt and
    a zero ghost slab at t == nt-1 — uniform extents keep cell index k and
    node index k on the same shard, so the BF t-coupling is exactly one
    ``ppermute`` slab (the structural cousin of ring attention). With no
    ``t`` mesh axis the time extents stay unpadded (nt / nt-1) and all
    t-operations degrade to the plain slicing of the spatial-only engine.
    """

    layout = "halo"

    def __init__(self, geom: Geometry, dtype, mesh):
        if mesh is None:
            raise ValueError("layout='halo' requires a mesh")
        d = geom.ndim_space
        if d not in (1, 2, 3):
            raise NotImplementedError("halo layout supports 1D/2D/3D grids")
        self.geom = geom
        self.dtype = dtype
        self.mesh = mesh
        self.names = {1: ("x",), 2: ("y", "x"), 3: ("z", "y", "x")}[d]
        # spatial axes absent from the mesh stay unsharded (k=1): a 3D
        # grid on a (y, x) mesh shards two of its three axes
        self.k = tuple(
            int(mesh.shape[nm]) if nm in mesh.axis_names else 1
            for nm in self.names
        )
        self.spec_names = tuple(
            nm if nm in mesh.axis_names else None for nm in self.names
        )
        if all(k == 1 for k in self.k):
            raise ValueError(
                f"mesh {dict(mesh.shape)} shares no spatial axis with "
                f"{self.names}; use axis names from {self.names}"
            )
        self.P = tuple(-(-n // k) * k for n, k in zip(geom.space, self.k))
        self.d = d
        # time axis: sharded iff the mesh has a non-trivial 't' axis
        self.t_name = "t" if "t" in mesh.axis_names else None
        self.kt = int(mesh.shape["t"]) if self.t_name else 1
        if self.kt == 1:
            self.t_name = None
        self.sharded_t = self.kt > 1
        # padded t extents: node (phi/c) and cell (q0/z) arrays share Pt
        # when t is sharded (index alignment across shards); unpadded
        # nt / nt-1 otherwise
        self.Pt = -(-geom.nt // self.kt) * self.kt if self.sharded_t else geom.nt
        self.Pt_cell = self.Pt if self.sharded_t else geom.nt - 1

    @property
    def phi_padded_shape(self):
        return (self.Pt,) + self.P

    def axis_comm(self, ax: int):
        """(mesh axis name, extent) for a phi-layout array axis (0 = t)."""
        if ax == 0:
            return (self.t_name, self.kt) if self.sharded_t else (None, 1)
        return self.names[ax - 1], self.k[ax - 1]

    def _spec(self, ndim: int) -> P:
        """Canonical PartitionSpec: t on the (ndim-d-1)-th axis when
        sharded, z/y/x on the trailing spatial axes (None for spatial
        axes the mesh does not carry)."""
        lead = [None] * (ndim - self.d - 1)
        t = [self.t_name] if self.sharded_t else [None]
        if ndim == self.d:  # purely spatial (no t axis present)
            lead, t = [], []
        return P(*lead, *t, *self.spec_names)

    def _pin(self, x):
        """Pin the canonical (t,)y/x sharding on an op output. Without
        this, GSPMD's propagation is free to replicate the (unconstrained)
        intermediates of reduction-only consumers like the KKT battery —
        measured as ~19 MB of full-axis all-gathers per KKT call at
        65x65x17; with the pin the reductions stay partial-then-psum."""
        from jax.sharding import NamedSharding

        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, self._spec(x.ndim)))

    # masks are built lazily per (ndim) and cached: broadcastable 1-D
    # factors, so the multiply fuses and costs no extra HBM stream
    def _face_mask(self, a: int, ndim: int):
        ax = ndim - self.d + a
        return _axis_vec(self.P[a], self.geom.space[a] - 1, ndim, ax,
                         self.dtype)

    def _t_mask(self, ndim: int, cell: bool):
        """1.0 where t-coord < real extent (nt-1 for cell arrays, nt for
        node arrays); None when t is unpadded (no masking needed)."""
        if not self.sharded_t:
            return None
        real = self.geom.nt - 1 if cell else self.geom.nt
        return _axis_vec(self.Pt, real, ndim, ndim - self.d - 1, self.dtype)

    def _cell_mask(self, ndim: int, t_cell: bool = False):
        """Spatial pad mask (coord_a < n_a); ``t_cell`` additionally zeros
        the t ghost/pad slabs of a time-staggered array."""
        m = None
        for a in range(self.d):
            ax = ndim - self.d + a
            v = _axis_vec(self.P[a], self.geom.space[a], ndim, ax, self.dtype)
            m = v if m is None else m * v
        if t_cell:
            tm = self._t_mask(ndim, cell=True)
            if tm is not None:
                m = tm if m is None else m * tm
        return m

    # -- halo shifts ---------------------------------------------------------
    def _shift_any(self, x, ax: int, name, k: int, fwd: bool):
        """Shift by one along array axis ``ax`` (zeros entering at the
        global ends); one-slab ppermute when the axis is mesh-sharded."""
        if k == 1:
            return _shift_local(x, ax, None, 1, fwd)
        spec = self._spec(x.ndim)
        return shard_map(
            lambda xl: _shift_local(xl, ax, name, k, fwd),
            self.mesh, (spec,), spec,
        )(x)

    def _shift(self, x, a: int, fwd: bool):
        """Spatial shift: fwd: y[i] = x[i-1] along spatial axis a
        (prev-neighbour halo); else y[i] = x[i+1] (next-neighbour)."""
        ax = x.ndim - self.d + a
        return self._shift_any(x, ax, self.names[a], self.k[a], fwd)

    def _shift_t(self, x, fwd: bool):
        """Time-axis shift (only meaningful when t is sharded-padded)."""
        ax = x.ndim - self.d - 1
        return self._shift_any(x, ax, self.t_name, self.kt, fwd)

    # -- time-axis staggering helpers ------------------------------------
    def _t_cell_sel(self, x, hi: bool):
        """Node-t array -> cell-t extent: the value at time node k
        (``hi=False``) or k+1 (``hi=True``) for time-staggered cell k."""
        if self.sharded_t:
            return self._shift_t(x, fwd=False) if hi else x
        return x[1:] if hi else x[:-1]

    def _t_node_scatter(self, y, t_lo: bool):
        """Cell-t array -> node-t extent: cell k contributes to node k
        (``t_lo``) or node k+1."""
        if self.sharded_t:
            return y if t_lo else self._shift_t(y, fwd=True)
        tpad = [(0, 1)] if t_lo else [(1, 0)]
        return jnp.pad(y, tpad + [(0, 0)] * (y.ndim - 1))

    # -- operators -------------------------------------------------------
    def grad(self, phi):
        """A phi (``initialize.m:35-39``); face outputs re-masked."""
        geom = self.geom
        if self.sharded_t:
            q0 = (self._shift_t(phi, fwd=False) - phi) / geom.ht
            q0 = self._pin(q0 * self._t_mask(phi.ndim, cell=True))
        else:
            q0 = self._pin((phi[1:] - phi[:-1]) / geom.ht)
        bs = tuple(
            self._pin(((self._shift(phi, a, fwd=False) - phi) / geom.hs(a))
                      * self._face_mask(a, phi.ndim))
            for a in range(self.d)
        )
        return Staggered(q0=q0, bs=bs)

    def grad_T(self, st: Staggered):
        """A^T; ghost-zero faces supply the adjoint boundary zeros (incl.
        the t ghost slab when t is sharded)."""
        geom = self.geom
        q0 = st.q0
        if self.sharded_t:
            out = (self._shift_t(q0, fwd=True) - q0) / geom.ht
        else:
            pad0 = [(0, 0)] * q0.ndim
            pad_lo, pad_hi = [list(pad0) for _ in range(2)]
            pad_lo[0] = (1, 0)
            pad_hi[0] = (0, 1)
            out = (jnp.pad(q0, pad_lo) - jnp.pad(q0, pad_hi)) / geom.ht
        for a in range(self.d):
            b = st.bs[a]
            out = out + (self._shift(b, a, fwd=True) - b) / geom.hs(a)
        return self._pin(out)

    def bfd(self, q: Staggered, scale_bf, scale_d):
        """z2 = scale_bf*(BF q) + scale_d*d (``mexBFd``); the whole block is
        cell-masked (in space AND t) so the scale_d constant never leaks
        into ghost/pad cells — that keeps z/beta pads at exact zero through
        proj_soc(0) = 0."""
        cols = [scale_d - scale_bf * q.q0]
        s = scale_bf * _INV_SQRT2
        for a in range(self.d):
            x_lo = self._shift(q.bs[a], a, fwd=True)
            x_hi = q.bs[a]
            for hi in (False, True):
                cols.append(s * self._t_cell_sel(x_lo, hi))
                cols.append(s * self._t_cell_sel(x_hi, hi))
        cols.append(scale_d + scale_bf * q.q0)
        z2 = jnp.stack(cols, axis=0)
        return self._pin(z2 * self._cell_mask(z2.ndim, t_cell=True))

    def bfd_T(self, x, scale_bf) -> Staggered:
        """q2 = scale_bf * (BF)^T x (``mexBFdConj``), scatter-free."""
        q0 = self._pin(scale_bf * (x[-1] - x[0]))
        s = scale_bf * _INV_SQRT2
        bs = []
        col = 1
        for a in range(self.d):
            acc = None
            for t_lo in (True, False):
                for x_lo in (True, False):
                    xi = x[col]
                    col += 1
                    y = self._shift(xi, a, fwd=False) if x_lo else xi
                    y = self._t_node_scatter(y, t_lo)
                    acc = y if acc is None else acc + y
            bs.append(self._pin((s * acc) * self._face_mask(a, acc.ndim)))
        return Staggered(q0=q0, bs=tuple(bs))

    def oper_q_diag(self, D, E, weight: Optional[Staggered]) -> Staggered:
        """``oper_q.m`` diagonal on real slots; ghost/pad slots hold the
        interior value (harmless: their numerators are exact zeros)."""
        geom = self.geom
        dtype = self.dtype if weight is None else weight.dtype
        tmp = jnp.asarray((E / D) ** 2, dtype=dtype)
        q0 = jnp.full((self.Pt_cell,) + self.P, 2.0 * tmp, dtype=dtype)
        bs = []
        for a in range(self.d):
            b = jnp.full((self.Pt,) + self.P, 2.0 * tmp, dtype=dtype)
            b = b.at[0].set(tmp)
            b = b.at[geom.nt - 1].set(tmp)
            bs.append(b)
        base = Staggered(q0=q0, bs=tuple(bs))
        if weight is None:
            return base + Staggered(
                q0=jnp.ones_like(base.q0),
                bs=tuple(jnp.ones_like(b) for b in base.bs),
            )
        return base + weight * weight

    def make_poisson(self, D, split: bool = False):
        if split:
            # _HaloPoisson re-implements the transform on pad-extended
            # matrices and ignores the inner's split/ir strategy — an
            # 'ir' build would silently hand it f32 matrices (f32-grade
            # phi, stalled f64 tails). Refuse rather than degrade; the
            # refine 'auto' picks plain f64 under a mesh
            # (multilevel/solve.py).
            raise ValueError(
                "halo layout: fast f64 DCT modes (refine_dct_split="
                f"{split!r}) are not supported under a mesh — use the "
                "plain f64 tail (refine_dct_split=False) or run the "
                "refine on the single-chip layout"
            )
        inner = make_dct_poisson(self.geom, D=D, dtype=self.dtype,
                                 split=split)
        return _HaloPoisson(inner, self)

    def face_interp(self, x, a: int):
        """0.5 * (x[j] + x[j+1]) at face slot j; consumers multiply by a
        ghost-zero face array, which annihilates the ghost-slot value."""
        return self._pin(0.5 * (x + self._shift(x, a, fwd=False)))

    def t_node_interp(self, x):
        """Time-staggered -> time-node interpolation with zero-padded ends
        (``compute_kkt_dot_complement.m`` movmean): node k gets
        0.5*(cell[k-1] + cell[k])."""
        if self.sharded_t:
            return 0.5 * (self._shift_t(x, fwd=True) + x)
        zslab = jnp.zeros((1,) + x.shape[1:], x.dtype)
        padded = jnp.concatenate([zslab, x, zslab], axis=0)
        return 0.5 * (padded[:-1] + padded[1:])

    def demean(self, phi):
        """phi - mean over REAL cells, pads kept at exact zero (a plain
        jnp.mean would divide by the padded size and write -mean into the
        pads, breaking the zero discipline the stencils rely on)."""
        n_real = self.geom.n_centered
        mean = jnp.sum(phi) / n_real
        m = self._cell_mask(phi.ndim)
        tm = self._t_mask(phi.ndim, cell=False)
        if tm is not None:
            m = m * tm if m is not None else tm
        return (phi - mean) * m if m is not None else phi - mean

    # -- layout conversions ------------------------------------------------
    def _pad_space(self, x, extra_short_axis: Optional[int] = None,
                   value: float = 0.0, t_real: Optional[int] = None):
        """Pad trailing spatial axes n_a -> P_a (``extra_short_axis`` marks a
        face array whose own axis has n_a - 1 real entries); ``t_real``
        additionally pads the t axis t_real -> Pt when t is sharded."""
        pad = [(0, 0)] * x.ndim
        for a in range(self.d):
            ax = x.ndim - self.d + a
            real = self.geom.space[a] - (1 if a == extra_short_axis else 0)
            pad[ax] = (0, self.P[a] - real)
        if self.sharded_t and t_real is not None:
            pad[x.ndim - self.d - 1] = (0, self.Pt - t_real)
        return jnp.pad(x, pad, constant_values=value)

    def _slice_space(self, x, extra_short_axis: Optional[int] = None,
                     t_real: Optional[int] = None):
        for a in range(self.d):
            ax = x.ndim - self.d + a
            real = self.geom.space[a] - (1 if a == extra_short_axis else 0)
            x = lax.slice_in_dim(x, 0, real, axis=ax)
        if self.sharded_t and t_real is not None:
            x = lax.slice_in_dim(x, 0, t_real, axis=x.ndim - self.d - 1)
        return x

    def stag_to_internal(self, st: Staggered) -> Staggered:
        nt = self.geom.nt
        return Staggered(
            q0=self._pad_space(st.q0, t_real=nt - 1),
            bs=tuple(self._pad_space(st.bs[a], extra_short_axis=a, t_real=nt)
                     for a in range(self.d)),
        )

    def stag_from_internal(self, st: Staggered) -> Staggered:
        nt = self.geom.nt
        return Staggered(
            q0=self._slice_space(st.q0, t_real=nt - 1),
            bs=tuple(self._slice_space(st.bs[a], extra_short_axis=a,
                                       t_real=nt)
                     for a in range(self.d)),
        )

    def weight_to_internal(self, w: Staggered) -> Staggered:
        """Ghost/pad slots filled with 1.0 (they only multiply zeros)."""
        nt = self.geom.nt
        return Staggered(
            q0=self._pad_space(w.q0, value=1.0, t_real=nt - 1),
            bs=tuple(self._pad_space(w.bs[a], extra_short_axis=a, value=1.0,
                                     t_real=nt)
                     for a in range(self.d)),
        )

    def z_to_internal(self, z):
        return self._pad_space(z, t_real=self.geom.nt - 1)

    def z_from_internal(self, z):
        return self._slice_space(z, t_real=self.geom.nt - 1)

    def phi_to_internal(self, phi):
        return self._pad_space(phi, t_real=self.geom.nt)

    def phi_from_internal(self, phi):
        return self._slice_space(phi, t_real=self.geom.nt)


class _HaloPoisson:
    """Exact DCT Poisson solve on the padded grid: the per-axis DCT
    matrices are zero-extended to (P_a, P_a), so spectral coefficients and
    outputs stay zero on the pads while the real block is bit-identical to
    the unpadded transform. inv_kernel pads hold 1.0 (they multiply zero
    coefficients)."""

    def __init__(self, inner, ops: OpsHalo):
        geom = ops.geom
        npdtype = np.dtype(jnp.dtype(ops.dtype).name)
        exts = [(geom.nt, ops.Pt)] + [
            (geom.space[a], ops.P[a]) for a in range(ops.d)
        ]
        mats = []
        for i, (n, Pn) in enumerate(exts):
            if Pn == n:
                mats.append(inner.mats[i])
            else:
                M = np.zeros((Pn, Pn), npdtype)
                M[:n, :n] = np.asarray(inner.mats[i])
                mats.append(jnp.asarray(M))
        self.mats = tuple(mats)
        self.inv_kernel = ops._pad_space(inner.inv_kernel, value=1.0,
                                         t_real=geom.nt)
        self.geom = geom

    def solve(self, rhs, scale=None):
        from .poisson import _apply_axis

        y = rhs
        for ax, C in enumerate(self.mats):
            y = _apply_axis(C, y, ax)
        inv_k = self.inv_kernel if scale is None else self.inv_kernel * scale
        y = y * inv_k
        for ax, C in enumerate(self.mats):
            y = _apply_axis(C.T, y, ax)
        return y


class HaloSGS:
    """Red-black symmetric Gauss-Seidel sweep on the halo layout — the
    halo-local phi-step for heavy spatial sharding (``mexsGS`` at
    ``solver_socp_sGSinPALM.m:205``; jnp reference :mod:`dotsocp.ops.sgs`).

    The three half-sweeps (B, A, B) run inside ONE ``shard_map``: each
    half-sweep pulls one boundary slab per spatial neighbour via
    ``ppermute`` before its masked-Jacobi update. Checkerboard coloring
    makes every half-sweep embarrassingly parallel, so exchanging halos at
    the start of each half-sweep reproduces the global sweep exactly —
    the neighbour slab received is the peer's current phi, which already
    carries its previous half-sweep updates (same color never reads same
    color). Pad cells (coord >= n) are excluded by a validity mask and stay
    exactly zero, preserving the engine's pad discipline; real-boundary
    Neumann neighbours beyond the domain read those zero pads.
    Same interface as :class:`~dotsocp.ops.sgs.RedBlackSGS`
    (``sweep`` / ``residual`` / ``residual_color_a_norm``)."""

    def __init__(self, ops: OpsHalo, D: float = 1.0, eps: float = 0.0):
        self.ops = ops
        geom = ops.geom
        ns = (geom.nt,) + geom.space
        padded = ops.phi_padded_shape
        self.h2inv = tuple(float((n - 1) ** 2) for n in ns)
        npdtype = np.dtype(jnp.dtype(ops.dtype).name)
        diag = np.zeros(padded)
        for ax, (n, w) in enumerate(zip(ns, self.h2inv)):
            deg = np.full(padded[ax], 2.0)
            deg[0] = 1.0
            deg[n - 1] = 1.0
            shape = [1] * len(padded)
            shape[ax] = padded[ax]
            diag = diag + w * deg.reshape(shape)
        diag = float(D) ** 2 * diag + eps
        self.inv_diag = jnp.asarray(1.0 / diag, npdtype)
        self.scale = float(D) ** 2
        # checkerboard parity on global coords (= array coords: padding is
        # appended, never interleaved); pads excluded by `valid`
        acc = np.zeros((), np.int64)
        valid = np.ones(padded, bool)
        for ax, m in enumerate(padded):
            shape = [1] * len(padded)
            shape[ax] = m
            acc = acc + np.arange(m).reshape(shape)
            v = np.ones(m, bool)
            v[ns[ax]:] = False
            valid = valid & v.reshape(shape)
        self.mask_a = jnp.asarray((acc % 2) == 0)
        self.valid = jnp.asarray(valid)

    def _spec(self, ndim: int):
        return self.ops._spec(ndim)

    def _nbr_local(self, p):
        """Neighbour sum with one-slab halos, inside shard_map."""
        ops = self.ops
        out = jnp.zeros_like(p)
        for ax, w in enumerate(self.h2inv):
            name, k = ops.axis_comm(ax)
            left = _shift_local(p, ax, name, k, fwd=True)
            right = _shift_local(p, ax, name, k, fwd=False)
            out = out + w * (left + right)
        return out

    def _scale_invd(self, d2):
        if d2 is None:
            return self.scale, self.inv_diag
        return d2, self.inv_diag / d2

    def sweep(self, phi, rhs, its: int = 1, d2=None):
        ops = self.ops
        scale, invd = self._scale_invd(d2)
        spec = self._spec(phi.ndim)
        sc_spec = P()

        def body(p, r, iv, ma, va, sc):
            for _ in range(its):
                for color_a in (False, True, False):
                    new = (r + sc * self._nbr_local(p)) * iv
                    m = ma if color_a else ~ma
                    p = jnp.where(m & va, new, p)
            return p

        return shard_map(
            body, ops.mesh,
            (spec, spec, spec, spec, spec, sc_spec), spec,
        )(phi, rhs, invd, self.mask_a, self.valid,
          jnp.asarray(scale, phi.dtype))

    def residual(self, phi, rhs, d2=None):
        """rhs - M phi on real cells (zero on pads)."""
        ops = self.ops
        scale, invd = self._scale_invd(d2)
        spec = self._spec(phi.ndim)

        def body(p, r, iv, va, sc):
            res = r - p / iv + sc * self._nbr_local(p)
            return jnp.where(va, res, 0.0)

        return shard_map(
            body, ops.mesh, (spec, spec, spec, spec, P()), spec,
        )(phi, rhs, invd, self.valid, jnp.asarray(scale, phi.dtype))

    def residual_color_a_norm(self, phi, rhs, h, d2=None):
        r = jnp.where(self.mask_a, self.residual(phi, rhs, d2=d2), 0.0)
        return jnp.sqrt(h * jnp.sum(jnp.square(r)))
