"""Spectral solve of the space-time Neumann Laplacian via matmul-DCT.

The reference solves  D^2 * (A^T A) phi = rhs  with an FFT-based DCT
(``socp/dot2d/utils/oper_poisson3dim.m``, kernel eigenvalues in
``initialize_FFTkernel.m``: 2 (n-1)^2 (1 - cos(pi k / n)) per axis, the zero
mode pinned to 1).

Design choice: apply the DCT **as a dense matmul per axis** instead of an
FFT. All grids here have n <= ~1025 per axis, so the n x n DCT matrix is a
plain dense contraction that needs no special layout (whether a cuFFT DCT
beats it on an H100 is not measured yet: ROADMAP speed item 3). The
contractions ask for ``Precision.HIGHEST``: the default f32 matmul on a GPU
may run in TF32. The DCT-II matrix is orthogonal (norm='ortho'), so the
inverse transform is its transpose and the solve is

    phi = C^T_t C^T_y C^T_x [ (C_t C_y C_x rhs) * inv_kernel ]

with inv_kernel = 1 / (D^2 * kernel).
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import Geometry


def dct_matrix(n: int, dtype=jnp.float32) -> jax.Array:
    """Orthonormal DCT-II matrix: C[k, j] = s_k cos(pi k (2j+1) / (2n))."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    C = np.cos(np.pi * k * (2 * j + 1) / (2 * n))
    C[0] *= math.sqrt(1.0 / n)
    C[1:] *= math.sqrt(2.0 / n)
    return jnp.asarray(C, dtype=dtype)


def neumann_eigenvalues(n: int) -> np.ndarray:
    """Eigenvalues of the 1-D forward-difference normal matrix D^T D with
    Neumann ends, h = 1/(n-1): 2 (n-1)^2 (1 - cos(pi k / n))
    (``initialize_FFTkernel.m:6-8``)."""
    k = np.arange(n)
    return 2.0 * (n - 1) ** 2 * (1.0 - np.cos(np.pi * k / n))


class IrSpec(NamedTuple):
    """Config of the iterative-refinement f64 solve (``split='ir'``)."""

    coeffs: Tuple[float, ...]  # (n_a - 1)^2 per axis for the A^T A stencil
    d2: float                  # D^2 baked at build time (unit-D builds: 1)
    epsilon: Optional[float]   # Helmholtz shift; None = zero mode pinned
    steps: int                 # refinement rounds (2 reaches ~f64 grade)


class DctPoisson(NamedTuple):
    """Precomputed transform matrices + inverse kernel for one geometry."""

    mats: Tuple[jax.Array, ...]  # one orthonormal DCT matrix per array axis
    inv_kernel: jax.Array        # 1 / (D^2 * kernel), phi-shaped
    split: bool = False          # f64 transforms as split-f32 matmuls
    ir: Optional[IrSpec] = None  # f32 solve + f64-residual refinement

    def solve(self, rhs: jax.Array, scale=None) -> jax.Array:
        """phi = idctn(dctn(rhs) * inv_kernel) (``oper_poisson3dim.m:4``).

        ``scale`` multiplies the inverse kernel at use time — pass 1/D^2
        against a unit-D build so the traced level constant D never bakes
        into the executable (it fuses into the existing kernel multiply)."""
        if self.ir is not None and rhs.dtype == jnp.float64:
            return self._solve_ir(rhs, scale)
        apply = _apply_axis_split if self.split else _apply_axis
        y = rhs
        for ax, C in enumerate(self.mats):
            y = apply(C, y, ax)
        inv_k = self.inv_kernel if scale is None else self.inv_kernel * scale
        y = y * inv_k
        for ax, C in enumerate(self.mats):
            y = apply(C.T, y, ax)
        return y

    def _base32(self, r: jax.Array, scale32) -> jax.Array:
        """Plain f32 DCT solve (the IR preconditioner); mats/inv_kernel are
        f32 in IR builds."""
        y = r.astype(jnp.float32)
        for ax, C in enumerate(self.mats):
            y = _apply_axis(C, y, ax)
        y = y * (self.inv_kernel if scale32 is None
                 else self.inv_kernel * scale32)
        for ax, C in enumerate(self.mats):
            y = _apply_axis(C.T, y, ax)
        return y

    def _solve_ir(self, rhs: jax.Array, scale=None) -> jax.Array:
        """f64 solve by iterative refinement over the f32 DCT solve.

        The round-4 split-f32 DCT (``_apply_axis_split``) hit a KKT floor
        ~2e-8 * n (phi error ~3e-7 amplified by the gradient), forcing a
        true emulated-f64 phase below it. Refinement removes the floor at
        split-level cost: the f32 solve is only a preconditioner whose
        operator error is ~1e-6, and the residual

            r = rhs - (D^2/scale) * (A^T A y + P0 y)

        is computed in genuine f64 where A^T A is the per-axis Neumann
        second-difference stencil (cheap elementwise work; the matmuls
        are what make an f64 solve expensive) and
        P0 y = mean(y) accounts for the pinned zero mode
        (``initialize_FFTkernel.m:15``: kernel(1) = 1, so the solve's
        operator is D^2 (A^T A + u u^T) with u the normalized constant).
        Each round contracts the error by the f32 solve's operator error;
        ``steps=2`` lands at the f64 rounding floor (measured ~1e-13
        relative phi error, tests/test_ops.py::test_ir_dct_precision).
        """
        spec = self.ir
        dtype = rhs.dtype
        scale32 = None if scale is None else jnp.asarray(scale, jnp.float32)
        inv_scale = (spec.d2 if scale is None
                     else spec.d2 / jnp.asarray(scale, dtype))
        y = self._base32(rhs, scale32).astype(dtype)
        for _ in range(spec.steps):
            ay = neumann_ata_apply(y, spec.coeffs)
            ay = ay + (spec.epsilon * y if spec.epsilon is not None
                       else jnp.mean(y))
            r = rhs - inv_scale * ay
            y = y + self._base32(r, scale32).astype(dtype)
        return y


def neumann_ata_apply(y: jax.Array, coeffs: Tuple[float, ...]) -> jax.Array:
    """A^T A y: sum over axes of (n_a-1)^2 * (D^T D y)_a with forward
    differences and Neumann ends — row 0: y0-y1, interior: -y[i-1]+2y[i]
    -y[i+1], row n-1: y[n-1]-y[n-2]. Eigenvalues match
    ``neumann_eigenvalues`` (2 (n-1)^2 (1 - cos(pi k / n)) per axis)."""
    out = None
    for ax, c in enumerate(coeffs):
        d = jnp.diff(y, axis=ax)
        pad_lo = [(0, 0)] * y.ndim
        pad_lo[ax] = (1, 0)
        pad_hi = [(0, 0)] * y.ndim
        pad_hi[ax] = (0, 1)
        term = jnp.asarray(c, y.dtype) * (jnp.pad(d, pad_lo)
                                          - jnp.pad(d, pad_hi))
        out = term if out is None else out + term
    return out


def _apply_axis(M: jax.Array, x: jax.Array, axis: int) -> jax.Array:
    """Contract M over ``axis`` of x, keeping the axis in place (a matmul).

    Written so no explicit transpose is materialized: leading axes become
    dot_general batch dimensions and trailing axes fold into the matmul's
    free dimension, so no transform pays a full relayout."""
    nd = x.ndim
    prec = jax.lax.Precision.HIGHEST
    if axis == nd - 1:
        # x @ M^T over the minor axis
        return jax.lax.dot_general(
            x, M, (((nd - 1,), (1,)), ((), ())), precision=prec
        )
    if axis == 0:
        # M @ x over the major axis: fold trailing axes into one
        shape = x.shape
        y = jax.lax.dot_general(
            M, x.reshape(shape[0], -1), (((1,), (0,)), ((), ())),
            precision=prec,
        )
        return y.reshape((M.shape[0],) + shape[1:])
    # middle axis: the contraction needs a relayout either way; the
    # tensordot+moveaxis form compiles well (a reshape-free dot_general
    # variant made the 513^2 XLA compile very slow)
    y = jnp.tensordot(M, x, axes=[[1], [axis]], precision=prec)
    return jnp.moveaxis(y, 0, axis)


def _apply_axis_split(M: jax.Array, x: jax.Array, axis: int,
                      chunk: int = 128) -> jax.Array:
    """f64 contraction executed as split-f32 matmuls.

    For devices whose f64 matmuls are much slower than f32 ones.
    Double-word decomposition M = Mh + Ml,
    x = xh + xl (f32 halves) gives

        M @ x ~= (Mh @ xh) + (Mh @ xl + Ml @ xh)        [f64 accumulation]

    The correction terms are ~2^-24 relative, so their f32 rounding is
    ~2^-48. The dominant term's own f32 accumulation error (~sqrt(n) ulp)
    is cut by chunking the contraction axis into ``chunk``-wide partial
    matmuls accumulated in f64: relative error ~sqrt(chunk) * 2^-24 ~
    7e-7 -> measured phi solve agrees with the true f64 solve to ~1e-9
    relative (tests/test_ops.py::test_split_dct_precision). Cost ~3x the
    f32 solve.
    """
    if x.dtype not in (jnp.float64,):
        return _apply_axis(M, x, axis)
    f32 = jnp.float32
    Mh = M.astype(f32)
    Ml = (M - Mh.astype(M.dtype)).astype(f32)
    xh = x.astype(f32)
    xl = (x - xh.astype(x.dtype)).astype(f32)
    # correction terms (unchunked f32 is plenty for ~2^-24-sized terms)
    y = (_apply_axis(Mh, xl, axis).astype(x.dtype)
         + _apply_axis(Ml, xh, axis).astype(x.dtype))
    n = M.shape[1]
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        Mc = jax.lax.slice_in_dim(Mh, c0, c1, axis=1)
        xc = jax.lax.slice_in_dim(xh, c0, c1, axis=axis)
        y = y + _apply_axis(Mc, xc, axis).astype(x.dtype)
    return y


def make_dct_poisson(geom: Geometry, D=1.0, epsilon=None, dtype=jnp.float32,
                     split=False, ir_steps: int = 2) -> DctPoisson:
    """Build the solver for  D^2 * (A^T A + epsilon I) phi = rhs.

    epsilon=None pins the zero mode's kernel entry to 1 (pure Neumann
    Poisson, matching ``initialize_FFTkernel.m:15``); otherwise the
    Helmholtz shift is added (``initialize_FFTkernel.m:17-22``).

    ``split`` selects the f64 strategy: False = plain f64
    matmuls, True = double-word split-f32 matmuls (~1e-9 phi error),
    "ir" = f32 transforms + f64-residual iterative refinement (~f64-grade,
    no accuracy floor — the mats/inv_kernel are then built in f32);
    "ir1" = the same with a single refinement round (one f32 solve
    cheaper per application, phi error ~the split path's).
    """
    use_ir = split in ("ir", "ir1")
    if split == "ir1":
        ir_steps = 1
    ns = (geom.nt,) + geom.space
    lam = [neumann_eigenvalues(n) for n in ns]
    kernel = np.zeros(ns)
    for ax, l in enumerate(lam):
        shape = [1] * len(ns)
        shape[ax] = ns[ax]
        kernel = kernel + l.reshape(shape)
    if epsilon is None:
        kernel.flat[0] = 1.0  # zero mode: pass-through (pinned)
    else:
        kernel = kernel + epsilon
    mat_dtype = jnp.float32 if use_ir else dtype
    inv_kernel = jnp.asarray(1.0 / (float(D) ** 2 * kernel), dtype=mat_dtype)
    mats = tuple(dct_matrix(n, mat_dtype) for n in ns)
    ir = None
    if use_ir:
        ir = IrSpec(
            coeffs=tuple(float((n - 1) ** 2) for n in ns),
            d2=float(D) ** 2,
            epsilon=None if epsilon is None else float(epsilon),
            steps=int(ir_steps),
        )
    return DctPoisson(mats=mats, inv_kernel=inv_kernel,
                      split=bool(split) and not use_ir, ir=ir)
