"""Weighted-DOT problem layer: densities, barriers, and staggered weights
(the reference's ``examples/wdot2d``).

A barrier is a callable ``barrier(x, y) -> bool array`` over broadcastable
coordinate arrays (x horizontal in [0,1], y vertical in [0,1]). Weights live
on the staggered grid as a :class:`~dotsocp.ops.staggered.Staggered`
field whose time block is identically 1 (``get_weight_by_barrier.m:33-36``).
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from ..ops.geometry import Geometry
from ..ops.staggered import Staggered
from .examples import _grid2d, _gaussian2d, _normalize, gene_example1, \
    gene_example2, gene_example3, gene_example4, gene_example_circle

_BUNDLED_RESOURCES = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "resources", "wdot2d"
))

BARRIER_WEIGHT = 1e6  # wall weight (``get_weight_by_barrier.m:8-10``; the
# reference's barrierWeight argument is dead code — 1e6 always wins)


# ---------------------------------------------------------------------------
# densities
# ---------------------------------------------------------------------------

def _disc_density(nx, ny, center, r):
    y, x = _grid2d(nx, ny)
    return ((x - center[0]) ** 2 + (y - center[1]) ** 2 < r * r).astype(np.float64)


def gene_example_circle2(nx, ny):
    """Discs used with the rectangle obstacle (``gene_exampleCircle2.m``)."""
    scale = 40.0
    r1, r2, r3 = 5 / scale, 4 / scale, 3 / scale
    rho0 = _disc_density(nx, ny, (r1 / 2 + 0.1, 0.475), r1)
    rho1 = _disc_density(nx, ny, (r2 / 2 + 0.1, 0.95 - r2), r2) + _disc_density(
        nx, ny, (r3 / 2 + 0.1, r3 + 0.05), r3
    )
    return rho0, np.minimum(rho1, 1.0)


def _truncated_gaussian(nx, ny, center, r):
    """Gaussian truncated to a disc (``gene_example6.m`` pattern; the
    reference's (X, Y) are (row, col) coordinates, i.e. (y, x) in our
    convention)."""
    sigma = r / 3.0
    y, x = _grid2d(nx, ny)
    g = np.exp(-(((y - center[0]) ** 2) + (x - center[1]) ** 2) / (2 * sigma**2))
    g[((y - center[0]) ** 2 + (x - center[1]) ** 2) > r * r] = 0.0
    return g


def gene_example6(nx, ny):
    return (
        _truncated_gaussian(nx, ny, (0.925, 0.075), 0.09),
        _truncated_gaussian(nx, ny, (0.075, 0.925), 0.09),
    )


def gene_example_love_heart(nx, ny):
    return (
        _truncated_gaussian(nx, ny, (0.7, 0.3), 0.09),
        _truncated_gaussian(nx, ny, (0.345, 0.625), 0.09),
    )


def gene_example_maze14(nx, ny):
    """Densities for the maze of [Papadakis-Peyre-Oudet 2014]; uniform
    blobs at entrance/exit corners (procedural version)."""
    y, x = _grid2d(nx, ny)
    rho0 = np.exp(-(((x - 0.5) ** 2) + (y - 0.5) ** 2) / (2 * 0.05**2))
    rho1 = np.exp(-(((x - 0.05) ** 2) + (y - 0.05) ** 2) / (2 * 0.05**2))
    return rho0, rho1


def get_example_w2d(problem: str, nx: int, ny: int, lower_bound: float = 0.0):
    gens = {
        "example1": gene_example1,
        "example2": gene_example2,
        "example3": gene_example3,
        "example4": gene_example4,
        "circle": gene_example_circle,
        "circle2": gene_example_circle2,
        "example6": gene_example6,
        "maze14": gene_example_maze14,
        "love-heart": gene_example_love_heart,
    }
    if problem not in gens:
        raise ValueError(f"unknown weighted-2D problem {problem!r}")
    rho0, rho1 = gens[problem](nx, ny)
    return _normalize(rho0, lower_bound), _normalize(rho1, lower_bound)


# ---------------------------------------------------------------------------
# barriers (predicates over (x, y))
# ---------------------------------------------------------------------------

def barrier_circle_pillar() -> Callable:
    """Circle + two pillars (``gene_barrier_of_circle_pillar.m``)."""

    def barrier(x, y):
        x = np.asarray(x)
        y = np.asarray(y)
        return (
            ((x >= 0.2) & (x <= 0.25) & (y >= 0.4) & (y <= 1.0))
            | ((x >= 0.75) & (x <= 0.8) & (y >= 0.0) & (y <= 0.6))
            | ((x - 0.5) ** 2 + (y - 0.5) ** 2 <= 0.15**2)
        )

    return barrier


def barrier_love_heart() -> Callable:
    """Implicit heart-curve annulus (``gene_barrier_of_love_heart.m``)."""

    def heart(x, y, s):
        u = s * (np.asarray(x) - 0.5)
        v = s * (np.asarray(y) - 0.5)
        return (u * u + v * v - 1.0) ** 3 - u * u * v**3

    def barrier(x, y):
        return (heart(x, np.asarray(y) + 0.05, 2.5) > 0) | (heart(x, y, 15.0) <= 0)

    return barrier


def barrier_from_image(path: str, threshold: float = 0.5,
                       invert: bool = False) -> Callable:
    """Nearest-neighbour barrier interpolant from a maze image
    (``gene_barrier_of_maze14.m`` / ``gene_barrier_of_example6.m``)."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("L"), np.float64) / 255.0
    mask = (img < threshold) if not invert else (img > threshold)
    h, w = mask.shape

    def barrier(x, y):
        x = np.clip(np.asarray(x), 0.0, 1.0)
        y = np.clip(np.asarray(y), 0.0, 1.0)
        i = np.round(y * (h - 1)).astype(int)
        j = np.round(x * (w - 1)).astype(int)
        return mask[i, j]

    return barrier


def _maze_procedural() -> Callable:
    """Procedural labyrinth fallback when the maze PNG is unavailable:
    concentric square walls with alternating gaps."""

    def barrier(x, y):
        x = np.asarray(x)
        y = np.asarray(y)
        d = np.maximum(np.abs(x - 0.5), np.abs(y - 0.5))
        ring = ((d > 0.12) & (d < 0.15)) | ((d > 0.24) & (d < 0.27)) | (
            (d > 0.36) & (d < 0.39)
        )
        gap1 = (np.abs(y - 0.5) < 0.03) & (x > 0.5) & (d > 0.1) & (d < 0.16)
        gap2 = (np.abs(x - 0.5) < 0.03) & (y < 0.5) & (d > 0.22) & (d < 0.28)
        gap3 = (np.abs(y - 0.5) < 0.03) & (x < 0.5) & (d > 0.34) & (d < 0.40)
        return ring & ~(gap1 | gap2 | gap3)

    return barrier


def _wdot_resource_dirs(resources: Optional[str] = None):
    return (resources, os.environ.get("DOTSOCP_RESOURCES"),
            _BUNDLED_RESOURCES)


def barrier_maze14(resources: Optional[str] = None) -> Callable:
    """``gene_barrier_of_maze14.m:6`` loads maze-14.png specifically;
    prefer it (sorted() puts 'maze-14.png' before 'maze.png')."""
    for cand in _wdot_resource_dirs(resources):
        if cand and os.path.isdir(cand):
            for name in sorted(os.listdir(cand)):
                if "maze" in name.lower():
                    return barrier_from_image(os.path.join(cand, name))
    return _maze_procedural()


def barrier_example6(resources: Optional[str] = None) -> Callable:
    for cand in _wdot_resource_dirs(resources):
        if cand and os.path.isdir(cand):
            for name in sorted(os.listdir(cand)):
                if name.lower().endswith(".png") and "maze" not in name.lower():
                    return barrier_from_image(os.path.join(cand, name))
    return _maze_procedural()


def wdot_provenance(problem: str = "love-heart") -> str:
    """Provenance of the wdot2d densities/barrier for bench stamping (the
    analogue of ``examples.density_source``): the image-based barriers
    (maze14, example6) report the asset dir or 'procedural'; every other
    problem (incl. the love-heart headline) is fully analytic."""
    if problem in ("maze14", "example6"):
        for cand in _wdot_resource_dirs()[1:]:
            if cand and os.path.isdir(cand):
                return f"assets:{cand}"
        return "procedural"
    return "analytic"


# ---------------------------------------------------------------------------
# weights on the staggered grid
# ---------------------------------------------------------------------------

def _default_dtype(dtype):
    """None -> the active JAX default float (f64 under x64, else f32), so
    building weights without x64 emits no truncation warnings."""
    if dtype is not None:
        return dtype
    import jax

    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def get_weight_by_barrier(nx: int, ny: int, nt: int,
                          barrier: Optional[Callable] = None,
                          dtype=None) -> Staggered:
    """Weight 1 everywhere, BARRIER_WEIGHT on faces inside the barrier,
    evaluated on the staggered x/y grids (``get_weight_by_barrier.m:12-31``);
    the time block is identically 1."""
    dtype = _default_dtype(dtype)
    geom = Geometry(nt=nt, space=(ny, nx))
    hx, hy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    x_stag = np.linspace(0.5 * hx, 1 - 0.5 * hx, nx - 1)
    x_cent = np.linspace(0.0, 1.0, nx)
    y_stag = np.linspace(0.5 * hy, 1 - 0.5 * hy, ny - 1)
    y_cent = np.linspace(0.0, 1.0, ny)

    wx = np.ones((ny, nx - 1))
    wy = np.ones((ny - 1, nx))
    if barrier is not None:
        wx[np.asarray(barrier(x_stag[None, :], y_cent[:, None])) > 0] = BARRIER_WEIGHT
        wy[np.asarray(barrier(x_cent[None, :], y_stag[:, None])) > 0] = BARRIER_WEIGHT

    q0 = jnp.ones(geom.q0_shape, dtype)
    by = jnp.broadcast_to(jnp.asarray(wy, dtype), geom.b_shape(0)).copy()
    bx = jnp.broadcast_to(jnp.asarray(wx, dtype), geom.b_shape(1)).copy()
    return Staggered(q0=q0, bs=(by, bx))


def _radial_weight(nx, ny, nt, func, dtype=None) -> Staggered:
    dtype = _default_dtype(dtype)
    geom = Geometry(nt=nt, space=(ny, nx))
    hx, hy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    x_stag = np.linspace(0.5 * hx, 1 - 0.5 * hx, nx - 1)
    x_cent = np.linspace(0.0, 1.0, nx)
    y_stag = np.linspace(0.5 * hy, 1 - 0.5 * hy, ny - 1)
    y_cent = np.linspace(0.0, 1.0, ny)

    wx = func(x_stag[None, :], y_cent[:, None])
    wx = wx * (wx.size / wx.sum())
    wy = func(x_cent[None, :], y_stag[:, None])
    wy = wy * (wy.size / wy.sum())

    q0 = jnp.ones(geom.q0_shape, dtype)
    by = jnp.broadcast_to(jnp.asarray(wy, dtype), geom.b_shape(0)).copy()
    bx = jnp.broadcast_to(jnp.asarray(wx, dtype), geom.b_shape(1)).copy()
    return Staggered(q0=q0, bs=(by, bx))


def gene_weight_circle(nt, nx, ny, dtype=None) -> Staggered:
    """Radial distance weight, normalized to unit mean
    (``gene_weight_circle.m``)."""
    return _radial_weight(
        nx, ny, nt, lambda x, y: np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2), dtype
    )


def gene_weight_circle_inv(nt, nx, ny, dtype=None) -> Staggered:
    """Inverse radial weight (``gene_weight_circleInv.m``)."""
    return _radial_weight(
        nx, ny, nt,
        lambda x, y: 1.0 / (0.1 + np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)),
        dtype,
    )


# ---------------------------------------------------------------------------
# validity (``ensure_barrier_validity.m``, ``check_barrier_validity.m``)
# ---------------------------------------------------------------------------

def ensure_barrier_validity(rho0, rho1, barrier: Callable):
    """Zero out density inside the barrier and renormalize to unit mean."""
    rho0 = np.array(rho0, np.float64)
    rho1 = np.array(rho1, np.float64)
    ny, nx = rho0.shape
    x = np.linspace(0, 1, nx)[None, :]
    y = np.linspace(0, 1, ny)[:, None]
    m = np.asarray(barrier(x, y), np.float64)
    mask = m > m.mean()
    rho0[mask] = 0.0
    rho1[mask] = 0.0
    rho0 = rho0 / rho0.mean()
    rho1 = rho1 / rho1.mean()
    return rho0, rho1, mask


def check_barrier_validity(rho0, rho1, barrier: Callable, tol: float = 1e-4):
    """Error if mass sits on the barrier (``check_barrier_validity.m``)."""
    rho0 = np.asarray(rho0)
    ny, nx = rho0.shape
    x = np.linspace(0, 1, nx)[None, :]
    y = np.linspace(0, 1, ny)[:, None]
    mask = np.asarray(barrier(x, y)) > 0
    total = float(np.asarray(rho0)[mask].sum() + np.asarray(rho1)[mask].sum())
    if total > tol:
        raise ValueError(f"invalid (rho0, rho1, barrier): mass {total} on barrier")
    return mask
