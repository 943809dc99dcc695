"""Problem generators for 1D and 2D DOT (the reference's ``examples/dot1d``
and ``examples/dot2d`` layers).

Array convention: densities are (ny, nx) with rows = the first spatial axis
(y) and columns = x; 1D densities are (nx,). All generators normalize to
unit mean with an optional lower bound:
rho <- (rho / mean(rho) + lb) / (1 + lb)  (``get_example.m:45-47``).

Image-based problems (example5, DOTmark stitches, arbitrary image pairs)
load from a resource directory, resolved in order: explicit argument,
``DOTSOCP_RESOURCES`` env var, the assets bundled with this package
(``dotsocp/resources/dot2d`` — byte-identical copies of the reference's
problem-data images, see ``resources/README.md``), then a reference
checkout when present. Procedural fallbacks keep every example runnable
even with no assets at all.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

_BUNDLED_RESOURCES = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "resources", "dot2d"
))


def _normalize(rho: np.ndarray, lower_bound: float = 0.0) -> np.ndarray:
    rho = np.asarray(rho, np.float64)
    return (rho / rho.mean() + lower_bound) / (1.0 + lower_bound)


# ---------------------------------------------------------------------------
# 1D (``examples/dot1d``)
# ---------------------------------------------------------------------------

def gene_example_gaussian_1d(nx: int):
    """N(0.3, 0.01) -> N(0.7, 0.0025) (``gene_example_gaussian.m``)."""
    x = np.linspace(0.0, 1.0, nx)
    s1, s2 = 0.01, 0.01 / 4.0

    def normal(mu, var):
        return math.sqrt(1.0 / var) / (2 * math.pi) * np.exp(-0.5 * (x - mu) ** 2 / var)

    return normal(0.3, s1), normal(0.7, s2)


def gene_example_box_1d(nx: int):
    """Indicator [0.1, 0.5] -> [0.85, 0.95] (``gene_example_box.m``)."""
    x = np.linspace(0.0, 1.0, nx)
    rho0 = ((x >= 0.1) & (x <= 0.5)).astype(np.float64)
    rho1 = ((x >= 0.85) & (x <= 0.95)).astype(np.float64)
    return rho0, rho1


def get_example_1d(problem: str, nx: int, lower_bound: float = 0.0):
    if problem == "gaussian":
        rho0, rho1 = gene_example_gaussian_1d(nx)
    elif problem == "box":
        rho0, rho1 = gene_example_box_1d(nx)
    else:
        raise ValueError(f"unknown 1D problem {problem!r}")
    return _normalize(rho0, lower_bound), _normalize(rho1, lower_bound)


# ---------------------------------------------------------------------------
# 2D analytic (``examples/dot2d/gene_example*.m``)
# ---------------------------------------------------------------------------

def _grid2d(nx: int, ny: int):
    """(Y, X) with Y varying along rows (ny) and X along columns (nx)."""
    y = np.linspace(0.0, 1.0, ny)[:, None]
    x = np.linspace(0.0, 1.0, nx)[None, :]
    return y, x


def _gaussian2d(nx, ny, a, b, sigma):
    y, x = _grid2d(nx, ny)
    return np.exp(-((y - a) ** 2 + (x - b) ** 2) / (2.0 * sigma**2))


def gene_example1(nx, ny):
    """Offset isotropic Gaussians swapping corners (``gene_example1.m``)."""
    mu1, mu2, sigma = 0.25, 0.75, 0.05
    y, x = _grid2d(nx, ny)

    def normal(m1, m2):
        inv = 1.0 / sigma
        return (
            math.sqrt(inv * inv)
            / (2 * math.pi)
            * np.exp(-0.5 * (inv * (y - m1) ** 2 + inv * (x - m2) ** 2))
        )

    return normal(mu1, mu2), normal(mu2, mu1)


def _four_corners(nx, ny, mu1, mu2, sigma):
    return (
        _gaussian2d(nx, ny, mu1, mu1, sigma)
        + _gaussian2d(nx, ny, mu1, mu2, sigma)
        + _gaussian2d(nx, ny, mu2, mu1, sigma)
        + _gaussian2d(nx, ny, mu2, mu2, sigma)
    )


def gene_example2(nx, ny):
    """One Gaussian -> four corner Gaussians (``gene_example2.m``)."""
    mu1 = 0.25
    mu2 = 1 - mu1
    rho0 = _gaussian2d(nx, ny, mu1, mu1, 0.1)
    rho1 = _four_corners(nx, ny, mu1, mu2, 0.05)
    return rho0, rho1


def gene_example3(nx, ny):
    """exp-exp Laplacian -> four Gaussians (``gene_example3.m``)."""
    a1, a2 = 3.0, 5.0
    mu1 = 0.25
    mu2 = 1 - mu1
    y, x = _grid2d(nx, ny)
    rho0 = np.exp(np.exp(-a1 * np.abs(y - mu1) - a2 * np.abs(x - mu1)))
    rho1 = _four_corners(nx, ny, mu1, mu2, 0.05)
    return rho0, rho1


def gene_example4(nx, ny):
    """Quartic bowl -> four Gaussians (``gene_example4.m``)."""
    y, x = _grid2d(nx, ny)
    rho0 = (y - 0.5) ** 4 + (x - 0.5) ** 4
    rho1 = _four_corners(nx, ny, 0.25, 0.75, 0.05)
    return rho0, rho1


def gene_example_circle(nx, ny):
    """Disjoint discs (``gene_exampleCircle.m``)."""
    y, x = _grid2d(nx, ny)
    rho0 = ((x - 0.25) ** 2 + (y - 0.75) ** 2 < 0.25**2).astype(np.float64)
    rho1 = ((x - 0.75) ** 2 + (y - 0.25) ** 2 < 0.25**2).astype(np.float64)
    return rho0, rho1


# The reference's frozen 30-point Dirac instance (``gene_example7.m:19-21``:
# drawn once from a disc-uniform generator and hard-coded; problem-data
# constants, reproduced exactly so cross-implementation runs solve the SAME
# problem).
_EXAMPLE7_DIRAC_X = np.array([
    0.8323, 0.5339, 0.4031, 0.6536, 0.8200, 0.4918, 0.5108, 0.6082, 0.4633,
    0.1500, 0.7227, 0.4967, 0.5318, 0.6625, 0.4309, 0.1076, 0.3052, 0.4113,
    0.4955, 0.4485, 0.5031, 0.7529, 0.4723, 0.3668, 0.4848, 0.5474, 0.3867,
    0.3192, 0.0676, 0.2382,
])
_EXAMPLE7_DIRAC_Y = np.array([
    0.4477, 0.6033, 0.4264, 0.5378, 0.8026, 0.7535, 0.3472, 0.2628, 0.4023,
    0.4676, 0.4535, 0.5105, 0.5903, 0.6705, 0.5134, 0.4471, 0.6960, 0.5068,
    0.5040, 0.5468, 0.2641, 0.1783, 0.2195, 0.3484, 0.5056, 0.3925, 0.4511,
    0.2659, 0.4157, 0.8016,
])


def gene_example7(nx, ny):
    """Center Gaussian -> the hard-coded 30-Dirac instance
    (``gene_example7.m:19-21,28-43``). Index mapping follows the reference
    exactly: the ROW index comes from diracX and the column from diracY
    (``rho1(diracXIndex, diracYIndex)``), with MATLAB's half-away-from-zero
    rounding and 1-based clamping. Deviation from the reference's conflated
    clamp (``gene_example7.m:37-39`` clamps BOTH axes with min(nx, .), and
    MATLAB silently grows the array on an out-of-range row write): the row
    index is clamped to its own axis [1, ny], so non-square grids with
    nx > ny place edge Diracs on the boundary instead of erroring. For
    square grids (every reference run) the results are identical."""
    rho0 = _gaussian2d(nx, ny, 0.5, 0.5, 0.1)
    hx, hy = 1.0 / (nx - 1), 1.0 / (ny - 1)
    ix = np.clip(np.floor(_EXAMPLE7_DIRAC_X / hx + 0.5).astype(int), 1, ny)
    iy = np.clip(np.floor(_EXAMPLE7_DIRAC_Y / hy + 0.5).astype(int), 1, nx)
    rho1 = np.zeros((ny, nx))
    rho1[ix - 1, iy - 1] = 1.0
    return rho0, rho1


# ---------------------------------------------------------------------------
# image-based problems
# ---------------------------------------------------------------------------

def _resource_dir(explicit: Optional[str] = None) -> Optional[str]:
    """Asset directory to load image examples from. ``explicit``/env value
    'procedural' forces the synthetic fallbacks regardless of what is on
    disk (used by reproducible fixtures)."""
    if explicit == "procedural":
        return None
    cands = (explicit, os.environ.get("DOTSOCP_RESOURCES"),
             _BUNDLED_RESOURCES)
    if os.environ.get("DOTSOCP_RESOURCES") == "procedural":
        cands = (explicit,)
    for cand in cands:
        if cand and os.path.isdir(cand):
            return cand
    return None


def density_source(problem: str = "DOTmark_4stitch",
                   resources: Optional[str] = None) -> str:
    """Provenance of the densities an image-based example will produce:
    the asset directory actually used, or 'procedural' for the synthetic
    fallback. Benchmarks stamp this so iteration counts are comparable
    across environments (the fallback is a *different problem* under the
    same name)."""
    res = _resource_dir(resources)
    if res is None:
        return "procedural"
    if problem == "DOTmark_4stitch":
        probe = os.path.join(res, "DOTmark", "ClassicImages", "1.png")
    elif problem == "example5":
        probe = os.path.join(res, "centaur.bmp")
    else:
        return f"assets:{res}"
    return f"assets:{res}" if os.path.isfile(probe) else "procedural"


def _load_image_gray(path: str, shape: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("L")
    img = img.resize((shape[1], shape[0]))  # PIL size = (width, height)
    return np.asarray(img, np.float64) / 255.0


def get_example_from_images(path0: str, path1: str, nx: int, ny: int,
                            invert: bool = False, lower_bound: float = 0.0):
    """Any two images as densities (``get_example_from_images.m``)."""
    rho0 = _load_image_gray(path0, (ny, nx))
    rho1 = _load_image_gray(path1, (ny, nx))
    if invert:
        rho0, rho1 = 1.0 - rho0, 1.0 - rho1
    return _normalize(rho0, lower_bound), _normalize(rho1, lower_bound)


def gene_example5(nx, ny, resources: Optional[str] = None):
    """centaur.bmp -> man.bmp, color-inverted (``gene_example5.m``);
    procedural silhouette fallback when assets are absent."""
    res = _resource_dir(resources)
    if res:
        c, m = os.path.join(res, "centaur.bmp"), os.path.join(res, "man.bmp")
        if os.path.isfile(c) and os.path.isfile(m):
            rho0 = 1.0 - _load_image_gray(c, (ny, nx))
            rho1 = 1.0 - _load_image_gray(m, (ny, nx))
            return rho0 + 1e-12, rho1 + 1e-12
    # fallback: two different blob silhouettes
    y, x = _grid2d(nx, ny)
    rho0 = (((x - 0.5) / 0.3) ** 2 + ((y - 0.45) / 0.2) ** 2 < 1).astype(np.float64)
    rho1 = (
        (((x - 0.5) / 0.12) ** 2 + ((y - 0.5) / 0.35) ** 2 < 1)
        | (((x - 0.5) / 0.3) ** 2 + ((y - 0.3) / 0.08) ** 2 < 1)
    ).astype(np.float64)
    return rho0, rho1


def gene_example_dotmark_4stitch(
    nx,
    ny,
    dotmark_type: str = "ClassicImages",
    stitch1=(1, 2, 3, 4),
    stitch2=(5, 6, 7, 8),
    resources: Optional[str] = None,
):
    """2x2 stitch of DOTmark images (``gene_example_DOTmark_4stitch.m``);
    procedural Gaussian-mixture tiles replace missing assets."""
    res = _resource_dir(resources)
    hy, hx = (ny + 1) // 2, (nx + 1) // 2

    def tile(idx, quadrant):
        if res:
            p = os.path.join(res, "DOTmark", dotmark_type, f"{idx}.png")
            if os.path.isfile(p):
                return _load_image_gray(p, (hy, hx))
        # procedural: deterministic Gaussian mixture per index
        rng = np.random.default_rng(idx)
        t = np.zeros((hy, hx))
        for _ in range(4):
            cy, cx, s = rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8), rng.uniform(0.05, 0.2)
            yy = np.linspace(0, 1, hy)[:, None]
            xx = np.linspace(0, 1, hx)[None, :]
            t += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        return t

    def stitch(indices):
        tiles = [tile(i, q) for q, i in enumerate(indices)]
        top = np.concatenate([tiles[0], tiles[1]], axis=1)
        bot = np.concatenate([tiles[2], tiles[3]], axis=1)
        full = np.concatenate([top, bot], axis=0)
        return full[:ny, :nx] + 1e-12

    return stitch(stitch1), stitch(stitch2)


# ---------------------------------------------------------------------------
# dispatch (``examples/dot2d/get_example.m``)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# 3D problems — a capability beyond the reference (the dimension-generic
# core solves (nt, nz, ny, nx) for free; cone width 2 + 4*3 = 14)
# ---------------------------------------------------------------------------

def _grid3d(nx, ny, nz):
    z = np.linspace(0.0, 1.0, nz)[:, None, None]
    y = np.linspace(0.0, 1.0, ny)[None, :, None]
    x = np.linspace(0.0, 1.0, nx)[None, None, :]
    return z, y, x


def gene_example3d_gaussian(nx, ny, nz):
    """Two offset 3D Gaussians (the 3D analogue of example1)."""
    z, y, x = _grid3d(nx, ny, nz)

    def g(c, s):
        return np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
                      / (2 * s * s))

    return g((0.3, 0.3, 0.3), 0.12), g((0.7, 0.7, 0.7), 0.12)


def gene_example3d_split8(nx, ny, nz):
    """One center Gaussian splitting into the 8 corners (3D example2)."""
    z, y, x = _grid3d(nx, ny, nz)

    def g(c, s):
        return np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
                      / (2 * s * s))

    rho0 = g((0.5, 0.5, 0.5), 0.12)
    rho1 = sum(
        g((cx, cy, cz), 0.07)
        for cx in (0.25, 0.75) for cy in (0.25, 0.75) for cz in (0.25, 0.75)
    )
    return rho0, rho1


def get_example_3d(problem: str, nx: int, ny: int, nz: int,
                   lower_bound: float = 0.0):
    gens = {"gaussian": gene_example3d_gaussian,
            "split8": gene_example3d_split8}
    if problem not in gens:
        raise ValueError(f"unknown 3D problem {problem!r}")
    rho0, rho1 = gens[problem](nx, ny, nz)
    return _normalize(rho0, lower_bound), _normalize(rho1, lower_bound)


def get_example_2d(problem: str, nx: int, ny: int, lower_bound: float = 0.0,
                   **kwargs):
    gens = {
        "example1": gene_example1,
        "example2": gene_example2,
        "example3": gene_example3,
        "example4": gene_example4,
        "example5": gene_example5,
        "example7": gene_example7,
        "circle": gene_example_circle,
    }
    if problem in gens:
        rho0, rho1 = gens[problem](nx, ny)
    elif problem == "DOTmark_4stitch":
        rho0, rho1 = gene_example_dotmark_4stitch(
            nx,
            ny,
            kwargs.get("DOTmark_type", "ClassicImages"),
            kwargs.get("stitch1_indices", (1, 2, 3, 4)),
            kwargs.get("stitch2_indices", (5, 6, 7, 8)),
            kwargs.get("resources"),
        )
    else:
        raise ValueError(f"unknown 2D problem {problem!r}")
    return _normalize(rho0, lower_bound), _normalize(rho1, lower_bound)
