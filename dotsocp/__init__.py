"""dotsocp — JAX framework for dynamic optimal transport via SOCP.

A from-scratch JAX/XLA re-design of the capabilities of
chlhnu/DOT-SOCP (MATLAB + C++ MEX): staggered-grid Benamou-Brenier dynamic
optimal transport solved through a second-order cone reformulation with a
family of first-order primal-dual methods (PALM / inPALM / ALG2 / acc-ADMM /
sGS variants), multilevel warm starting, and weighted (obstacle) transport —
plus the parallel substrate the reference lacks: batch + spatial sharding
over a device mesh via pjit/shard_map.
"""

from .ops.geometry import Geometry
from .ops.staggered import Staggered

__version__ = "0.1.0"


def w2_distance(rho0, rho1, nt: int = 33, level_n: int = 3,
                opts: dict | None = None, method: str = "inPALM",
                dtype=None, return_solution: bool = False):
    """Convenience API: the Wasserstein-2 distance between two densities.

    Runs the multilevel dynamic-OT solve (:func:`multilevel.solve.solve_dot`
    defaults: reference demo config) and evaluates the Benamou-Brenier
    kinetic energy of the recovered (rho, E) fields
    (:func:`utils.objective.transport_cost`). ``rho0``/``rho1`` are 1-D or
    2-D arrays on the unit interval/box; they are normalized to unit mean
    (= unit mass) if they are not already. Returns W2 (not squared);
    ``return_solution=True`` additionally returns the solver output dict.

    Beyond-reference convenience — the reference exposes only the solver
    entry points and never evaluates an objective. Accuracy is the
    discretization's (BASELINE.md W2 convergence tables), provided
    ``opts['tol']`` is at or below the default 1e-4.
    """
    import math as _math

    import numpy as _np

    from .multilevel.solve import solve_dot
    from .utils.objective import transport_cost

    r0 = _np.asarray(rho0, _np.float64)
    r1 = _np.asarray(rho1, _np.float64)
    out, _, _ = solve_dot(r0 / r0.mean(), r1 / r1.mean(), nt, level_n,
                          dict(opts or {}), method, dtype=dtype,
                          verbose=False)
    Es = [out["Ex"]] if r0.ndim == 1 else [out["Ey"], out["Ex"]]
    w2 = _math.sqrt(max(transport_cost(out["rho"], Es), 0.0))
    return (w2, out) if return_solution else w2


__all__ = ["Geometry", "Staggered", "w2_distance", "__version__"]
