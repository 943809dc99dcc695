"""Space-time grid geometry for the staggered DOT discretization.

The reference (chlhnu/DOT-SOCP) hard-codes three problem families
(``socp/dot1d``, ``socp/dot2d``, ``socp/wdot2d``) with MATLAB column-major
flat vectors and explicit ``qInd`` offsets (``socp/dot2d/utils/initialize.m:17-25``).
Here a single dimension-polymorphic :class:`Geometry` carries the grid sizes
and spacings; fields live in shaped arrays instead of flat vectors:

- centered field phi:        ``(nt, *space)``        e.g. ``(nt, ny, nx)``
- time-staggered block q0:   ``(nt-1, *space)``
- face-staggered block b[a]: ``(nt, ..., n_a - 1, ...)`` (one per spatial axis)
- cone matrix z:             ``(C, nt-1, *space)`` with ``C = 2 + 4*d``

Layout rationale: the large spatial axes go last (contiguous in memory), so
element-wise ops and the per-axis DCT matmuls stream long rows, while the
small time axis leads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static description of the space-time grid.

    ``space`` follows the reference's index order with time moved to the
    front: 2D space is ``(ny, nx)`` (y fastest in the reference's
    column-major layout), 1D space is ``(nx,)``.
    """

    nt: int
    space: Tuple[int, ...]

    # ---- derived sizes -------------------------------------------------
    @property
    def ndim_space(self) -> int:
        return len(self.space)

    @property
    def cone_cols(self) -> int:
        """Columns of the per-cell cone matrix: 2 head/tail + 4 per axis.

        Matches the reference widths: 10 in 2D (``socp/dot2d/utils/initialize.m:54``),
        6 in 1D (``socp/dot1d/utils/initialize.m:47``).
        """
        return 2 + 4 * self.ndim_space

    @property
    def n_centered(self) -> int:
        return self.nt * math.prod(self.space)

    @property
    def n_cells(self) -> int:
        return (self.nt - 1) * math.prod(self.space)

    # ---- spacings ------------------------------------------------------
    @property
    def ht(self) -> float:
        return 1.0 / (self.nt - 1)

    def hs(self, axis: int) -> float:
        return 1.0 / (self.space[axis] - 1)

    @property
    def h(self) -> float:
        """Normalization used by all L2 norms: 1 / #phi-gridpoints
        (``solver_socp_inPALM.m:84``)."""
        return 1.0 / self.n_centered

    @property
    def h_mean(self) -> float:
        """Scaling mean step: h^(1/3) in 2D (``solver_dotsocp2d.m:306``),
        h^(1/2) in 1D (``solver_dotsocp1d.m:265``)."""
        return self.h ** (1.0 / (1 + self.ndim_space))

    # ---- shapes --------------------------------------------------------
    @property
    def phi_shape(self) -> Tuple[int, ...]:
        return (self.nt,) + self.space

    @property
    def q0_shape(self) -> Tuple[int, ...]:
        return (self.nt - 1,) + self.space

    def b_shape(self, axis: int) -> Tuple[int, ...]:
        sp = list(self.space)
        sp[axis] -= 1
        return (self.nt,) + tuple(sp)

    @property
    def z_shape(self) -> Tuple[int, ...]:
        return (self.cone_cols,) + self.q0_shape

    # ---- multilevel ----------------------------------------------------
    def coarse(self) -> "Geometry":
        """Geometry one level coarser: n -> (n-1)/2 + 1 on every axis
        (``solver_dotsocp2d.m:167``)."""
        return Geometry(
            nt=(self.nt - 1) // 2 + 1,
            space=tuple((n - 1) // 2 + 1 for n in self.space),
        )

    def fine(self) -> "Geometry":
        """Geometry one level finer: n -> 2*(n-1) + 1 on every axis."""
        return Geometry(
            nt=2 * (self.nt - 1) + 1,
            space=tuple(2 * (n - 1) + 1 for n in self.space),
        )
