"""Batched-instance solver: many independent transport problems on one
shared geometry, advanced in lockstep by a single device loop (the
data-parallel axis of BASELINE.md; absent from the reference).

Design: the KKT-check cadence is data-independent (``IfAdjustSigma``
depends only on iteration counters, and lastSigmaIt updates at every
cadence point regardless of whether sigma changed), so all instances share
one schedule and the loop stays scalar-predicated — no per-instance
branching. Everything data-dependent is expressed branch-free:

- sigma updates: per-instance factors, factor = 1 is the identity;
- dynamic rescaling: per-instance (d2, c2), (1, 1) is the identity, and
  triggers are evaluated at check points (alignment to the cadence is the
  one documented deviation from the single-instance trajectory);
- convergence: converged instances freeze via a select, the loop runs
  until all are done.

Combined with spatial sharding (:mod:`.sharding`) the batch axis maps onto
the mesh's ``batch`` dimension for fleet-style solves.
"""
from __future__ import annotations

import math
import time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..algorithms.core import Kernels, LevelConfig, SolverState
from ..algorithms.driver import SolveOptions
from ..algorithms.device_driver import (
    _cadence_gap,
    _next_check_it,
    _table_factor,
    SIGMA_BOUNDS,
)
from ..multilevel.level import initialize, initial_scaling
from ..ops.geometry import Geometry
from ..utils.norms import norm_l2


class BatchLoopState(NamedTuple):
    s: SolverState            # batched on every leaf (leading B)
    it: jax.Array             # shared iteration counter
    last_sigma_it: jax.Array  # shared cadence anchor
    use_feas_org: jax.Array   # (B,) bool
    stage: jax.Array          # (B,) i32
    max_feas: jax.Array       # (B,) f32
    rel_gap: jax.Array        # (B,) f32
    done: jax.Array           # (B,) bool
    done_it: jax.Array        # (B,) i32 iteration at which each converged
    kkt_last: jax.Array       # (B, 7) latest KKT residuals


def _tree_where(pred, a, b):
    """Per-instance select: pred (B,) broadcast over leading axis."""
    def sel(x, y):
        p = pred.reshape((pred.shape[0],) + (1,) * (x.ndim - 1))
        return jnp.where(p, x, y)

    return jax.tree.map(sel, a, b)


def _has_spatial_axes(mesh) -> bool:
    """True when the mesh actually decomposes the grid: a spatial axis
    (z/y/x/t) of size > 1. Keying on names alone would flip the layout
    for make_mesh()'s default ('batch','y','x') even when y = x = 1 —
    dropping the fused flat path for size-1 no-op constraints."""
    return any(
        a in mesh.axis_names and mesh.shape[a] > 1
        for a in ("z", "y", "x", "t")
    )


class BatchedDeviceDriver:
    """Lockstep batched solve of B instances (one level)."""

    FIRST_ITER = 10
    SECOND_ITER = 50
    RATIO_THRESHOLD = 1.2

    def __init__(self, kernels: Kernels, opts: SolveOptions,
                 chunk_iters: int = 600, mesh=None):
        """``mesh`` (optional): a mesh whose ``batch`` axis carries the
        instances and whose spatial axes (y/x/t) domain-decompose every
        instance's grid — the BASELINE.json scale config ("sharded over a
        pod slice + batched independent instances") as ONE device loop.
        Requires the shaped ("3d") kernel layout; shardings are annotated
        with in-jit constraints (odd 2^k+1 grids pad internally under
        GSPMD, parallel/sharding.constrain)."""
        self.k = kernels
        self.opts = opts
        self.chunk_iters = chunk_iters
        self.mesh = mesh
        self._sh = None
        if mesh is not None and _has_spatial_axes(mesh):
            if kernels.cfg.layout != "3d":
                raise ValueError(
                    "combined batch x spatial sharding needs layout='3d' "
                    f"kernels (got {kernels.cfg.layout!r}: the flat layout "
                    "folds the spatial axes away)"
                )
            from .sharding import state_shardings

            self._sh = state_shardings(
                mesh, batched=True, carry_z2=getattr(kernels, "carry_z2",
                                                     False),
                ndim_space=kernels.geom.ndim_space,
            )
        self._chunk = self._build_chunk()

    def _constrain(self, s):
        if self._sh is None:
            return s
        from .sharding import constrain

        return constrain(s, self._sh)

    def _build_chunk(self):
        k = self.k
        opts = self.opts
        tol = opts.tol
        maxit = opts.maxit
        stop_idx = (
            jnp.array([0, 2, 5, 6]) if opts.check_prim_dual_feas
            else jnp.array([0, 2, 5])
        )
        vstep = jax.vmap(k._step)
        vkkt = jax.vmap(k._kkt)
        vnorms = jax.vmap(k._norms)
        vsigma = jax.vmap(k._sigma_mult)
        vrescale = jax.vmap(k._rescale)

        def check_block(ls: BatchLoopState) -> BatchLoopState:
            res = vkkt(ls.s)
            kkt_org = res["kkt_org"]          # (B, 7)
            kkt5 = res["kkt"]                  # (B, 5)
            pd_gap = res["pdGap"]              # (B,)

            newly_done = jnp.max(kkt_org[:, stop_idx], axis=1) < tol
            done = ls.done | newly_done
            done_it = jnp.where(ls.done, ls.done_it, jnp.where(newly_done, ls.it, -1))
            use_org = ls.use_feas_org | (jnp.max(kkt5, axis=1) < 5.0 * tol)

            # per-instance sigma factor (1 where done or no table hit)
            pri = jnp.where(
                use_org,
                jnp.maximum(kkt_org[:, 0], kkt_org[:, 1]),
                jnp.maximum(kkt5[:, 0], kkt5[:, 1]),
            )
            dua = jnp.where(
                use_org,
                jnp.maximum(kkt_org[:, 2], kkt_org[:, 4]),
                jnp.maximum(kkt5[:, 2], kkt5[:, 4]),
            )
            factor = _table_factor(pri / jnp.maximum(dua, 1e-30))
            sigma = ls.s.sigma
            sigma_new = jnp.clip(sigma * factor, SIGMA_BOUNDS[0], SIGMA_BOUNDS[1])
            factor = jnp.where(done, 1.0, sigma_new / sigma).astype(sigma.dtype)
            s = vsigma(ls.s, factor)

            # rescale (aligned to the check cadence), identity via (1, 1)
            norms = vnorms(s)
            norm_phis = jnp.maximum(
                jnp.maximum(norms["normPhi"], norms["normQ"]), norms["normZ"]
            )
            norm_alps = jnp.maximum(norms["normAlpha"], norms["normBeta"])
            ratio = jnp.maximum(norm_alps, norm_phis) / jnp.maximum(
                jnp.minimum(norm_alps, norm_phis), 1e-30
            )
            it1 = ls.it + 1
            t1 = (
                (ls.stage == 1) & (ls.max_feas < 2e-2) & (ls.rel_gap < 5e-2)
                & (it1 >= self.FIRST_ITER)
            )
            t2 = (
                (ls.stage == 2) & (ls.max_feas < 5e-3) & (ls.rel_gap < 1e-2)
                & (it1 >= self.SECOND_ITER)
            )
            t3 = (ls.stage >= 3) & (ratio > self.RATIO_THRESHOLD)
            trigger = (t1 | t2 | t3) & ~done
            one = jnp.ones_like(norm_phis)
            d2 = jnp.where(trigger, norm_phis, one)
            c2 = jnp.where(trigger, norm_alps, one)
            s = vrescale(s, d2, c2)
            stage = jnp.where(trigger, ls.stage + 1, ls.stage)

            max_feas = jnp.where(
                ls.stage > 0, jnp.max(kkt5, axis=1), ls.max_feas
            ).astype(ls.max_feas.dtype)
            rel_gap = jnp.where(ls.stage > 0, pd_gap, ls.rel_gap).astype(
                ls.rel_gap.dtype
            )
            return ls._replace(
                s=s,
                last_sigma_it=ls.it,
                use_feas_org=use_org,
                stage=stage,
                max_feas=max_feas,
                rel_gap=rel_gap,
                done=done,
                done_it=done_it,
                kkt_last=kkt_org.astype(ls.kkt_last.dtype),
            )

        def one_iter(_, ls: BatchLoopState) -> BatchLoopState:
            s_new = self._constrain(vstep(ls.s))
            s = _tree_where(ls.done, ls.s, s_new)  # freeze converged
            return ls._replace(s=s, it=ls.it + 1)

        def run_to(ls: BatchLoopState, n) -> BatchLoopState:
            return jax.lax.fori_loop(0, n, one_iter, ls)

        def body(carry):
            """Event-driven segment: the KKT cadence is data-independent
            (shared across instances), so the body runs an event-free
            fori segment to the next cadence point and checks once —
            the same trick as the single-instance device driver."""
            ls, it_end = carry
            stop = jnp.minimum(
                _next_check_it(ls.it, ls.last_sigma_it),
                jnp.minimum(it_end, maxit),
            )
            ls = run_to(ls, jnp.maximum(stop - ls.it, 0))
            at_check = ((ls.it - ls.last_sigma_it) >= _cadence_gap(ls.it)) | (
                ls.it >= maxit
            )
            ls = jax.lax.cond(at_check, check_block, lambda x: x, ls)
            return ls, it_end

        @jax.jit
        def chunk(ls: BatchLoopState, it_end) -> BatchLoopState:
            ls = ls._replace(s=self._constrain(ls.s))

            def cond(carry):
                ls, end = carry
                return (~jnp.all(ls.done)) & (ls.it < end)

            ls, _ = jax.lax.while_loop(cond, body, (ls, it_end))
            return ls

        return chunk

    def solve(self, bstate: SolverState):
        """Run to convergence of all instances (or maxit / time limit)."""
        B = bstate.sigma.shape[0]
        ls = BatchLoopState(
            s=bstate,
            it=jnp.zeros((), jnp.int32),
            last_sigma_it=jnp.full((), -(10**9), jnp.int32),
            use_feas_org=jnp.zeros((B,), bool),
            stage=jnp.full((B,), 1 if self.opts.scaling else 0, jnp.int32),
            max_feas=jnp.full((B,), jnp.inf, jnp.float32),
            rel_gap=jnp.full((B,), jnp.inf, jnp.float32),
            done=jnp.zeros((B,), bool),
            done_it=jnp.full((B,), -1, jnp.int32),
            kkt_last=jnp.full((B, 7), jnp.inf, jnp.float32),
        )
        t0 = time.monotonic()
        while True:
            it = int(jax.device_get(ls.it))
            if it >= self.opts.maxit or bool(jax.device_get(jnp.all(ls.done))):
                break
            if time.monotonic() - t0 > self.opts.time_limit:
                break
            it_end = min(it + self.chunk_iters, self.opts.maxit)
            ls = self._chunk(ls, jnp.asarray(it_end, jnp.int32))
        return ls, time.monotonic() - t0


def solve_batch(rho0s, rho1s, nt: int, opts: Optional[dict] = None,
                method: str = "inPALM", dtype=jnp.float32,
                mesh=None, level_n: int = 1, verbose: bool = True):
    """Multilevel batched solve of B same-shaped instances.

    rho0s/rho1s: (B, *space). Returns dict with batched rho, per-instance
    iterations and final KKT residuals. When ``mesh`` is given, the state
    is sharded (batch + spatial axes) before the loop so the whole fleet
    runs SPMD across devices. Deviations from the single-instance
    multilevel driver (documented): rescales align to the check cadence
    and the E2 inter-level feedback uses the batch-first instance.
    """
    from ..algorithms.variants import InPALMKernels, PALMKernels
    from ..multilevel.level import recover_org_var, recover_rho_e
    from ..multilevel.transfer import restrict_density
    from ..multilevel.solve import _jump_next_level

    opts = dict(opts or {})
    rho0s = jnp.asarray(rho0s, dtype)
    rho1s = jnp.asarray(rho1s, dtype)
    B = rho0s.shape[0]

    tol = float(opts.get("tol", 1e-4))
    tol_factor = -1.0 if tol > 0.99e-3 else -0.5
    tol_lower = 1e-5 if rho0s.ndim == 2 else 1e-4

    # coarse pyramid (shared geometry; per-instance densities)
    r0s = [rho0s]
    r1s = [rho1s]
    nts = [nt]
    tols = [tol]
    vrestrict = jax.vmap(restrict_density)
    for _ in range(level_n - 1):
        r0c = vrestrict(r0s[0])
        r1c = vrestrict(r1s[0])
        r0s.insert(0, r0c / r0c.mean(axis=tuple(range(1, r0c.ndim)), keepdims=True))
        r1s.insert(0, r1c / r1c.mean(axis=tuple(range(1, r1c.ndim)), keepdims=True))
        nts.insert(0, (nts[0] - 1) // 2 + 1)
        tols.insert(0, max(tols[0] * 2.0 ** tol_factor, tol_lower))

    kcls = PALMKernels if method == "PALM" else InPALMKernels
    sigma_b = np.full(B, float(opts.get("sigma", 1.0)))
    prev_lvs = None
    total_time = 0.0
    total_iters = 0
    ls = None
    kernels = None
    lvs = None

    for lev in range(level_n):
        o = SolveOptions(
            tol=tols[lev],
            maxit=int(opts.get("maxit", 3000)),
            sigma=1.0,  # per-instance sigma applied in prep below
            tau=1.9 if method in ("inPALM", "PALM") else 1.0,
            time_limit=float(opts.get("time_limit", 3600.0)),
            scaling=bool(opts.get("scaling", True)),
        )
        states = []
        lvs = []
        kernels = None
        for b in range(B):
            if prev_lvs is None:
                lv = initialize(np.asarray(r0s[lev][b]), np.asarray(r1s[lev][b]),
                                nts[lev], dtype=dtype)
            else:
                lv = _jump_next_level(
                    prev_lvs[b], r0s[lev][b], r1s[lev][b], nts[lev], dtype
                )
            initial_scaling(lv, scaling=o.scaling)
            if kernels is None:
                # a mesh with real spatial axes (size > 1) = combined
                # dp x spatial decomposition (BASELINE.json scale
                # config): needs the shaped layout so y/x constraints
                # can bind; batch-only meshes keep the flat layout
                spatial_mesh = mesh is not None and _has_spatial_axes(mesh)
                layout = str(opts.get(
                    "layout", "3d" if spatial_mesh else "flat"
                ))
                cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=o.tau,
                                  dtype=dtype, layout=layout, mesh=mesh)
                kernels = kcls(cfg)
            states.append(kernels.prep(lv.as_dict(), float(sigma_b[b])))
            lvs.append(lv)

        bstate = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
        if mesh is not None:
            # boundary sharding over the batch axis only (the odd 2^k+1
            # spatial dims cannot shard at the jit boundary; spatial
            # decomposition uses in-jit constraints, see parallel/sharding)
            from jax.sharding import NamedSharding, PartitionSpec as P

            def sh_batch(x):
                spec = P("batch", *([None] * (x.ndim - 1)))
                return jax.device_put(x, NamedSharding(mesh, spec))

            bstate = jax.tree.map(
                lambda x: sh_batch(x) if x.ndim >= 1 and x.shape[0] == B else x,
                bstate,
            )

        driver = BatchedDeviceDriver(kernels, o, mesh=mesh)
        ls, elapsed = driver.solve(bstate)
        total_time += elapsed
        total_iters += int(jax.device_get(ls.it))

        # write back per-instance results and prepare the next level
        out_states = ls.s
        sig = np.asarray(jax.device_get(out_states.sigma))
        sig_scale = np.asarray(jax.device_get(out_states.sigmaScale))
        for b in range(B):
            st = jax.tree.map(lambda x: x[b], out_states)
            var = kernels.finalize(st, lvs[b].as_dict())
            recover_org_var(lvs[b], var)
        if lev < level_n - 1:
            sigma_out = sig / np.maximum(sig_scale, 1e-300)
            sigma_b = 10.0 ** (np.log10(np.maximum(sigma_b * sigma_out, 1e-300)) / 2.0)
            prev_lvs = lvs

    kkt = np.asarray(jax.device_get(ls.kkt_last))
    done = np.asarray(jax.device_get(ls.done))
    done_it = np.asarray(jax.device_get(ls.done_it))
    rhos = []
    for b in range(B):
        rho, _ = recover_rho_e(lvs[b])
        rhos.append(rho)
    if verbose:
        print(
            f"batch solve: B={B}, levels={level_n}, all_done={bool(done.all())}, "
            f"iters={total_iters}, {total_time:.2f}s"
        )
    return {
        "rho": jnp.stack(rhos),
        "done": done,
        "done_it": done_it,
        "kkt": kkt,
        "iters": total_iters,
        "time": total_time,
    }


# Instances at or above this many time-staggered cells are taken to
# saturate one device, so the fleet runs them one after another; below it
# the batched step amortizes dispatch. Not measured on an H100: ROADMAP
# speed item 2 / reach workload 1 re-derive the threshold there.
# (129^2 x 33, the headline config, has ~0.5M cells.)
_SATURATION_CELLS = 100_000


def pick_fleet_mode(B: int, space, nt: int, n_devices: int) -> str:
    """The BASELINE.md fleet decision table as code:

    - 2+ devices: shard the batch axis over the mesh ('sharded') — fleet
      wall time is the slowest instance, per-device work is ~one instance;
    - one device, instance saturates the chip: 'sequential' via the cached
      device driver (solver executables are shape-only, so instance 2+
      pays zero compile);
    - one device, sub-saturation instances: 'lockstep' (the batched step
      amortizes dispatch across the fleet).
    """
    if n_devices >= 2 and math.gcd(B, n_devices) >= 2:
        # the lockstep batch axis must divide the mesh (odd leftovers
        # would force uneven boundary shardings)
        return "sharded"
    cells = (nt - 1) * int(np.prod(space))
    return "sequential" if cells >= _SATURATION_CELLS else "lockstep"


def solve_fleet(rho0s, rho1s, nt: int, opts: Optional[dict] = None,
                method: str = "inPALM", dtype=jnp.float32,
                level_n: int = 1, mode: str = "auto", mesh=None,
                verbose: bool = True):
    """Solve a fleet of B independent same-shaped DOT instances, picking
    the execution mode automatically (``mode='auto'``) from problem size
    and device count — the ergonomic front door to the batch axis.

    Modes: 'sequential' (cached single-instance device driver, one chip,
    saturating sizes), 'lockstep' (one batched device loop,
    :func:`solve_batch`), 'sharded' (lockstep + batch axis sharded over a
    device mesh). Returns the :func:`solve_batch` result dict plus
    ``mode``; sequential results carry per-instance iteration counts in
    ``done_it`` and the final-level KKT rows in ``kkt``.
    """
    rho0s = np.asarray(rho0s)
    B = rho0s.shape[0]
    space = rho0s.shape[1:]
    if mode == "auto":
        n_dev = len(mesh.devices.flat) if mesh is not None else len(jax.devices())
        mode = pick_fleet_mode(B, space, nt, n_dev)
    if verbose:
        print(f"solve_fleet: B={B}, mode={mode}")
    if mode == "sharded":
        if mesh is None:
            from .sharding import make_mesh

            # mesh size must divide B: use the largest common factor
            n_dev = math.gcd(B, len(jax.devices()))
            mesh = make_mesh(n_dev, axis_names=("batch",))
        return dict(
            solve_batch(rho0s, rho1s, nt, opts, method, dtype=dtype,
                        mesh=mesh, level_n=level_n, verbose=verbose),
            mode="sharded",
        )
    if mode == "lockstep":
        return dict(
            solve_batch(rho0s, rho1s, nt, opts, method, dtype=dtype,
                        level_n=level_n, verbose=verbose),
            mode="lockstep",
        )
    if mode != "sequential":
        raise ValueError(f"unknown fleet mode {mode!r}")
    from ..multilevel.solve import solve_dot

    opts = dict(opts or {})
    rhos, kkts, done_it, done = [], [], [], []
    total_time = 0.0
    total_iters = 0
    for b in range(B):
        o, _, h = solve_dot(
            rho0s[b], np.asarray(rho1s)[b], nt, level_n,
            dict(opts, driver=opts.get("driver", "device"),
                 prewarm=b == 0 and bool(opts.get("prewarm", True))),
            method, dtype=dtype, verbose=False,
        )
        rhos.append(o["rho"])
        k = np.asarray(h["kkt"][-1])
        kkts.append(k)
        tol = float(opts.get("tol", 1e-4))
        done.append(bool(np.max(k[[0, 2, 5, 6]]) < tol))
        done_it.append(o["levels"][-1]["iters"])
        total_iters += sum(l["iters"] for l in o["levels"])
        total_time += o["total_time"]
    return {
        "rho": jnp.stack(rhos),
        "done": np.asarray(done),
        "done_it": np.asarray(done_it),
        "kkt": np.stack(kkts),
        "iters": total_iters,
        "time": total_time,
        "mode": "sequential",
    }
