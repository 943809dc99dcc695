"""Device-resident solver driver: the whole per-level loop — iteration,
KKT cadence, sigma-update table, dynamic-rescale state machine, stopping
rule, history recording — compiled into one ``lax.while_loop``.

Motivation: a host round-trip per KKT check costs more than the iterations
between checks at small grids, so the host-orchestrated driver
(:mod:`.driver`, kept as the readable reference implementation and for
step-by-step debugging) is dispatch-bound. Here the host dispatches one
``chunk`` per ~hundreds of iterations and reads back only a 'done' flag and
the history buffer. The decision logic is the same as the reference's
(``solver_socp_inPALM.m``): tables and cadences are encoded as static
arrays + integer arithmetic.

Covers the inPALM family (inPALM / ALG2 / PALM) and acc-ADMM; the sGS
variants keep the host driver (their win-count strategy reads per-iteration
history that is naturally host-side).
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .core import Kernels, SolverState
from .driver import (
    RunHistory,
    SolveOptions,
    UPDATE_RULE,
    SIGMA_BOUNDS,
)

# cadence thresholds (``solver_socp_inPALM.m:361-379``)
_CADENCE_EDGES = jnp.array([20, 50, 100, 200, 500], jnp.int32)
_CADENCE_GAPS = jnp.array([3, 6, 10, 15, 25, 40], jnp.int32)
# sGS cadence (``solver_socp_sGSinPALM.m:431-456``), applied on it/scale
_CADENCE_GAPS_SGS = jnp.array([5, 10, 20, 35, 50, 100], jnp.int32)

_RULE_XI = jnp.array([r[0] for r in UPDATE_RULE], jnp.float32)
_RULE_F = jnp.array([r[1] for r in UPDATE_RULE], jnp.float32)


def _cadence_gap(it):
    idx = jnp.sum(it >= _CADENCE_EDGES)
    return _CADENCE_GAPS[idx]


def _next_check_it(it, last):
    """Closed-form next cadence point > it (device version of
    ``driver.next_check_iter``): for each threshold region [lo, hi) with
    gap t, the candidate is max(it+1, last+t, lo), valid when < hi; the
    answer is the min over valid candidates.

    Loop bodies run event-free fori segments between the points this
    computes instead of a per-iteration lax.cond (shared by the
    single-instance and batched drivers)."""
    lo = jnp.concatenate([jnp.zeros((1,), jnp.int32), _CADENCE_EDGES])
    hi = jnp.concatenate([_CADENCE_EDGES, jnp.full((1,), 2**30, jnp.int32)])
    cand = jnp.maximum(jnp.maximum(it + 1, last + _CADENCE_GAPS), lo)
    valid = cand < hi
    return jnp.min(jnp.where(valid, cand, 2**30))


def _cadence_check_sgs(it, last, scale: float):
    """IfAdjustSigma of the sGS variants with the n^(1/3)/33 slowdown."""
    it_s = it.astype(jnp.float32) / scale
    passed = (it - last).astype(jnp.float32) / scale
    idx = jnp.sum(it_s >= _CADENCE_EDGES.astype(jnp.float32))
    return passed >= _CADENCE_GAPS_SGS[idx].astype(jnp.float32)


def _table_factor(xi):
    """get_factor of ``adjust_lagrangianParam.m`` as a vectorized lookup
    (works on scalars and per-instance batches)."""
    xi = jnp.asarray(xi, jnp.float32)

    def pos(x):
        idx = jnp.sum(x[..., None] >= _RULE_XI, axis=-1)  # 0 -> no rule hit
        return jnp.where(idx == 0, 1.0, _RULE_F[jnp.maximum(idx - 1, 0)])

    return jnp.where(xi >= 1.0, pos(xi), 1.0 / pos(1.0 / xi))


class LoopState(NamedTuple):
    s: SolverState
    it: jax.Array             # completed iterations (i32)
    last_sigma_it: jax.Array  # i32 (-1 initially => first iter checks)
    use_feas_org: jax.Array   # bool
    stage: jax.Array          # rescale stage (i32; 0 = disabled)
    max_feas: jax.Array       # f32
    rel_gap: jax.Array        # f32
    done: jax.Array           # bool
    hist: jax.Array           # (H, 9): 7 kkt_org + pdGap + iter
    hist_n: jax.Array         # i32
    stage3_next: jax.Array    # next periodic rescale-eval iteration (i32)
    tol: jax.Array            # f32 stopping tolerance (traced: the tol
                              # pyramid changes it per level, and baking it
                              # would force a recompile per level)


class DeviceDriver:
    """Chunked on-device solve for one level."""

    name = "Inexact Proximal ALM (device loop)"

    # rescale constants (``solver_socp_inPALM.m:70-77``)
    DONATE = True
    FIRST_ITER = 10
    SECOND_ITER = 50
    RATIO_THRESHOLD = 1.2

    def __init__(self, kernels: Kernels, opts: SolveOptions,
                 chunk_iters: int = 600, rescale_check_every: int = 100,
                 checkpoint_path: str | None = None,
                 max_chunks: int | None = None, mesh=None):
        self.k = kernels
        self.opts = opts
        self.chunk_iters = chunk_iters
        self.rescale_check_every = rescale_check_every
        self.checkpoint_path = checkpoint_path
        self.max_chunks = max_chunks
        # spatial domain decomposition: a jax Mesh with ('y', 'x') (2D) or
        # ('x',) (1D) axes. The grids are 2^k + 1 (odd), which jax.Array
        # cannot hold sharded across a jit boundary, so the chunk jit
        # constrains the LoopState to the y/x layout at entry
        # (GSPMD pads the last shard internally) and the whole while_loop
        # runs partitioned: stencils become halo exchanges, KKT norms become
        # psums, control decisions stay replicated scalars. State crosses
        # chunk boundaries replicated (once per ~600 iterations). The
        # reference has no parallel substrate at all (SURVEY.md section 2.5).
        self.mesh = mesh
        hist_cap = opts.maxit // 3 + 8
        self._hist_cap = hist_cap
        self._chunk = self._build_chunk()
        if mesh is not None:
            self._chunk = self._wrap_mesh(self._chunk)

    def _wrap_mesh(self, chunk):
        from ..parallel.sharding import loop_state_shardings

        chunk = getattr(chunk, "__wrapped__", chunk)  # unwrap the inner jit
        mesh = self.mesh
        carry_z2 = getattr(self.k, "carry_z2", False)

        def chunk_mesh(ls, it_end):
            sh = loop_state_shardings(ls, mesh, carry_z2=carry_z2)
            ls = jax.tree.map(
                lambda x, s: jax.lax.with_sharding_constraint(x, s), ls, sh
            )
            return chunk(ls, it_end)

        if self.DONATE:
            return partial(jax.jit, donate_argnums=0)(chunk_mesh)
        return jax.jit(chunk_mesh)

    # -- algorithm hooks (overridden by the acc-ADMM driver) -------------
    def _base(self, s):
        return s

    def _with_base(self, s, base):
        return base

    def _step(self, s):
        return self.k._step(s)

    def _segment(self, s, k):
        """k event-free iterations (traced k) in one fori_loop; subclasses
        that change the step (acc/sGS) override ``_step`` or ``_segment``."""
        return jax.lax.fori_loop(0, k, lambda _, st: self._step(st), s)

    def _post_check(self, s, sigma_changed, rescaled):
        return s

    def _sigma_apply(self, s, factor):
        return self.k._sigma_mult(s, factor)

    def _rescale_apply(self, s, d2, c2):
        return self.k._rescale(s, d2, c2)

    # -- the loop body ---------------------------------------------------
    def _build_chunk(self):
        opts = self.opts
        k = self.k
        maxit = opts.maxit
        stop_idx = (
            jnp.array([0, 2, 5, 6]) if opts.check_prim_dual_feas
            else jnp.array([0, 2, 5])
        )

        def rescale_trigger(ls: LoopState):
            """Top-of-iteration rescale decision for iteration ls.it + 1
            (``solver_socp_inPALM.m:139-153``). The periodic (stage >= 3)
            evaluation advances ``stage3_next`` whether or not the ratio
            test fires, so a declined evaluation cannot recur at the same
            loop position."""
            it1 = ls.it + 1
            t1 = (
                (ls.stage == 1)
                & (ls.max_feas < 2e-2)
                & (ls.rel_gap < 5e-2)
                & (it1 >= self.FIRST_ITER)
            )
            t2 = (
                (ls.stage == 2)
                & (ls.max_feas < 5e-3)
                & (ls.rel_gap < 1e-2)
                & (it1 >= self.SECOND_ITER)
            )
            periodic = (ls.stage >= 3) & (it1 == ls.stage3_next)
            every = self.rescale_check_every
            ls = ls._replace(
                stage3_next=jnp.where(
                    periodic,
                    ls.stage3_next + every,
                    jnp.maximum(ls.stage3_next, (ls.it // every + 1) * every),
                )
            )

            def apply(ls):
                base = self._base(ls.s)
                norms = k._norms(base)
                norm_phis = jnp.maximum(
                    jnp.maximum(norms["normPhi"], norms["normQ"]), norms["normZ"]
                )
                norm_alps = jnp.maximum(norms["normAlpha"], norms["normBeta"])
                ratio = jnp.maximum(norm_alps, norm_phis) / jnp.maximum(
                    jnp.minimum(norm_alps, norm_phis), 1e-30
                )
                ok = jnp.where(
                    ls.stage >= 3, ratio > self.RATIO_THRESHOLD, True
                )

                def do(ls):
                    s = self._rescale_apply(ls.s, norm_phis, norm_alps)
                    return ls._replace(s=s, stage=ls.stage + 1)

                return jax.lax.cond(ok, do, lambda ls: ls, ls)

            return jax.lax.cond(t1 | t2 | periodic, apply, lambda ls: ls, ls)

        def check_block(ls: LoopState):
            """Bottom-of-iteration KKT check + sigma update
            (``solver_socp_inPALM.m:219-323``)."""
            res = k._kkt(self._base(ls.s))
            kkt_org = res["kkt_org"]
            kkt5 = res["kkt"]
            pd_gap = res["pdGap"]

            row = jnp.concatenate(
                [
                    kkt_org.astype(jnp.float32),
                    jnp.stack([pd_gap.astype(jnp.float32),
                               (ls.it).astype(jnp.float32)]),
                ]
            )
            hist = jax.lax.dynamic_update_slice(
                ls.hist,
                row[None],
                (
                    jnp.minimum(ls.hist_n, self._hist_cap - 1),
                    jnp.zeros((), jnp.int32),
                ),
            )
            hist_n = jnp.minimum(ls.hist_n + 1, self._hist_cap)

            done = jnp.max(kkt_org[stop_idx]) < ls.tol
            use_org = ls.use_feas_org | (jnp.max(kkt5) < 5.0 * ls.tol)

            # sigma update at cadence points only
            adjust = (ls.it - ls.last_sigma_it) >= _cadence_gap(ls.it)

            def sigma_update(carry):
                s, last = carry
                pri = jnp.where(
                    use_org,
                    jnp.maximum(kkt_org[0], kkt_org[1]),
                    jnp.maximum(kkt5[0], kkt5[1]),
                )
                dua = jnp.where(
                    use_org,
                    jnp.maximum(kkt_org[2], kkt_org[4]),
                    jnp.maximum(kkt5[2], kkt5[4]),
                )
                factor = _table_factor(pri / jnp.maximum(dua, 1e-30))
                base = self._base(s)
                sigma_new = jnp.clip(
                    base.sigma * factor, SIGMA_BOUNDS[0], SIGMA_BOUNDS[1]
                )
                factor = jnp.where(
                    factor != 1.0, sigma_new / base.sigma, 1.0
                ).astype(base.sigma.dtype)
                s = jax.lax.cond(
                    factor != 1.0,
                    lambda s: self._sigma_apply(s, factor),
                    lambda s: s,
                    s,
                )
                return s, ls.it

            s, last = jax.lax.cond(
                adjust & ~done, sigma_update, lambda c: c, (ls.s, ls.last_sigma_it)
            )
            max_feas = jnp.where(
                ls.stage > 0, jnp.max(kkt5), ls.max_feas
            ).astype(ls.max_feas.dtype)
            rel_gap = jnp.where(ls.stage > 0, pd_gap, ls.rel_gap).astype(
                ls.rel_gap.dtype
            )
            return ls._replace(
                s=s,
                last_sigma_it=last,
                use_feas_org=use_org,
                max_feas=max_feas,
                rel_gap=rel_gap,
                done=done,
                hist=hist,
                hist_n=hist_n,
            )

        next_check_it = _next_check_it  # module-level, shared with batch.py

        def next_rescale_stop(ls):
            """it-position (completed iterations) just before the next
            rescale-eligible iteration, inf-like when none is scheduled."""
            big = jnp.asarray(2**30, jnp.int32)
            e1 = jnp.where(
                (ls.stage == 1) & (ls.max_feas < 2e-2) & (ls.rel_gap < 5e-2),
                jnp.maximum(ls.it + 1, self.FIRST_ITER),
                big,
            )
            e2 = jnp.where(
                (ls.stage == 2) & (ls.max_feas < 5e-3) & (ls.rel_gap < 1e-2),
                jnp.maximum(ls.it + 1, self.SECOND_ITER),
                big,
            )
            e3 = jnp.where(ls.stage >= 3, ls.stage3_next, big)
            return jnp.minimum(jnp.minimum(e1, e2), e3) - 1

        def body(ls_and_end):
            ls, it_end = ls_and_end
            stop = jnp.minimum(
                jnp.minimum(next_check_it(ls.it, ls.last_sigma_it),
                            next_rescale_stop(ls)),
                jnp.minimum(it_end, maxit),
            )
            k = jnp.maximum(stop - ls.it, 0)
            s = self._segment(ls.s, k)
            ls = ls._replace(s=s, it=ls.it + k)
            at_check = ((ls.it - ls.last_sigma_it) >= _cadence_gap(ls.it)) | (
                ls.it >= maxit
            )
            ls = jax.lax.cond(at_check, check_block, lambda x: x, ls)
            ls = ls._replace(s=self._post_check(ls.s, False, False))
            # rescale due at the top of the next iteration fires here
            ls = rescale_trigger(ls)
            return (ls, it_end)

        def chunk(ls: LoopState, it_end) -> LoopState:
            def cond(c):
                ls, end = c
                return (~ls.done) & (ls.it < jnp.minimum(end, maxit))

            ls, _ = jax.lax.while_loop(cond, body, (ls, it_end))
            return ls

        if self.DONATE:
            return partial(jax.jit, donate_argnums=0)(chunk)
        return jax.jit(chunk)

    # -- lifecycle -------------------------------------------------------
    def init_loop_state(self, state) -> LoopState:
        f32 = jnp.float32
        return LoopState(
            s=state,
            it=jnp.zeros((), jnp.int32),
            last_sigma_it=jnp.full((), -(10**9), jnp.int32),
            use_feas_org=jnp.zeros((), bool),
            stage=jnp.asarray(1 if self.opts.scaling else 0, jnp.int32),
            max_feas=jnp.asarray(jnp.inf, f32),
            rel_gap=jnp.asarray(jnp.inf, f32),
            done=jnp.zeros((), bool),
            hist=jnp.zeros((self._hist_cap, 9), f32),
            hist_n=jnp.zeros((), jnp.int32),
            stage3_next=jnp.asarray(self.rescale_check_every, jnp.int32),
            tol=jnp.asarray(self.opts.tol, f32),
        )

    def solve(self, var):
        opts = self.opts
        state = self.k.prep(var, opts.sigma)
        ls = self.init_loop_state(self._init_extra(state))
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            from ..utils.checkpoint import load_pytree

            try:
                ls, meta = load_pytree(self.checkpoint_path, ls)
            except ValueError:
                pass  # stale checkpoint from another level/config: ignore
        # solve_time starts after prep has finished on the device
        jax.block_until_ready(ls)
        t0 = time.monotonic()
        chunks = 0
        # (iteration, elapsed) at chunk boundaries, for history timestamps
        time_marks = [(0, 0.0)]
        # fresh states start at (it=0, done=False): skip the first transfer
        it, done = 0, False
        if self.checkpoint_path:
            it, done = (int(v) for v in jax.device_get((ls.it, ls.done)))
        while True:
            if it >= opts.maxit or bool(done):
                break
            if time.monotonic() - t0 > opts.time_limit:
                break
            if self.max_chunks is not None and chunks >= self.max_chunks:
                break
            it_end = min(it + self.chunk_iters, opts.maxit)
            ls = self._chunk(ls, jnp.asarray(it_end, jnp.int32))
            chunks += 1
            it_v, done_v = jax.device_get((ls.it, ls.done))
            it, done = int(it_v), bool(done_v)
            time_marks.append((it, time.monotonic() - t0))
            if self.checkpoint_path:
                from ..utils.checkpoint import save_pytree

                save_pytree(
                    self.checkpoint_path, ls,
                    {"iters": it, "name": self.name},
                )

        # unpack history; per-check times interpolated from chunk boundaries
        # (one transfer of the whole buffer, sliced host-side)
        hist_n_v, hist_v = jax.device_get((ls.hist_n, ls.hist))
        hist_n = int(hist_n_v)
        hist_rows = np.asarray(hist_v)[:hist_n]
        elapsed = time.monotonic() - t0
        marks = np.array(time_marks)
        hist = RunHistory(method=self.name)
        for r in hist_rows:
            it_r = int(r[8])
            t_r = float(np.interp(it_r, marks[:, 0], marks[:, 1]))
            hist.append(r[:7].astype(np.float64), t_r, it_r, float(r[7]))

        var = self.k.finalize(ls.s, var)
        var["name"] = self.name
        var["iters"] = it
        var["solve_time"] = elapsed
        return hist.as_arrays(), var

    def _init_extra(self, state):
        return state


class AccDeviceDriver(DeviceDriver):
    """Device-resident acc-ADMM: the Halpern averaging is the per-iteration
    ``_post_check``; sigma changes and rescales restart the anchors inside
    the loop (``solver_socp_accADMM.m:346-358,369-388``)."""

    name = "Accelerated ADMM (device loop)"
    # anchors alias the iterate after prep/restart; XLA rejects donating
    # the same buffer twice, and the copy per ~600-iteration chunk is noise
    DONATE = False

    def __init__(self, kernels, opts, chunk_iters: int = 600, **kw):
        super().__init__(kernels, opts, chunk_iters=chunk_iters,
                         rescale_check_every=200, **kw)

    def _base(self, e):
        return e.s

    def _step(self, e):
        return e._replace(s=self.k._step(e.s))

    def _segment(self, e, k):
        """k acc-ADMM iterations: step+Halpern for the first k-1, the last
        one stops pre-averaging (the KKT point); _post_check completes it."""
        def body(_, e):
            e = e._replace(s=self.k._step(e.s))
            return self.k._halpern(e)

        e = jax.lax.fori_loop(0, jnp.maximum(k - 1, 0), body, e)
        return jax.lax.cond(
            k > 0, lambda e: e._replace(s=self.k._step(e.s)), lambda e: e, e
        )

    def _post_check(self, e, sigma_changed, rescaled):
        return self.k._halpern(e)

    def _sigma_apply(self, e, factor):
        return self.k._sigma_mult_acc(e, factor)

    def _rescale_apply(self, e, d2, c2):
        return self.k._rescale_acc(e, d2, c2)

    def _init_extra(self, state):
        # state from Kernels.prep is already an AccState (AccADMMKernels.prep)
        return state

    def solve(self, var):
        return super().solve(var)
