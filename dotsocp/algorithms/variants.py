"""Algorithm variants: PALM, acc-ADMM (Halpern), sGS-inPALM, acc-sGS-ADMM.

Each variant supplies its step order and which iterate blocks a dynamic
rescale must touch (exactly the blocks the reference scales — a block is
scaled iff it is consumed before being recomputed):

- inPALM  (base :class:`~.core.Kernels`): scales q, z  (``solver_socp_inPALM.m:174-178``)
- PALM:   scales phi, z — phi stands in for the reference's ``tmp_q = A*phi``
          cache, which it scales directly (``solver_socp_PALM.m``); observable
          behaviour is identical because phi itself is recomputed before any
          other use.
- sGS:    scales phi, q (``solver_socp_sGSinPALM.m:185-190``)
- accADMM: scales phi, q, z and resets the Halpern anchors
          (``solver_socp_accADMM.m:204-224``)
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.cone import proj_soc
from ..ops.sgs import make_sgs
from ..ops.staggered import Staggered
from ..utils.norms import norm_l2
from .core import Kernels, LevelConfig, SolverState


class InPALMKernels(Kernels):
    """inPALM / ALG2 (tau = 1.9 / 1.0): the base implementation."""


class PALMKernels(Kernels):
    """Exact 2-block proximal ALM: an extra q-step before (phi, z)
    (``solver_socp_PALM.m:196-218``)."""

    def _step(self, s: SolverState) -> SolverState:
        cfg = self.cfg
        ops = self.ops
        sbf = s.E / s.D
        # step q0: uses A*phi from the previous iteration
        tmp_q = s.D * ops.grad(s.phi)
        q2 = ops.bfd_T(s.z + s.beta, sbf)
        q = (self._w(tmp_q + s.alpha) + q2) * s.diag_q_inv
        # step phi
        rhs = s.D * ops.grad_T(self._w(q) - s.alpha) + s.c
        phi = self._poisson_solve(s, rhs)
        # step z (z2 refreshed from the q0-step's q)
        z2 = ops.bfd(q, sbf, s.E / s.dScale)
        z = proj_soc(z2 - s.beta)
        # step q (second)
        tmp_q = s.D * ops.grad(phi)
        q2 = ops.bfd_T(z + s.beta, sbf)
        q = (self._w(tmp_q + s.alpha) + q2) * s.diag_q_inv
        # multipliers
        z2 = ops.bfd(q, sbf, s.E / s.dScale)
        resi_alpha = tmp_q - self._w(q)
        resi_beta = z - z2
        return s._replace(
            phi=phi,
            q=q,
            z=z,
            alpha=s.alpha + cfg.tau * resi_alpha,
            beta=s.beta + cfg.tau * resi_beta,
            z2=self._keep_z2(z2),
        )

    def prep(self, var, sigma):
        s = super().prep(var, sigma)
        # initial z = BFd(A phi) (``solver_socp_PALM.m:136-138``)
        if not hasattr(self, "_palm_z_jit"):
            def _zinit(s):
                tmp_q = s.D * self.ops.grad(s.phi)
                z = self.ops.bfd(tmp_q, s.E / s.D, s.E / s.dScale)
                return s._replace(z=z)

            self._palm_z_jit = jax.jit(_zinit)
        return self._palm_z_jit(s)

    def _rescale(self, s, d_scale2, c_scale2):
        cfg = self.cfg
        r = d_scale2 / (c_scale2 * c_scale2)
        return s._replace(
            sigma=s.sigma * (c_scale2 / d_scale2),
            c=s.c * r,
            norm_c=s.norm_c / c_scale2,
            norm_d=s.norm_d / d_scale2,
            alpha=s.alpha * r,
            beta=s.beta * r,
            phi=s.phi / d_scale2,   # = the reference's tmp_q scaling
            z=s.z / d_scale2,
            dScale=s.dScale * d_scale2,
            cScale=s.cScale * c_scale2,
            sigmaScale=s.sigmaScale * (c_scale2 / d_scale2),
        )


class AccState(NamedTuple):
    """acc-ADMM extended state: base iterate + Halpern anchor machinery
    (``solver_socp_accADMM.m:154-163,369-388``)."""

    s: SolverState
    old: Tuple    # (phi, z, q, alpha, beta) after the previous averaging
    anchor: Tuple  # Halpern anchor x^0
    k: jax.Array   # averaging counter (int32)


def _iterate_tuple(s: SolverState):
    return (s.phi, s.z, s.q, s.alpha, s.beta)


def _with_iterate(s: SolverState, t) -> SolverState:
    return s._replace(phi=t[0], z=t[1], q=t[2], alpha=t[3], beta=t[4])


class AccADMMKernels(Kernels):
    """Halpern-accelerated preconditioned ADMM
    (``solver_socp_accADMM.m:227-249,369-388``). Step order: q, multiplier
    (tau = 1), phi, z; the KKT battery is evaluated before the anchor
    averaging, and the averaging itself is the ``post_check`` of the driver.
    Restart every ``restart`` iterations and on sigma change / rescale.
    """

    def __init__(self, cfg: LevelConfig, weight=None, restart: int = 100,
                 rho: float = 2.0):
        self.restart = restart
        self.rho = rho
        super().__init__(cfg, weight)

    def _step(self, s: SolverState) -> SolverState:
        ops = self.ops
        sbf = s.E / s.D
        # step q
        q2 = ops.bfd_T(s.z + s.beta, sbf)
        tmp_q = s.D * ops.grad(s.phi)
        q = (self._w(tmp_q + s.alpha) + q2) * s.diag_q_inv
        # step alpha, beta (unit step)
        z2 = ops.bfd(q, sbf, s.E / s.dScale)
        alpha = s.alpha + tmp_q - self._w(q)
        beta = s.beta + s.z - z2
        # step phi
        rhs = s.D * ops.grad_T(self._w(q) - alpha) + s.c
        phi = self._poisson_solve(s, rhs)
        # step z
        z = proj_soc(z2 - beta)
        return s._replace(phi=phi, q=q, z=z, alpha=alpha, beta=beta,
                          z2=self._keep_z2(z2))

    def _halpern(self, e: AccState) -> AccState:
        """x <- 1/(k+2) x0 + (k+1)/(k+2) ((1-rho) x_old + rho x), k += 1,
        restart the anchor when k reaches ``restart``."""
        k = e.k
        kf = k.astype(e.s.phi.dtype)
        c1 = 1.0 / (kf + 2.0)
        c2 = (kf + 1.0) / (kf + 2.0)
        rho = self.rho
        cur = _iterate_tuple(e.s)
        new = jax.tree.map(
            lambda x0, xo, x: c1 * x0 + c2 * ((1.0 - rho) * xo + rho * x),
            e.anchor, e.old, cur,
        )
        k1 = k + 1
        do_restart = k1 >= self.restart
        anchor = jax.tree.map(
            lambda a, n: jnp.where(do_restart, n, a), e.anchor, new
        )
        k1 = jnp.where(do_restart, 0, k1)
        return AccState(s=_with_iterate(e.s, new), old=new, anchor=anchor, k=k1)

    def _build(self):
        step = self._step
        halpern = self._halpern

        # no donation: anchor/old deliberately alias the iterate right after
        # prep/restart, and XLA rejects donating the same buffer twice
        @jax.jit
        def run_segment(e: AccState, k) -> AccState:
            def body(_, e):
                e = e._replace(s=step(e.s))
                return halpern(e)

            e = jax.lax.fori_loop(0, k - 1, body, e)
            # final iteration stops before the averaging (KKT point)
            return e._replace(s=step(e.s))

        self.run_segment = run_segment
        self.post_check = jax.jit(halpern)
        self.kkt = jax.jit(lambda e: self._kkt(e.s))
        self.norms = jax.jit(lambda e: self._norms(e.s))
        self.get_sigma = lambda e: e.s.sigma
        self.sigma_mult = jax.jit(self._sigma_mult_acc)
        self.rescale = jax.jit(self._rescale_acc)

    def _sigma_mult_acc(self, e: AccState, factor) -> AccState:
        """Scales alpha/beta/c (incl. the old copies) and restarts the
        anchor at the *scaled* current iterate (``accADMM.m:346-358``)."""
        inv = 1.0 / factor
        s = self._sigma_mult(e.s, factor)
        old = (e.old[0], e.old[1], e.old[2], e.old[3] * inv, e.old[4] * inv)
        cur = _iterate_tuple(s)
        return AccState(s=s, old=old, anchor=cur, k=jnp.zeros_like(e.k))

    def _rescale_acc(self, e: AccState, d2, c2) -> AccState:
        s = self._rescale_all(e.s, d2, c2)
        cur = _iterate_tuple(s)
        return AccState(s=s, old=cur, anchor=cur, k=jnp.zeros_like(e.k))

    def _rescale_all(self, s, d_scale2, c_scale2):
        """accADMM scales phi, q, z (``solver_socp_accADMM.m:204-209``)."""
        r = d_scale2 / (c_scale2 * c_scale2)
        q = s.q / d_scale2
        d_scale = s.dScale * d_scale2
        z2 = (self.ops.bfd(q, s.E / s.D, s.E / d_scale)
              if self.carry_z2 else None)
        return s._replace(
            sigma=s.sigma * (c_scale2 / d_scale2),
            c=s.c * r,
            norm_c=s.norm_c / c_scale2,
            norm_d=s.norm_d / d_scale2,
            alpha=s.alpha * r,
            beta=s.beta * r,
            phi=s.phi / d_scale2,
            q=q,
            z=s.z / d_scale2,
            z2=z2,
            dScale=d_scale,
            cScale=s.cScale * c_scale2,
            sigmaScale=s.sigmaScale * (c_scale2 / d_scale2),
        )

    def prep(self, var, sigma) -> AccState:
        s = super().prep(var, sigma)
        cur = _iterate_tuple(s)
        return AccState(s=s, old=cur, anchor=cur, k=jnp.zeros((), jnp.int32))

    def finalize(self, e: AccState, var) -> dict:
        return super().finalize(e.s, var)


class NesterovState(NamedTuple):
    """State of the non-Halpern (theta != 2) acc-ADMM branch
    (``solver_socp_accADMM.m:389-421``)."""

    s: SolverState
    old: Tuple      # x_old
    hat_old: Tuple  # xHat_old (valid when k > 0)
    k: jax.Array


class AccADMMNesterovKernels(AccADMMKernels):
    """acc-ADMM with Nesterov-type extrapolation instead of Halpern
    anchoring — the reference's ``theta != 2`` branch. Host-driver only."""

    def __init__(self, cfg: LevelConfig, weight=None, restart: int = 100,
                 rho: float = 2.0, theta: float = 3.0):
        self.theta = theta
        super().__init__(cfg, weight, restart=restart, rho=rho)

    def _extrapolate(self, e: NesterovState) -> NesterovState:
        rho = self.rho
        theta = self.theta
        k = e.k
        kf = k.astype(e.s.phi.dtype)
        c1 = theta / (2.0 * (kf + theta))
        c2 = kf / (kf + theta)
        cur = _iterate_tuple(e.s)
        hat = jax.tree.map(
            lambda xo, x: (1.0 - rho) * xo + rho * x, e.old, cur
        )
        first = k == 0
        new = jax.tree.map(
            lambda xo, xh, xho: jnp.where(
                first,
                (1.0 - c1) * xo + c1 * xh,
                (1.0 - c1) * xo + (c1 + c2) * xh - c2 * xho,
            ),
            e.old, hat, e.hat_old,
        )
        k1 = k + 1
        do_restart = k1 >= self.restart
        hat_old = jax.tree.map(
            lambda ho, h: jnp.where(do_restart, ho, h), e.hat_old, hat
        )
        k1 = jnp.where(do_restart, 0, k1)
        return NesterovState(
            s=_with_iterate(e.s, new), old=new, hat_old=hat_old, k=k1
        )

    def _build(self):
        step = self._step
        extra = self._extrapolate

        @jax.jit
        def run_segment(e: NesterovState, k) -> NesterovState:
            def body(_, e):
                e = e._replace(s=step(e.s))
                return extra(e)

            e = jax.lax.fori_loop(0, k - 1, body, e)
            return e._replace(s=step(e.s))

        self.run_segment = run_segment
        self.post_check = jax.jit(extra)
        self.kkt = jax.jit(lambda e: self._kkt(e.s))
        self.norms = jax.jit(lambda e: self._norms(e.s))
        self.get_sigma = lambda e: e.s.sigma

        def sigma_mult(e: NesterovState, factor):
            inv = 1.0 / factor
            s = self._sigma_mult(e.s, factor)
            old = (e.old[0], e.old[1], e.old[2], e.old[3] * inv, e.old[4] * inv)
            return NesterovState(s=s, old=old, hat_old=e.hat_old,
                                 k=jnp.zeros_like(e.k))

        def rescale(e: NesterovState, d2, c2):
            s = self._rescale_all(e.s, d2, c2)
            cur = _iterate_tuple(s)
            return NesterovState(s=s, old=cur, hat_old=cur,
                                 k=jnp.zeros_like(e.k))

        self.sigma_mult = jax.jit(sigma_mult)
        self.rescale = jax.jit(rescale)

    def prep(self, var, sigma) -> NesterovState:
        s = Kernels.prep(self, var, sigma)
        cur = _iterate_tuple(s)
        return NesterovState(s=s, old=cur, hat_old=cur,
                             k=jnp.zeros((), jnp.int32))

    def finalize(self, e: NesterovState, var) -> dict:
        return Kernels.finalize(self, e.s, var)


class AccSgsADMMKernels(AccADMMKernels):
    """acc-ADMM with the DCT solve replaced by one red-black sGS sweep
    (``solver_socp_accsGSADMM.m:240-274``). Step order: q, multiplier,
    phi (sGS), z; the sGS block residual is captured right after the sweep.
    """

    sgs_its = 1

    def __init__(self, cfg: LevelConfig, weight=None, restart: int = 100,
                 rho: float = 2.0):
        halo = cfg.layout == "halo" and cfg.mesh is not None
        if not halo:
            cfg = dataclasses.replace(cfg, layout="3d")  # sweeps shaped phi
        # unit-D build; the traced level D^2 is passed per sweep (the halo
        # sweep is built from the halo ops below)
        self.sgs_op = (None if halo
                       else make_sgs(cfg.geom, D=1.0, eps=0.0, dtype=cfg.dtype))
        self.last_aux = {}
        super().__init__(cfg, weight, restart=restart, rho=rho)
        if halo:
            from ..ops.halo_engine import HaloSGS

            self.sgs_op = HaloSGS(self.ops, D=1.0)

    def _sgs_d2(self, s):
        return s.D * s.D

    def _step_parts(self, s: SolverState):
        ops = self.ops
        sbf = s.E / s.D
        # step q
        q2 = ops.bfd_T(s.z + s.beta, sbf)
        tmp_q = s.D * ops.grad(s.phi)
        q = (self._w(tmp_q + s.alpha) + q2) * s.diag_q_inv
        # step alpha, beta
        z2 = ops.bfd(q, sbf, s.E / s.dScale)
        alpha = s.alpha + tmp_q - self._w(q)
        beta = s.beta + s.z - z2
        # step phi: one symmetric red-black sweep
        rhs = s.D * ops.grad_T(self._w(q) - alpha) + s.c
        phi = self.sgs_op.sweep(s.phi, rhs, self.sgs_its, d2=self._sgs_d2(s))
        s2 = s._replace(phi=phi, q=q, alpha=alpha, beta=beta,
                        z2=self._keep_z2(z2))
        return s2, rhs, z2

    def _step(self, s: SolverState) -> SolverState:
        s2, _, z2 = self._step_parts(s)
        return s2._replace(z=proj_soc(z2 - s2.beta))

    def _step_instrumented(self, s: SolverState, with_feas: bool):
        h = self.geom.h
        s2, rhs, z2 = self._step_parts(s)
        resi_sgs = self.sgs_op.residual_color_a_norm(
            s2.phi, rhs, h, d2=self._sgs_d2(s))
        s2 = s2._replace(z=proj_soc(z2 - s2.beta))
        aux = {"resi_sgs": resi_sgs}
        if with_feas:
            aux.update(self._feas_pair(s2))
        return s2, aux

    def _feas_pair(self, s: SolverState):
        h = self.geom.h
        tmp_q = s.D * self.ops.grad(s.phi)
        prim_fea1 = norm_l2(tmp_q - self._w(s.q), h)
        dual_fea1 = s.sigma * norm_l2(
            s.D * self.ops.grad_T(s.alpha) - s.c, h
        )
        return {"primFea1": prim_fea1, "dualFea1": dual_fea1}

    def _build(self):
        super()._build()
        step = self._step
        halpern = self._halpern

        @partial(jax.jit, static_argnums=(1, 2))
        def seg(e: AccState, k, with_feas):
            if with_feas:
                def body(e, _):
                    e = e._replace(s=step(e.s))
                    feas = self._feas_pair(e.s)
                    return halpern(e), feas

                e, feas = jax.lax.scan(body, e, None, length=k - 1)
                s, aux = self._step_instrumented(e.s, True)
                last = {kk: aux[kk] for kk in ("primFea1", "dualFea1")}
                aux = {"resi_sgs": aux["resi_sgs"]}
                aux["feas_hist"] = jax.tree.map(
                    lambda hist, lst: jnp.concatenate([hist, lst[None]]),
                    feas,
                    last,
                )
                return e._replace(s=s), aux

            def body(_, e):
                e = e._replace(s=step(e.s))
                return halpern(e)

            e = jax.lax.fori_loop(0, k - 1, body, e)
            s, aux = self._step_instrumented(e.s, False)
            return e._replace(s=s), aux

        def run_segment(e, k):
            e, aux = seg(e, int(k), bool(self.with_feas))
            self.last_aux = aux
            return e

        self.with_feas = False
        self.run_segment = run_segment
        self.kkt = jax.jit(lambda e: self._kkt_sgs(e.s))

    def _kkt_sgs(self, s: SolverState):
        """KKT battery + the sGS-block error (``accsGSADMM.m:358``)."""
        out = self._kkt(s)
        h = self.geom.h
        tmp_q = s.D * self.ops.grad(s.phi)
        resi_alpha = tmp_q - self._w(s.q)
        t1 = norm_l2(s.D * self.ops.grad_T(resi_alpha), h)
        dual1 = norm_l2(s.D * self.ops.grad_T(s.alpha) - s.c, h)
        out["kkt_sgs_blocks"] = jnp.sqrt(t1 * t1 + dual1 * dual1)
        return out

    def prep(self, var, sigma) -> AccState:
        e = super().prep(var, sigma)
        # de-mean phi once (``solver_socp_accsGSADMM.m:165``); ops hook
        # keeps halo-layout pads at exact zero
        s = e.s._replace(phi=self.ops.demean(e.s.phi))
        cur = _iterate_tuple(s)
        return AccState(s=s, old=cur, anchor=cur, k=e.k)


class SgsKernels(Kernels):
    """sGS-based inPALM: the DCT solve replaced by one red-black symmetric
    Gauss-Seidel sweep (``solver_socp_sGSinPALM.m:203-206``), making the
    phi-step halo-local — the preferred form under heavy spatial sharding.
    """

    sgs_its = 1

    def __init__(self, cfg: LevelConfig, weight=None):
        halo = cfg.layout == "halo" and cfg.mesh is not None
        if not halo:
            cfg = dataclasses.replace(cfg, layout="3d")  # sweeps shaped phi
        # unit-D build; the traced level D^2 is passed per sweep (the halo
        # sweep is built from the halo ops after super().__init__)
        self.sgs = (None if halo
                    else make_sgs(cfg.geom, D=1.0, eps=0.0, dtype=cfg.dtype))
        self.last_aux = {}
        super().__init__(cfg, weight)
        if halo:
            from ..ops.halo_engine import HaloSGS

            # halo red-black sweep: one shard_map, one-slab ppermutes per
            # half-sweep neighbour pull (the distributed phi-step the
            # module docstring of ops/sgs.py promises)
            self.sgs = HaloSGS(self.ops, D=1.0)

    def _sgs_d2(self, s):
        return s.D * s.D

    def _phi_rhs(self, s: SolverState):
        return s.D * self.ops.grad_T(self._w(s.q) - s.alpha) + s.c

    def _step_from_phi(self, s: SolverState, phi) -> SolverState:
        cfg = self.cfg
        ops = self.ops
        sbf = s.E / s.D
        z = proj_soc(self._z2_cur(s) - s.beta)
        tmp_q = s.D * ops.grad(phi)
        q2 = ops.bfd_T(z + s.beta, sbf)
        q = (self._w(tmp_q + s.alpha) + q2) * s.diag_q_inv
        z2 = ops.bfd(q, sbf, s.E / s.dScale)
        resi_alpha = tmp_q - self._w(q)
        resi_beta = z - z2
        return s._replace(
            phi=phi,
            q=q,
            z=z,
            alpha=s.alpha + cfg.tau * resi_alpha,
            beta=s.beta + cfg.tau * resi_beta,
            z2=self._keep_z2(z2),
        )

    def _step(self, s: SolverState) -> SolverState:
        phi = self.sgs.sweep(s.phi, self._phi_rhs(s), self.sgs_its,
                             d2=self._sgs_d2(s))
        return self._step_from_phi(s, phi)

    def _step_instrumented(self, s: SolverState, with_feas: bool):
        """Final-segment step: capture the sGS block residual right after the
        phi sweep (``solver_socp_sGSinPALM.m:208-218``) and, when the
        'sGS superior' mode is active, the cheap per-iteration feasibility
        pair (``solver_socp_sGSinPALM.m:373-390``)."""
        h = self.geom.h
        rhs = self._phi_rhs(s)
        phi = self.sgs.sweep(s.phi, rhs, self.sgs_its, d2=self._sgs_d2(s))
        resi_sgs = self.sgs.residual_color_a_norm(phi, rhs, h,
                                                  d2=self._sgs_d2(s))
        s = self._step_from_phi(s, phi)
        aux = {"resi_sgs": resi_sgs}
        if with_feas:
            aux.update(self._feas_pair(s))
        return s, aux

    def _feas_pair(self, s: SolverState):
        h = self.geom.h
        tmp_q = s.D * self.ops.grad(s.phi)
        resi_alpha = tmp_q - self._w(s.q)
        prim_fea1 = norm_l2(resi_alpha, h)
        dual_fea1 = s.sigma * norm_l2(
            s.D * self.ops.grad_T(s.alpha) - s.c, h
        )
        return {"primFea1": prim_fea1, "dualFea1": dual_fea1}

    def _build(self):
        step = self._step

        @partial(jax.jit, donate_argnums=0, static_argnums=(1, 2))
        def seg(s: SolverState, k, with_feas):
            if with_feas:
                def body(s, _):
                    s = step(s)
                    return s, self._feas_pair(s)

                s, feas = jax.lax.scan(body, s, None, length=k - 1)
                s, aux = self._step_instrumented(s, True)
                last = {kk: aux[kk] for kk in ("primFea1", "dualFea1")}
                aux = {"resi_sgs": aux["resi_sgs"]}
                aux["feas_hist"] = jax.tree.map(
                    lambda hist, lst: jnp.concatenate([hist, lst[None]]),
                    feas,
                    last,
                )
                return s, aux
            s = jax.lax.fori_loop(0, k - 1, lambda _, st: step(st), s)
            return self._step_instrumented(s, False)

        def run_segment(s, k):
            s, aux = seg(s, int(k), bool(self.with_feas))
            self.last_aux = aux
            return s

        self.with_feas = False
        self.run_segment = run_segment
        self.kkt = jax.jit(self._kkt)
        self.norms = jax.jit(self._norms)
        self.sigma_mult = jax.jit(self._sigma_mult)
        self.rescale = jax.jit(self._rescale)
        self.get_sigma = lambda s: s.sigma

    def _kkt(self, s: SolverState):
        out = super()._kkt(s)
        # kkt error of the sGS blocks (``solver_socp_sGSinPALM.m:322``):
        # sqrt(||A'(A phi - q + alpha)... || — assembled from resi_alpha)
        h = self.geom.h
        tmp_q = s.D * self.ops.grad(s.phi)
        resi_alpha = tmp_q - self._w(s.q)
        t1 = norm_l2(s.D * self.ops.grad_T(resi_alpha), h)
        dual1 = norm_l2(s.D * self.ops.grad_T(s.alpha) - s.c, h)
        out["kkt_sgs_blocks"] = jnp.sqrt(t1 * t1 + dual1 * dual1)
        return out

    def _rescale(self, s, d_scale2, c_scale2):
        """sGS scales phi and q, not z (``solver_socp_sGSinPALM.m:185-190``)."""
        r = d_scale2 / (c_scale2 * c_scale2)
        q = s.q / d_scale2
        d_scale = s.dScale * d_scale2
        z2 = (self.ops.bfd(q, s.E / s.D, s.E / d_scale)
              if self.carry_z2 else None)
        return s._replace(
            sigma=s.sigma * (c_scale2 / d_scale2),
            c=s.c * r,
            norm_c=s.norm_c / c_scale2,
            norm_d=s.norm_d / d_scale2,
            alpha=s.alpha * r,
            beta=s.beta * r,
            phi=s.phi / d_scale2,
            q=q,
            z2=z2,
            dScale=d_scale,
            cScale=s.cScale * c_scale2,
            sigmaScale=s.sigmaScale * (c_scale2 / d_scale2),
        )

    def prep(self, var, sigma):
        s = super().prep(var, sigma)
        # de-mean phi once (``solver_socp_sGSinPALM.m:144``); the ops hook
        # keeps halo-layout pads at exact zero
        if not hasattr(self, "_demean_jit"):
            self._demean_jit = jax.jit(
                lambda s: s._replace(phi=self.ops.demean(s.phi))
            )
        return self._demean_jit(s)
