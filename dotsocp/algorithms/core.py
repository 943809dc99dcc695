"""Solver state, per-level constants, and jitted compute kernels.

Architecture (accelerator-first, unlike the reference's monolithic MATLAB
loops):

- All per-iteration math is jitted and runs on device: ``run_segment`` scans
  the plain iteration ``k`` times in one XLA computation, ``kkt`` evaluates
  the full residual battery, and small state-transform kernels apply the
  sigma/rescale updates.
- All *decision* logic (KKT cadence, sigma update tables, rescale state
  machine, termination) lives in the host driver
  (:mod:`dotsocp.algorithms.driver`), mirroring the reference's
  scheduling exactly (``solver_socp_inPALM.m:361-379`` cadence; KKT checks
  happen only at cadence points, so host-side checks are equivalent).
- Scalars that change during a level (sigma, cScale, dScale, norm_c, norm_d,
  the scaled c) are traced state, so sigma updates never trigger recompiles.

The variables alpha, beta, c are stored pre-divided by sigma, exactly like
the reference (``solver_socp_inPALM.m:102-104``): a sigma change rescales
them instead of entering the step formulas.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.geometry import Geometry
from ..ops.staggered import Staggered
from ..ops import staggered as stg
from ..ops.cone import proj_soc
from ..ops.engine import make_ops
from ..utils.norms import norm_l2


# scalar fields packed into one transfer vector (a device_get of a dict
# fetches each leaf separately, one host round-trip each)
PACK_SCALARS = [
    "priVal", "dualVal", "pdGap", "normPhi", "normQ", "normZ",
    "normAlpha", "normBeta", "normAphi", "norm_c_state", "cScale",
    "dScale", "sigma", "D", "E",
]


def pack_kkt(res: dict) -> jax.Array:
    parts = [res["kkt_org"], res["kkt"]]
    parts.append(jnp.stack([res[k].astype(res["kkt_org"].dtype)
                            for k in PACK_SCALARS]))
    if "kkt_sgs_blocks" in res:
        parts.append(res["kkt_sgs_blocks"][None].astype(res["kkt_org"].dtype))
    return jnp.concatenate(parts)


def unpack_kkt(vec) -> dict:
    vec = np.asarray(vec)
    out = {"kkt_org": vec[:7], "kkt": vec[7:12]}
    for i, k in enumerate(PACK_SCALARS):
        out[k] = vec[12 + i]
    if vec.shape[0] > 12 + len(PACK_SCALARS):
        out["kkt_sgs_blocks"] = vec[12 + len(PACK_SCALARS)]
    return out


class SolverState(NamedTuple):
    """Traced per-iteration state (a single donated pytree on device)."""

    phi: jax.Array          # (nt, *space)
    q: Staggered
    z: jax.Array            # (C, nt-1, *space)
    alpha: Staggered        # stored as alpha / sigma
    beta: jax.Array         # stored as beta / sigma
    z2: jax.Array           # cached BFd(q) with current scales
    c: jax.Array            # scaled c / sigma
    sigma: jax.Array        # scalar
    cScale: jax.Array       # scalar (grows with rescales)
    dScale: jax.Array       # scalar
    norm_c: jax.Array       # scalar
    norm_d: jax.Array       # scalar
    sigmaScale: jax.Array   # scalar, product of sigma rescale factors
    # level scaling constants (``InitialScaling``). Traced -- NOT baked into
    # the executable -- so one compiled chunk serves every problem instance
    # with the same shapes: E carries the data-dependent E2 feedback
    # (``solver_dotsocp2d.m:308-318``), and a re-trace per level/problem
    # would cost a full compile each.
    D: jax.Array            # scalar
    E: jax.Array            # scalar
    diag_q_inv: Staggered   # 1 / diag(D_w^2 + (E/D)^2 F*B*BF), from (D, E)


@dataclasses.dataclass(frozen=True)
class LevelConfig:
    """Static (compile-time) configuration of one level's kernels.

    D and E are *defaults* recorded for bookkeeping: the kernels read the
    traced copies in :class:`SolverState` (set by ``prep`` from the level
    variables), so executables depend only on shapes/dtype/method — not on
    the per-level scaling values."""

    geom: Geometry
    D: float
    E: float
    tau: float = 1.9
    weighted: bool = False
    check_prim_dual_feas: bool = True
    dtype: object = jnp.float32
    # "3d": shaped arrays (sharding-friendly, sGS); "flat": spatial axes
    # flattened into one axis (the single-device default, ops/engine.py);
    # "halo": shaped arrays padded to mesh-divisible sizes with shard_map
    # ppermute halo stencils (the multi-chip path, ops/halo_engine.py) —
    # requires ``mesh``
    layout: str = "3d"
    # mesh for layout="halo" (spatial axes "y"/"x"); for other layouts it
    # only marks a sharded solve (no single-device kernels)
    mesh: Optional[object] = None
    # f64 DCT strategy: False = plain f64 transforms;
    # True = double-word split-f32 matmuls (~1e-9 phi
    # error; ops/poisson.py _apply_axis_split); "ir" = f32 transforms +
    # f64-residual iterative refinement (split-level cost, ~f64-grade
    # accuracy — no floor; ops/poisson.py _solve_ir). Opt-in: both fast
    # modes perturb f64 trajectories below the 1e-9 level, so golden f64
    # fixtures keep the plain path.
    dct_split: object = False
    # Whether the cached z2 = BFd(q) is carried in SolverState. z2 is
    # derivable from q (same op, same inputs — equal to FMA-contraction
    # noise), so carrying it costs a full z-sized HBM write + read per
    # iteration (~1.3 GB/iter at 513^2x65 f32) for nothing; the recompute
    # fuses into its consumers. None = auto (False). Set True to reproduce
    # the pre-decarry state layout (e.g. old checkpoints).
    carry_z2: Optional[bool] = None


def _zstep_kernel_applies(cfg: LevelConfig) -> bool:
    """The fused z-step kernel (ops/zstep_triton.py) serves the flat f32
    layout on one GPU; under a mesh the plain ops keep the partitioner's
    sharding rules."""
    return (cfg.layout == "flat" and jnp.dtype(cfg.dtype) == jnp.float32
            and cfg.mesh is None and jax.devices()[0].platform == "gpu")


class Kernels:
    """Jitted kernels for one level. ``weight`` is None for the unweighted
    problem — the weighted formulas with w == 1 reduce exactly to the
    reference's dot1d/dot2d path, so skipping the multiplies is bitwise
    equivalent (and saves HBM reads of a ones-array)."""

    def __init__(self, cfg: LevelConfig, weight: Optional[Staggered] = None):
        self.cfg = cfg
        geom = cfg.geom
        dtype = cfg.dtype
        self.geom = geom
        self.carry_z2 = (cfg.carry_z2 if cfg.carry_z2 is not None else False)
        self.ops = make_ops(geom, dtype, cfg.layout, cfg.mesh)
        # unit-D build: the solve multiplies by the traced 1/D^2 at use time
        self.poisson = self.ops.make_poisson(1.0, split=cfg.dct_split)
        if weight is None or not cfg.weighted:
            self.weight = None
        else:
            self.weight = self.ops.weight_to_internal(weight.astype(dtype))
        self._zstep_kernel = None
        if _zstep_kernel_applies(cfg) and not self.carry_z2:
            from ..ops.zstep_triton import make_zstep

            self._zstep_kernel = make_zstep(geom.nt, self.ops.S,
                                            self.ops.strides, dtype)
        self._build()

    def _w(self, x):
        """Multiply by the diagonal weight D_w (identity when unweighted)."""
        return x if self.weight is None else self.weight * x

    def _diag_q_inv(self, D, E):
        """1 / diag of the q-step system from traced (D, E) — evaluated once
        per prep, carried in the state."""
        diag = self.ops.oper_q_diag(D, E, self.weight)
        return jax.tree.map(lambda x: 1.0 / x, diag)

    def _poisson_solve(self, s: SolverState, rhs):
        """phi-step DCT solve of D^2 A^T A phi = rhs with traced D."""
        return self.poisson.solve(rhs, scale=1.0 / (s.D * s.D))

    def _z2_cur(self, s: SolverState):
        """Current z2 = scale_bf*(BF q) + (E/dScale)*d: the cached carry, or
        a bitwise-identical recompute from q when the carry is dropped
        (XLA fuses the recompute into its consumers — no extra HBM pass)."""
        if self.carry_z2:
            return s.z2
        return self.ops.bfd(s.q, s.E / s.D, s.E / s.dScale)

    def _keep_z2(self, z2):
        """What to store in the state's z2 slot."""
        return z2 if self.carry_z2 else None

    def _z_step(self, s: SolverState):
        """proj_soc(BFd(q) - beta): one fused GPU kernel where it applies
        (``_zstep_kernel_applies``), else the plain ops."""
        if self._zstep_kernel is not None:
            return self._zstep_kernel(s.q.q0, s.q.bs, s.beta, s.E / s.D,
                                      s.E / s.dScale)
        return proj_soc(self._z2_cur(s) - s.beta)

    # -- core iteration --------------------------------------------------
    def _step(self, s: SolverState) -> SolverState:
        """One inPALM/PALM-family iteration (``solver_socp_inPALM.m:192-216``;
        weighted variant ``solver_wsocp_inPALM.m:198-222``)."""
        cfg = self.cfg
        ops = self.ops
        sbf = s.E / s.D
        # phi-step: D^2 A0^T A0 phi = D A0^T (w.q - alpha) + c   (DCT solve)
        rhs = s.D * ops.grad_T(self._w(s.q) - s.alpha) + s.c
        phi = self._poisson_solve(s, rhs)
        # z-step: cone projection of BFd(q) minus beta
        z = self._z_step(s)
        # q-step: diagonal solve
        tmp_q = s.D * ops.grad(phi)
        q2 = ops.bfd_T(z + s.beta, sbf)
        q = (self._w(tmp_q + s.alpha) + q2) * s.diag_q_inv
        # multiplier step
        z2 = ops.bfd(q, sbf, s.E / s.dScale)
        resi_alpha = tmp_q - self._w(q)
        resi_beta = z - z2
        alpha = s.alpha + cfg.tau * resi_alpha
        beta = s.beta + cfg.tau * resi_beta
        return s._replace(phi=phi, q=q, z=z, alpha=alpha, beta=beta,
                          z2=self._keep_z2(z2))

    def _build(self):
        step = self._step

        def segment(s: SolverState, k) -> SolverState:
            return jax.lax.fori_loop(0, k, lambda _, st: step(st), s)

        @partial(jax.jit, donate_argnums=0)
        def run_segment(s: SolverState, k) -> SolverState:
            return segment(s, k)

        @partial(jax.jit, donate_argnums=0)
        def run_segment_check(s: SolverState, k):
            """Segment + KKT battery in one dispatch, result packed into a
            single vector (one transfer instead of ~20)."""
            s = segment(s, k)
            return s, pack_kkt(self._kkt(s))

        @jax.jit
        def run_one(s: SolverState) -> SolverState:
            return step(s)

        self.run_segment = run_segment
        self.run_segment_check = run_segment_check
        self.run_one = run_one
        self.get_sigma = lambda s: s.sigma
        self.kkt = jax.jit(self._kkt)
        self.norms = jax.jit(self._norms)
        self.sigma_mult = jax.jit(self._sigma_mult)
        self.rescale = jax.jit(self._rescale)

    # -- diagnostics -----------------------------------------------------
    def _norms(self, s: SolverState):
        """Block norms used by the dynamic rescaling checks
        (``solver_socp_inPALM.m:139-148``)."""
        h = self.geom.h
        return {
            "normPhi": norm_l2(s.phi, h),
            "normQ": norm_l2(s.q, h),
            "normZ": norm_l2(s.z, h),
            "normAlpha": s.sigma * norm_l2(s.alpha, h),
            "normBeta": s.sigma * norm_l2(s.beta, h),
        }

    def _kkt(self, s: SolverState):
        """Full KKT battery (``solver_socp_inPALM.m:223-267``), one fused
        device computation returning a dict of scalars."""
        cfg = self.cfg
        geom = self.geom
        ops = self.ops
        h = geom.h
        kkt_const = 1.0

        tmp_q = s.D * ops.grad(s.phi)
        resi_alpha = tmp_q - self._w(s.q)
        z2 = self._z2_cur(s)
        resi_beta = s.z - z2
        q2b = ops.bfd_T(s.beta, s.E / s.D)
        d_alpha = self._w(s.alpha)

        norm_q = norm_l2(s.q, h)
        norm_z = norm_l2(s.z, h)
        norm_aphi = norm_l2(tmp_q, h)
        norm_alpha = s.sigma * norm_l2(s.alpha, h)
        norm_beta = s.sigma * norm_l2(s.beta, h)
        norm_fbbeta = s.sigma * norm_l2(q2b, h)

        prim_fea1 = norm_l2(resi_alpha, h)
        prim_fea2 = norm_l2(resi_beta, h)
        dual_fea1 = s.sigma * norm_l2(s.D * ops.grad_T(s.alpha) - s.c, h)
        dual_fea2 = s.sigma * norm_l2(q2b + d_alpha, h)
        complem = norm_l2(s.z - proj_soc(s.z - s.sigma * s.beta), h)

        dc = self._dot_complement(s, d_alpha, z2)

        E_over_dscale = s.E / s.dScale
        if cfg.weighted:
            # wdot2d denominator for residual 2 (``solver_wsocp_inPALM.m``)
            denom2 = kkt_const * E_over_dscale + norm_q + norm_z
        else:
            denom2 = kkt_const * E_over_dscale + s.norm_d
        kkt_org = jnp.stack(
            [
                prim_fea1 / (kkt_const * s.D / s.dScale + norm_aphi + norm_q),
                prim_fea2 / denom2,
                dual_fea1 / (kkt_const / s.cScale + s.norm_c),
                complem / (kkt_const * E_over_dscale + norm_z + norm_beta),
                dual_fea2
                / (kkt_const / s.cScale / s.D + norm_fbbeta + norm_alpha),
                dc["dotcomplem"] / (kkt_const + dc["normRho"] + dc["norm_rhoFq"]),
                dc["mRhoB"] / (kkt_const + dc["normM"] + dc["normRhoB"]),
            ]
        )
        kkt_scp = jnp.stack(
            [
                prim_fea1 / (kkt_const + norm_aphi + norm_q),
                prim_fea2 / (kkt_const + s.norm_d),
                dual_fea1 / (kkt_const + s.norm_c),
                complem / (kkt_const + norm_z + norm_beta),
                dual_fea2 / (kkt_const + norm_fbbeta + norm_alpha),
            ]
        )

        scale = s.sigma * s.cScale * s.dScale * h
        pri_val = scale * s.q.dot(s.alpha)
        dual_val = scale * jnp.sum(s.c * s.phi)  # vdot ravels -> gathers
        pd_gap = jnp.abs(pri_val - dual_val) / (1 + jnp.abs(pri_val) + jnp.abs(dual_val))

        out = {
            "kkt_org": kkt_org,
            "kkt": kkt_scp,
            "priVal": pri_val,
            "dualVal": dual_val,
            "pdGap": pd_gap,
            "normPhi": norm_l2(s.phi, h),
            "normQ": norm_q,
            "normZ": norm_z,
            "normAlpha": norm_alpha,
            "normBeta": norm_beta,
            # stale-denominator ingredients for the sGS between-check
            # feasibility updates (``solver_socp_sGSinPALM.m:380-390``)
            "normAphi": norm_aphi,
            "norm_c_state": s.norm_c,
            "cScale": s.cScale,
            "dScale": s.dScale,
            "sigma": s.sigma,
            "D": s.D,
            "E": s.E,
        }
        return out

    def _dot_complement(self, s: SolverState, d_alpha: Staggered, z2):
        """Original-DOT complementarity residuals
        (``socp/dot2d/utils/compute_kkt_dot_complement.m``; weighted variant
        substitutes D_w alpha)."""
        cfg = self.cfg
        geom = self.geom
        h = geom.h
        d = geom.ndim_space

        rho_t = (s.sigma * s.cScale * s.D) * d_alpha.q0
        b_cols = z2[1 : 1 + 4 * d]
        rho_fq = (
            rho_t
            + (s.dScale / s.D) * s.q.q0
            + jnp.sum(jnp.square((s.dScale / s.E) * b_cols), axis=0) / 4.0
        )
        rho_fq = jnp.maximum(rho_fq, 0.0)

        dotcomplem = norm_l2(rho_t - rho_fq, h)
        norm_rho = norm_l2(rho_t, h)
        norm_rho_fq = norm_l2(rho_fq, h)

        # interpolate rho to time nodes (zero-padded ends), then to faces
        rho_nodes = self.ops.t_node_interp(rho_t)  # (nt, ...)

        m_sq = jnp.asarray(0.0, rho_t.dtype)
        rb_sq = jnp.asarray(0.0, rho_t.dtype)
        diff_sq = jnp.asarray(0.0, rho_t.dtype)
        for a in range(d):
            # face-interpolated rho; any flat ghost garbage is annihilated
            # by the ghost-zero face arrays it multiplies
            rho_face = self.ops.face_interp(rho_nodes, a)
            rho_b = (s.dScale / s.D) * rho_face * s.q.bs[a]
            m_a = (s.sigma * s.cScale * s.D) * d_alpha.bs[a]
            m_sq = m_sq + h * jnp.sum(jnp.square(m_a))
            rb_sq = rb_sq + h * jnp.sum(jnp.square(rho_b))
            diff_sq = diff_sq + h * jnp.sum(jnp.square(m_a - rho_b))
        return {
            "dotcomplem": dotcomplem,
            "normRho": norm_rho,
            "norm_rhoFq": norm_rho_fq,
            "mRhoB": jnp.sqrt(diff_sq),
            "normM": jnp.sqrt(m_sq),
            "normRhoB": jnp.sqrt(rb_sq),
        }

    # -- host-driven state transforms ------------------------------------
    def _sigma_mult(self, s: SolverState, factor) -> SolverState:
        """Apply sigma <- sigma * factor: alpha, beta, c are stored
        pre-divided by sigma (``solver_socp_inPALM.m:309-315``)."""
        inv = 1.0 / factor
        return s._replace(
            alpha=s.alpha * inv,
            beta=s.beta * inv,
            c=s.c * inv,
            sigma=s.sigma * factor,
        )

    def _rescale(self, s: SolverState, d_scale2, c_scale2) -> SolverState:
        """Dynamic rescaling of the whole iterate
        (``solver_socp_inPALM.m:163-189``). phi is intentionally not scaled
        (it is overwritten by the next phi-step), matching the reference."""
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
            q=q,
            z=s.z / d_scale2,
            z2=z2,
            dScale=d_scale,
            cScale=s.cScale * c_scale2,
            sigmaScale=s.sigmaScale * (c_scale2 / d_scale2),
        )

    # -- lifecycle -------------------------------------------------------
    def _prep_impl(self, phi, q, z, alpha, beta, c, sigma, c_scale, d_scale,
                   norm_c, norm_d, D, E):
        """Jitted state assembly: convert to the kernel layout, divide
        alpha/beta/c by sigma, and cache z2. One device dispatch instead of
        ~10 eager ops — the level plumbing stays on the host (see
        initialize) and lands here in one hop. Outputs are fresh buffers
        (no donation), so the caller's arrays survive the solver's donated
        segments."""
        ops = self.ops
        phi = ops.phi_to_internal(phi)
        q = ops.stag_to_internal(q)
        z = ops.z_to_internal(z)
        alpha = ops.stag_to_internal(alpha)
        beta = ops.z_to_internal(beta)
        c = ops.phi_to_internal(c)
        z2 = (ops.bfd(q, E / D, E / d_scale)
              if self.carry_z2 else None)
        return SolverState(
            phi=phi + 0.0,
            q=jax.tree.map(lambda x: x + 0.0, q),
            z=z + 0.0,
            alpha=alpha / sigma,
            beta=beta / sigma,
            z2=z2,
            c=c / sigma,
            sigma=sigma,
            cScale=c_scale,
            dScale=d_scale,
            norm_c=norm_c,
            norm_d=norm_d,
            sigmaScale=jnp.ones_like(sigma),
            D=D,
            E=E,
            diag_q_inv=self._diag_q_inv(D, E),
        )

    def prep(self, var, sigma: float) -> SolverState:
        """Build the iteration state from level variables (already through
        InitialScaling). ``var`` must carry the level's D and E (see
        ``LevelVar.as_dict``); defaults fall back to the config's values."""
        dtype = self.cfg.dtype
        if not hasattr(self, "_prep_jit"):
            self._prep_jit = jax.jit(self._prep_impl)
        npdtype = np.dtype(jnp.dtype(dtype).name)

        def _conv(a):
            if isinstance(a, np.ndarray):
                return np.asarray(a, npdtype)  # host cast; jit uploads it
            return a if a.dtype == dtype else a.astype(dtype)

        to = lambda x: jax.tree.map(_conv, x)
        sc = lambda x: np.asarray(float(jax.device_get(x)), npdtype)
        return self._prep_jit(
            to(var["phi"]), to(var["q"]), to(var["z"]), to(var["alpha"]),
            to(var["beta"]), to(var["c"]), sc(sigma), sc(var["cScale"]),
            sc(var["dScale"]), sc(var["norm_c"]), sc(var["norm_d"]),
            sc(var.get("D", self.cfg.D)), sc(var.get("E", self.cfg.E)),
        )

    def _finalize_impl(self, s: SolverState):
        """One-dispatch write-back (in the caller's shaped layout):
        arrays + a packed scalar vector."""
        ops = self.ops
        scalars = jnp.stack(
            [s.cScale, s.dScale, s.norm_c, s.norm_d, s.sigma / s.sigmaScale]
        )
        return (
            ops.phi_from_internal(s.phi),
            ops.stag_from_internal(s.q),
            ops.z_from_internal(s.z),
            ops.stag_from_internal(s.alpha * s.sigma),
            ops.z_from_internal(s.beta * s.sigma),
            ops.phi_from_internal(s.c * s.sigma),
            scalars,
        )

    def finalize(self, s: SolverState, var) -> dict:
        """Write back iteration variables (``solver_socp_inPALM.m:329-357``):
        alpha,beta remultiplied by sigma; sigma unwound by sigmaScale.
        One jitted dispatch + one scalar transfer (vs ~10 eager round
        trips)."""
        if not hasattr(self, "_finalize_jit"):
            self._finalize_jit = jax.jit(self._finalize_impl)
        phi, q, z, alpha, beta, c, scalars = self._finalize_jit(s)
        c_scale, d_scale, norm_c, norm_d, sigma_out = (
            float(v) for v in jax.device_get(scalars)
        )
        var = dict(var)
        var.update(
            phi=phi, q=q, z=z, alpha=alpha, beta=beta, c=c,
            cScale=c_scale, dScale=d_scale, norm_c=norm_c, norm_d=norm_d,
        )
        var["sigma_out"] = sigma_out
        return var
