"""Per-level problem setup, initial scaling, and solution recovery.

Replaces the reference's ``initialize.m`` + the ``InitialScaling`` /
``recoverOrgVar`` closures of ``solver_dotsocp2d.m:304-386`` (1-D deltas at
``solver_dotsocp1d.m:263-317``, weighted at ``solver_wdotsocp2d.m:296-360``).
All quantities live in shaped arrays; the scaled gradient D stays a scalar
applied inside the operators instead of scaling a sparse matrix.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.geometry import Geometry
from ..ops.staggered import Staggered
from ..ops import staggered as stg
from ..utils.norms import norm_l2


@dataclasses.dataclass
class LevelVar:
    """One level's variables + model data (the reference's var/model pair)."""

    geom: Geometry
    rho0: jax.Array
    rho1: jax.Array
    c: jax.Array
    phi: jax.Array
    q: Staggered
    z: jax.Array
    alpha: Staggered
    beta: jax.Array
    weight: Optional[Staggered] = None
    # scaling factors (set by initial_scaling)
    D: float = 1.0
    E: float = 1.0
    cScale: float = 1.0
    dScale: float = 1.0
    E2: float = math.sqrt(2.0)
    norm_c: float = 0.0
    norm_d: float = math.sqrt(2.0)

    def as_dict(self):
        return {
            "phi": self.phi,
            "q": self.q,
            "z": self.z,
            "alpha": self.alpha,
            "beta": self.beta,
            "c": self.c,
            "cScale": self.cScale,
            "dScale": self.dScale,
            "norm_c": self.norm_c,
            "norm_d": self.norm_d,
            "D": self.D,
            "E": self.E,
        }


def initialize(rho0, rho1, nt: int, dtype=jnp.float64,
               weight: Optional[Staggered] = None) -> LevelVar:
    """Build model (c) and initial variables (``initialize.m``):
    phi = sum_a x_a^2 / 2 replicated over t; z, beta, q, alpha zero.

    Built in host numpy: every eager device op is a separate dispatch, so
    the level plumbing stays on host and the solver's jitted prep moves
    everything to the device in one call."""
    npdtype = np.dtype(jnp.dtype(dtype).name)
    rho0 = np.asarray(rho0, npdtype)
    rho1 = np.asarray(rho1, npdtype)
    space = rho0.shape
    geom = Geometry(nt=nt, space=space)

    c = np.zeros(geom.phi_shape, npdtype)
    c[0] = -rho0 / geom.ht
    c[-1] = rho1 / geom.ht

    # phi0 = (1/2) * sum of squared coordinates (``initialize.m:48-50``)
    phi_sp = np.zeros(space, npdtype)
    for a, n in enumerate(space):
        x = np.linspace(0.0, 1.0, n, dtype=npdtype)
        shape = [1] * len(space)
        shape[a] = n
        phi_sp = phi_sp + 0.5 * x.reshape(shape) ** 2
    phi = np.broadcast_to(phi_sp, geom.phi_shape).astype(npdtype)

    zeros_st = Staggered(
        q0=np.zeros(geom.q0_shape, npdtype),
        bs=tuple(
            np.zeros(geom.b_shape(a), npdtype) for a in range(geom.ndim_space)
        ),
    )
    zeros_st2 = Staggered(
        q0=np.zeros(geom.q0_shape, npdtype),
        bs=tuple(
            np.zeros(geom.b_shape(a), npdtype) for a in range(geom.ndim_space)
        ),
    )
    return LevelVar(
        geom=geom,
        rho0=rho0,
        rho1=rho1,
        c=c,
        phi=phi,
        q=zeros_st,
        z=np.zeros(geom.z_shape, npdtype),
        alpha=zeros_st2,
        beta=np.zeros(geom.z_shape, npdtype),
        weight=weight,
    )


def update_e2(prev_e2: Optional[float], last_kkt, weighted: bool) -> float:
    """E2 feedback from the previous level's final KKT
    (``solver_dotsocp2d.m:308-318``; weighted: safeguard 4,
    ``solver_wdotsocp2d.m:300-305``)."""
    if last_kkt is None or prev_e2 is None:
        return math.sqrt(2.0)
    ratio = math.sqrt(max(last_kkt[0], 1e-300) / max(last_kkt[1], 1e-300))
    if weighted:
        return prev_e2 * min(4.0, max(0.25, ratio))
    lower = 0.8333
    if ratio < lower:
        return prev_e2 * max(1.0 / math.sqrt(2.0), ratio / lower)
    return prev_e2 * min(math.sqrt(2.0), max(1.0, ratio))


@jax.jit
def _scale_blocks_jit(c, phi, q, z, alpha, beta,
                      div_c, div_phi, f_q, f_z, f_alpha, f_beta):
    """All six block scalings in one device dispatch (instead of one
    dispatch per eager op). c and phi are divided, the
    rest multiplied — the exact arithmetic the reference uses
    (``solver_dotsocp2d.m:330-339``), so values are bitwise identical to
    per-block eager ops."""
    mul = lambda x, f: x * jnp.asarray(f, x.dtype)
    return (
        c / jnp.asarray(div_c, c.dtype),
        phi / jnp.asarray(div_phi, phi.dtype),
        jax.tree.map(lambda x: mul(x, f_q), q),
        mul(z, f_z),
        jax.tree.map(lambda x: mul(x, f_alpha), alpha),
        mul(beta, f_beta),
    )


def _scale_blocks(lv: LevelVar, div_c, div_phi, f_q, f_z, f_alpha, f_beta):
    leaves = jax.tree.leaves((lv.c, lv.phi, lv.q, lv.z, lv.alpha, lv.beta))
    if all(isinstance(x, np.ndarray) for x in leaves):
        lv.c = lv.c / np.asarray(div_c, lv.c.dtype)
        lv.phi = lv.phi / np.asarray(div_phi, lv.phi.dtype)
        lv.q = lv.q * float(f_q)
        lv.z = lv.z * np.asarray(f_z, lv.z.dtype)
        lv.alpha = lv.alpha * float(f_alpha)
        lv.beta = lv.beta * np.asarray(f_beta, lv.beta.dtype)
    else:
        lv.c, lv.phi, lv.q, lv.z, lv.alpha, lv.beta = _scale_blocks_jit(
            lv.c, lv.phi, lv.q, lv.z, lv.alpha, lv.beta,
            div_c, div_phi, f_q, f_z, f_alpha, f_beta,
        )


def initial_scaling(lv: LevelVar, scaling: bool, last_kkt=None,
                    prev_e2: Optional[float] = None) -> None:
    """Scale (c, phi, q, z, alpha, beta) and set (D, E, cScale, dScale)
    in place (``solver_dotsocp2d.m:304-365``)."""
    geom = lv.geom
    h = geom.h
    h_mean = geom.h_mean
    weighted = lv.weight is not None

    lv.E2 = update_e2(prev_e2, last_kkt, weighted)

    def _host_norm(c):
        if isinstance(c, np.ndarray):
            return math.sqrt(h) * float(np.linalg.norm(c.ravel()))
        return float(norm_l2(c, h))

    if not scaling:
        lv.cScale = lv.dScale = lv.D = lv.E = 1.0
        lv.norm_c = _host_norm(lv.c)
        lv.norm_d = math.sqrt(2.0)
        return

    norm_c = _host_norm(lv.c) * math.sqrt(geom.nt)
    norm_d = math.sqrt(2.0)

    if weighted:
        # geometric-mean weight adjustment (``solver_wdotsocp2d.m:310-316``)
        logs = [np.log10(np.asarray(lv.weight.q0) + 1e-10)] + [
            np.log10(np.asarray(b) + 1e-10) for b in lv.weight.bs
        ]
        total = sum(float(x.sum()) for x in logs)
        count = sum(x.size for x in logs)
        adjust = 10.0 ** (total / count)
        D = math.sqrt(2.0) * math.sqrt(h_mean) * adjust
        E = D / lv.E2
        c_scale = max(1.0, norm_c * math.sqrt(h_mean) / adjust)
        d_scale = E * norm_d * math.sqrt(adjust)
    else:
        D = math.sqrt(2.0) * math.sqrt(h_mean)
        E = D / lv.E2
        c_scale = max(1.0, norm_c * math.sqrt(h_mean))
        d_scale = E * norm_d

    lv.norm_c = norm_c / c_scale
    lv.norm_d = norm_d * E / d_scale
    _scale_blocks(
        lv,
        c_scale, d_scale, D / d_scale, E / d_scale,
        1.0 / (c_scale * D), 1.0 / (c_scale * E),
    )
    lv.D, lv.E, lv.cScale, lv.dScale = D, E, c_scale, d_scale


@jax.jit
def _unscale_blocks_jit(phi, z, q, alpha, beta,
                        f_phi, f_z, f_q, f_alpha, f_beta):
    mul = lambda x, f: x * jnp.asarray(f, x.dtype)
    return (
        mul(phi, f_phi),
        mul(z, f_z),
        jax.tree.map(lambda x: mul(x, f_q), q),
        jax.tree.map(lambda x: mul(x, f_alpha), alpha),
        mul(beta, f_beta),
    )


def recover_org_var(lv: LevelVar, out: dict) -> None:
    """Undo the initial scaling on the solver's outputs in place
    (``solver_dotsocp2d.m:368-386``); ``out`` is the finalized var dict with
    possibly grown cScale/dScale from dynamic rescaling. One device dispatch
    for all five blocks."""
    c_scale = float(jax.device_get(out["cScale"]))
    d_scale = float(jax.device_get(out["dScale"]))
    D, E = lv.D, lv.E
    lv.phi, lv.z, lv.q, lv.alpha, lv.beta = _unscale_blocks_jit(
        out["phi"], out["z"], out["q"], out["alpha"], out["beta"],
        d_scale, d_scale / E, d_scale / D, c_scale * D, c_scale * E,
    )
    lv.cScale, lv.dScale = c_scale, d_scale


# ---------------------------------------------------------------------------
# solution recovery (``recover_RhoE.m``, ``recover_q.m``)
# ---------------------------------------------------------------------------

def _rho_e_body(rho0, rho1, alpha: Staggered):
    """Traceable body of recover_rho_e (alpha already weight-folded)."""
    rho_mid = alpha.q0
    rho = jnp.concatenate(
        [rho0[None], 0.5 * (rho_mid[:-1] + rho_mid[1:]), rho1[None]], axis=0
    )
    Es = []
    for a, b in enumerate(alpha.bs):
        # double the boundary time slabs (half-cells)
        b = b.at[0].mul(2.0).at[-1].mul(2.0)
        ax = 1 + a
        n_faces = b.shape[ax]
        lo = jax.lax.slice_in_dim(b, 0, n_faces - 1, axis=ax)
        hi = jax.lax.slice_in_dim(b, 1, n_faces, axis=ax)
        mid = 0.5 * (lo + hi)
        pad = [(0, 0)] * b.ndim
        pad[ax] = (1, 1)
        Es.append(jnp.pad(mid, pad))
    return rho, Es


def _q_centered_body(q: Staggered):
    """Traceable body of recover_q_centered (``recover_q.m``)."""
    q0 = q.q0
    bs = []
    for a, b in enumerate(q.bs):
        ax = 1 + a
        n_faces = b.shape[ax]
        lo = jax.lax.slice_in_dim(b, 0, n_faces - 1, axis=ax)
        hi = jax.lax.slice_in_dim(b, 1, n_faces, axis=ax)
        mid = 0.5 * (lo + hi)
        pad = [(0, 0)] * b.ndim
        pad[ax] = (1, 1)
        b_cc = jnp.pad(mid, pad)
        bs.append(0.5 * (b_cc[:-1] + b_cc[1:]))
    return q0, bs


def recover_rho_e(lv: LevelVar):
    """(rho, E_1..E_d) from the multiplier alpha: alpha's q0-block is the
    density on time-staggered cells, its face blocks are the momentum."""
    alpha = lv.alpha if lv.weight is None else lv.weight * lv.alpha
    dtype = alpha.q0.dtype
    return _rho_e_body(
        jnp.asarray(lv.rho0, dtype), jnp.asarray(lv.rho1, dtype), alpha
    )


def recover_q_centered(lv: LevelVar):
    """(q0, b_1..b_d) on the cell-centered / time-staggered grid
    (``recover_q.m``)."""
    return _q_centered_body(lv.q)


@jax.jit
def _recover_all_jit(rho0, rho1, alpha, q):
    rho, Es = _rho_e_body(rho0, rho1, alpha)
    q0, bs = _q_centered_body(q)
    axes = tuple(range(1, rho.ndim))
    n = math.prod(rho.shape[1:])
    mass = jnp.sum(rho, axis=axes) / n
    neg = jnp.sum(jnp.where(rho < 0, rho, 0.0), axis=axes) / n
    err = jnp.maximum(jnp.max(jnp.abs(mass - 1.0)), jnp.max(jnp.abs(neg)))
    return rho, Es, q0, bs, err


def recover_solution(lv: LevelVar, tol: float = 1e-2):
    """One-dispatch recovery of (rho, E, q0, b) + the mass-conservation
    check (``recover_RhoE.m``/``recover_q.m``/``check_massConservation.m``)
    — a dozen eager dispatches otherwise.
    Arrays stay on device; only the scalar mass error is transferred."""
    alpha = lv.alpha if lv.weight is None else lv.weight * lv.alpha
    dtype = alpha.q0.dtype
    rho, Es, q0, bs, err = _recover_all_jit(
        jnp.asarray(lv.rho0, dtype), jnp.asarray(lv.rho1, dtype), alpha, lv.q
    )
    return rho, Es, q0, bs, bool(float(jax.device_get(err)) <= tol)


def check_mass_conservation(rho, tol: float = 1e-2, verbose: bool = False) -> bool:
    """Per-time-slab mass and negative-mass check
    (``check_massConservation.m``): max(|int rho - 1|, |int rho_-|) <= tol."""
    rho = np.asarray(rho)
    axes = tuple(range(1, rho.ndim))
    n = np.prod(rho.shape[1:])
    mass = rho.sum(axis=axes) / n
    neg = np.where(rho < 0, rho, 0.0).sum(axis=axes) / n
    err = max(np.abs(mass - 1.0).max(), np.abs(neg).max())
    if verbose:
        print("Total mass per time slab:", mass)
        print("Negative mass per time slab:", neg)
    return bool(err <= tol)
