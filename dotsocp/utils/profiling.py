"""Per-phase timing and roofline reporting.

The reference wraps every algorithm step in tic/toc and prints a named
table (Step_1_1_FFT, Step_1_2_ProjSOC, Step_2_Q_Step, Step_3_Multiplier,
KKT, Total_Time, Iters — ``solver_socp_inPALM.m:124-128,339-341``). Under
jit those phases fuse into one computation, so production runs report
segment-level time only; this module provides the *profiling mode*: each
phase jitted separately and fenced with ``jax.block_until_ready``, plus
achieved memory bandwidth against the device's published peak.
"""
from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp


# Published peak device-memory bandwidth (GB/s), keyed by
# ``jax.Device.device_kind``. Source: NVIDIA H100 Tensor Core GPU data
# sheet, SXM part (80 GB HBM3 at 3.35 TB/s).
ROOFLINE_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def roofline_gbps(device=None):
    """Peak bandwidth of ``device`` (default: the first device) in GB/s;
    None on the CPU, where no roofline share is reported. An accelerator
    missing from :data:`ROOFLINE_GBPS` is an error, never a default."""
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return None
    try:
        return ROOFLINE_GBPS[device.device_kind]
    except KeyError:
        raise ValueError(
            f"no peak bandwidth known for {device.platform} device kind "
            f"{device.device_kind!r}; add it to ROOFLINE_GBPS with its source"
        ) from None


def _nbytes(tree) -> int:
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))


def profile_phases(kernels, state, iters: int = 30) -> Dict[str, dict]:
    """Time each algorithm phase separately (jitted, fenced). Returns
    {phase: {ms, gbps, pct_roofline}} plus a fused full-step row.

    Covers all six algorithms (the reference's ``record_time`` columns
    exist per algorithm — Step_1_1_FFT / Step_1_1_sGS etc.): the phi phase
    is the DCT solve or, for the sGS family, the red-black sweep; acc-ADMM
    variants add the Halpern averaging phase; the weighted family's
    diagonal multiplies ride inside the q-step/multiplier phases.

    Phase byte counts are the minimal device-memory traffic (each operand
    read once, each result written once) — achieved GB/s above ~60% of
    roofline means the phase is bandwidth-bound and near speed-of-light.
    ``pct_roofline`` is omitted on the CPU.
    """
    from ..algorithms.variants import AccState, NesterovState

    acc_state = state if isinstance(state, (AccState, NesterovState)) else None
    if acc_state is not None:
        state = state.s

    cfg = kernels.cfg
    ops = kernels.ops
    wmul = kernels._w
    sgs = getattr(kernels, "sgs", None) or getattr(kernels, "sgs_op", None)
    sgs = sgs if hasattr(sgs, "sweep") else None
    sgs_d2 = (lambda s: kernels._sgs_d2(s)) if sgs is not None else None

    def _rhs(s):
        return s.D * ops.grad_T(wmul(s.q) - s.alpha) + s.c

    def phi_step(s):
        return kernels._poisson_solve(s, _rhs(s))

    def phi_sgs(s):
        return sgs.sweep(s.phi, _rhs(s), 1, d2=sgs_d2(s))

    def z_step(s):
        return kernels._z_step(s)

    def q_step(s):
        tmp_q = s.D * ops.grad(s.phi)
        q2 = ops.bfd_T(s.z + s.beta, s.E / s.D)
        return (wmul(tmp_q + s.alpha) + q2) * s.diag_q_inv

    def mult_step(s):
        tmp_q = s.D * ops.grad(s.phi)
        z2 = ops.bfd(s.q, s.E / s.D, s.E / s.dScale)
        alpha = s.alpha + cfg.tau * (tmp_q - wmul(s.q))
        beta = s.beta + cfg.tau * (s.z - z2)
        return alpha, beta, z2

    q_bytes = _nbytes(state.q)
    phi_bytes = _nbytes(state.phi)
    phase_bytes = {
        # rhs build: read q, alpha, c; write/read rhs through the DCT
        # matmul chain (6 transforms, each read+write) + write phi
        "phi_dct_solve": _nbytes(state.q) * 2 + _nbytes(state.c) * (1 + 12 + 1),
        # rhs build (q, alpha read; rhs write) + 3 half-sweeps over phi
        "phi_sgs_sweep": _nbytes(state.q) * 2 + _nbytes(state.c)
        + phi_bytes * (1 + 2 * 3),
        # the z-step as the solver runs it: read q, beta; write z
        "cone_projection": q_bytes + _nbytes(state.z) * 2,
        # read phi, z, beta, alpha, diag; write q
        "q_step": phi_bytes + _nbytes(state.z) * 2 + q_bytes * 3,
        # read phi, q, z, alpha, beta; write alpha, beta, z2
        "multiplier": phi_bytes + q_bytes * 3 + _nbytes(state.z) * 4,
        # read anchor, old, cur; write new iterate (+ anchor select)
        "halpern_averaging": (phi_bytes + q_bytes * 2 + _nbytes(state.z) * 2)
        * 4,
    }

    # each phase chained through the state inside one fori_loop so the
    # measurement amortizes host dispatch (a single dispatch can cost more
    # than a small phase computes)
    # feedback targets are chosen so each phase's output is consumed by its
    # own inputs next iteration (otherwise XLA hoists the loop-invariant
    # phase out of the fori_loop and the timing collapses to zero)
    def _mult_chain(s):
        alpha, beta, _ = mult_step(s)
        return s._replace(alpha=alpha, beta=beta)

    chained = {}
    if sgs is not None:
        chained["phi_sgs_sweep"] = lambda s: s._replace(phi=phi_sgs(s))
    else:
        chained["phi_dct_solve"] = lambda s: s._replace(c=phi_step(s))
    chained.update({
        "cone_projection": lambda s: s._replace(beta=z_step(s)),  # beta is an input
        "q_step": lambda s: s._replace(alpha=q_step(s)),        # alpha is an input
        "multiplier": _mult_chain,
        "kkt_battery": lambda s: s._replace(
            sigma=s.sigma + 0.0 * kernels._kkt(s)["pdGap"].astype(s.sigma.dtype)
        ),
        "full_step_fused": kernels._step,
    })

    roof = roofline_gbps()

    def timed(loop, arg, nbytes=None):
        jax.block_until_ready(loop(arg))  # compile + warm
        t0 = time.perf_counter()
        jax.block_until_ready(loop(arg))
        dt = (time.perf_counter() - t0) / iters
        row = {"ms": dt * 1e3}
        if nbytes:
            row["gbps"] = nbytes / dt / 1e9
            if roof is not None:
                row["pct_roofline"] = 100.0 * row["gbps"] / roof
        return row

    out = {}
    for name, fn in chained.items():
        loop = jax.jit(
            lambda s, f=fn: jax.lax.fori_loop(0, iters, lambda _, st: f(st), s)
        )
        out[name] = timed(loop, state, phase_bytes.get(name))

    if acc_state is not None and hasattr(kernels, "_halpern"):
        halp = kernels._halpern
        loop = jax.jit(
            lambda e: jax.lax.fori_loop(0, iters, lambda _, x: halp(x), e)
        )
        out["halpern_averaging"] = timed(
            loop, acc_state, phase_bytes["halpern_averaging"])
    return out


def format_table(prof: Dict[str, dict]) -> str:
    lines = [f"{'phase':<18} {'ms':>9} {'GB/s':>9} {'%roof':>7}"]
    for name, row in prof.items():
        gb = f"{row['gbps']:.1f}" if "gbps" in row else "-"
        pr = f"{row['pct_roofline']:.1f}" if "pct_roofline" in row else "-"
        lines.append(f"{name:<18} {row['ms']:>9.3f} {gb:>9} {pr:>7}")
    return "\n".join(lines)
