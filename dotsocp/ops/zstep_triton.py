"""Fused z-step ``z = proj_soc(BFd(q) - beta)`` on the flat layout as one
Pallas kernel through Triton.

XLA splits the plain z-step into a reduction over the cone-column axis and
a second pass that re-reads its inputs to scale them. This kernel reads
each q face and each beta plane once and writes each z plane once: every
program owns one time slab and one power-of-two block of the flat space
axis, forms the 2 + 4d cone columns of ``OpsFlat.bfd`` in registers (the
stride shifts are masked offset loads, zero-filled below the stride), and
projects them (``cone.proj_soc``'s arithmetic).
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _kernel(sc_ref, q0_ref, *refs, n_space: int, strides, S: int, block: int):
    b_refs = refs[:n_space]
    beta_ref, z_ref = refs[n_space], refs[n_space + 1]
    t = pl.program_id(0)
    idx = pl.program_id(1) * block + jnp.arange(block)
    live = idx < S
    sbf = sc_ref[0]
    sd = sc_ref[1]
    s = sbf * _INV_SQRT2

    def ld(ref, *ix, mask=live):
        return plgpu.load(ref.at[ix], mask=mask, other=0.0)

    q0 = ld(q0_ref, t, idx)
    cols = [sd - sbf * q0]
    for a in range(n_space):
        k = strides[a]
        lo_mask = live & (idx >= k)
        for tt in (t, t + 1):
            cols.append(s * ld(b_refs[a], tt, idx - k, mask=lo_mask))
            cols.append(s * ld(b_refs[a], tt, idx))
    cols.append(sd + sbf * q0)
    v = [c - ld(beta_ref, i, t, idx) for i, c in enumerate(cols)]
    nrm2 = v[1] * v[1]
    for w in v[2:]:
        nrm2 = nrm2 + w * w
    nrm = jnp.sqrt(nrm2)
    safe = jnp.where(nrm > 0, nrm, 1.0)
    coef = jnp.clip(0.5 * (1.0 + v[0] / safe), 0.0, 1.0)
    plgpu.store(z_ref.at[0, t, idx], jnp.maximum(v[0], coef * nrm), mask=live)
    for i, w in enumerate(v[1:], start=1):
        plgpu.store(z_ref.at[i, t, idx], coef * w, mask=live)


def make_zstep(nt: int, S: int, strides, dtype=jnp.float32,
               block: int = 256, num_warps: int = 2,
               interpret: bool = False):
    """``fn(q0, bs, beta, scale_bf, scale_d) -> z`` for flat fields:
    q0 (nt-1, S), bs[a] (nt, S), beta and z (2 + 4d, nt-1, S).

    ``block``/``num_warps``: 256/2 ran fastest of 256/2, 512/4, 1024/4 and
    2048/8 at 513^2x65 on an H100 (PERF.md). ``interpret`` runs the kernel
    in the Pallas interpreter (CPU tests)."""
    n_space = len(strides)
    C = 2 + 4 * n_space
    call = pl.pallas_call(
        functools.partial(_kernel, n_space=n_space, strides=tuple(strides),
                          S=S, block=block),
        out_shape=jax.ShapeDtypeStruct((C, nt - 1, S), dtype),
        grid=(nt - 1, pl.cdiv(S, block)),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        backend="triton",
        name="zstep_flat",
    )

    def zstep(q0, bs, beta, scale_bf, scale_d):
        sc = jnp.stack([jnp.asarray(scale_bf, dtype), jnp.asarray(scale_d, dtype)])
        return call(sc, q0, *bs, beta)

    return zstep
