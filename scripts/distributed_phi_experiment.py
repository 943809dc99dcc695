"""Distributed phi-solve experiment: matmul-DCT vs sGS smoother under the
y/x spatial sharding (SURVEY section 2.5 options (a)/(b)).

Wall-clock on the 8-virtual-device CPU mesh is meaningless, so the
comparison inspects the compiled (SPMD-partitioned) HLO: which collectives
GSPMD inserts, how many, and on which shapes. That is the quantity that
rides the interconnect on real multi-device hardware. The decision is recorded in
docs/DESIGN.md.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python scripts/distributed_phi_experiment.py
"""
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from dotsocp.algorithms.core import LevelConfig
from dotsocp.algorithms.variants import InPALMKernels, SgsKernels
from dotsocp.multilevel.level import initial_scaling, initialize
from dotsocp.models.examples import get_example_2d
from dotsocp.parallel.sharding import constrain, make_mesh, state_shardings

from dotsocp.utils.hlo import collective_stats  # shared parser


def report(name, fn, arg):
    c = jax.jit(fn).lower(arg).compile()
    hlo = c.as_text()
    stats = collective_stats(hlo)
    total = sum(v[1] for v in stats.values())
    print(f"\n{name}:")
    if not stats:
        print("  (no collectives)")
    for coll, (cnt, b) in sorted(stats.items()):
        print(f"  {coll:>20}: {cnt:3d} ops, {b/1e6:8.2f} MB")
    print(f"  {'TOTAL':>20}: {total/1e6:8.2f} MB per step")
    return total


def main():
    n, nt = 65, 17
    rho0, rho1 = get_example_2d("example2", n, n)
    lv = initialize(rho0, rho1, nt, dtype=jnp.float32)
    initial_scaling(lv, scaling=True)
    mesh = make_mesh(8, axis_names=("y", "x"))
    print(f"mesh: {dict(mesh.shape)}, grid {n}x{n}x{nt} f32")
    state_bytes = 0

    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                      dtype=jnp.float32, layout="3d")
    kd = InPALMKernels(cfg)
    ks = SgsKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                                dtype=jnp.float32, layout="3d"))
    sd = kd.prep(lv.as_dict(), sigma=1.0)
    ss = ks.prep(lv.as_dict(), sigma=1.0)
    sh = state_shardings(mesh, batched=False)

    def step_dct(s):
        return constrain(kd._step(constrain(s, sh)), sh)

    def step_sgs(s):
        return constrain(ks._step(constrain(s, sh)), sh)

    def phi_dct(s):
        s = constrain(s, sh)
        rhs = s.D * kd.ops.grad_T(s.q - s.alpha) + s.c
        return jax.lax.with_sharding_constraint(
            kd._poisson_solve(s, rhs), sh.phi)

    def phi_sgs(s):
        s = constrain(s, sh)
        rhs = s.D * ks.ops.grad_T(s.q - s.alpha) + s.c
        phi = ks.sgs.sweep(s.phi, rhs, 1, d2=s.D * s.D)
        return jax.lax.with_sharding_constraint(phi, sh.phi)

    t_dct = report("phi-step only: matmul-DCT (exact solve)", phi_dct, sd)
    t_sgs = report("phi-step only: red-black sGS sweep (inexact)", phi_sgs, ss)
    f_dct = report("full inPALM step with DCT phi-solve", step_dct, sd)
    f_sgs = report("full sGS-inPALM step (sGS phi-step)", step_sgs, ss)
    print(f"\nphi-step collective traffic ratio DCT/sGS: "
          f"{t_dct / max(t_sgs, 1):.1f}x")
    print(f"full-step  collective traffic ratio DCT/sGS: "
          f"{f_dct / max(f_sgs, 1):.1f}x")


if __name__ == "__main__":
    main()
