"""Halo-engine payoff measurement: collective traffic of one full inPALM
step under y/x spatial sharding, GSPMD constraint sharding (layout "3d",
uneven 2^k+1 shards -> full-axis all-gathers) vs the halo engine (layout
"halo", padded even shards + shard_map ppermute one-slab halos).

Wall-clock on virtual CPU devices is meaningless; the compiled HLO's
collective ops/bytes are what ride the ICI on real hardware. Results are
recorded in docs/DESIGN.md section 8.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python scripts/halo_collectives_experiment.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from distributed_phi_experiment import report

from dotsocp.algorithms.core import LevelConfig
from dotsocp.algorithms.variants import InPALMKernels
from dotsocp.multilevel.level import initial_scaling, initialize
from dotsocp.models.examples import get_example_2d
from dotsocp.parallel.sharding import constrain, make_mesh, state_shardings


def main():
    n, nt = 65, 17
    rho0, rho1 = get_example_2d("example2", n, n)
    lv = initialize(rho0, rho1, nt, dtype=jnp.float32)
    initial_scaling(lv, scaling=True)
    mesh = make_mesh(8, axis_names=("y", "x"))
    print(f"mesh: {dict(mesh.shape)}, grid {n}x{n}x{nt} f32")

    sh = state_shardings(mesh, batched=False)

    # GSPMD path: shaped arrays, constraint sharding
    kd = InPALMKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                                   dtype=jnp.float32, layout="3d"))
    sd = kd.prep(lv.as_dict(), sigma=1.0)

    def step_gspmd(s):
        return constrain(kd._step(constrain(s, sh)), sh)

    # halo path: padded even shards, shard_map ppermute stencils
    kh = InPALMKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                                   dtype=jnp.float32, layout="halo",
                                   mesh=mesh))
    shalo = kh.prep(lv.as_dict(), sigma=1.0)

    def step_halo(s):
        return constrain(kh._step(constrain(s, sh)), sh)

    def kkt_halo(s):
        return kh._kkt(constrain(s, sh))

    g = report("full inPALM step, GSPMD constraint sharding (3d)",
               step_gspmd, sd)
    h = report("full inPALM step, halo engine (shard_map ppermute)",
               step_halo, shalo)
    report("KKT battery, halo engine", kkt_halo, shalo)
    print(f"\nstep collective-traffic reduction GSPMD/halo: {g / max(h, 1):.1f}x")


if __name__ == "__main__":
    main()
