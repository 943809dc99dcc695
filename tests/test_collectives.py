"""Regression tripwires for the halo engine's collective-traffic wins.

The round-2 result (DESIGN.md section 9, measured by
``scripts/halo_collectives_experiment.py``): at 65x65x17 f32 on a y=4,x=2
mesh one full inPALM step costs 10.11 MB of collectives on the GSPMD '3d'
layout but only 0.40 MB through the halo engine, and the KKT battery
0.02 MB. These tests pin upper bounds on the partitioned HLO so a GSPMD /
sharding-propagation change that silently reintroduces full-axis
all-gathers fails CI instead of shipping a 20x ICI regression.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dotsocp.algorithms.core import LevelConfig
from dotsocp.algorithms.variants import InPALMKernels, SgsKernels
from dotsocp.multilevel.level import initial_scaling, initialize
from dotsocp.models.examples import get_example_2d
from dotsocp.parallel.sharding import constrain, make_mesh, state_shardings
from dotsocp.utils.hlo import collective_bytes

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

N, NT = 65, 17
STEP_BOUND = 0.5e6   # measured 0.40 MB; GSPMD path is 10.11 MB
KKT_BOUND = 0.1e6    # measured 0.02 MB; GSPMD KKT was ~19 MB unpinned
SWEEP_BOUND = 0.3e6  # 6 one-slab ppermutes/half-sweep x 3 half-sweeps


@pytest.fixture(scope="module")
def halo_setup():
    rho0, rho1 = get_example_2d("example2", N, N)
    lv = initialize(rho0, rho1, NT, dtype=jnp.float32)
    initial_scaling(lv, scaling=True)
    mesh = make_mesh(8, axis_names=("y", "x"))
    sh = state_shardings(mesh, batched=False)
    return lv, mesh, sh


def test_halo_step_collective_bytes(halo_setup):
    lv, mesh, sh = halo_setup
    k = InPALMKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                                  dtype=jnp.float32, layout="halo",
                                  mesh=mesh))
    s = k.prep(lv.as_dict(), sigma=1.0)

    def step(s):
        return constrain(k._step(constrain(s, sh)), sh)

    b = collective_bytes(step, s)
    assert b <= STEP_BOUND, f"halo step collectives {b/1e6:.2f} MB > bound"


def test_halo_kkt_collective_bytes(halo_setup):
    lv, mesh, sh = halo_setup
    k = InPALMKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                                  dtype=jnp.float32, layout="halo",
                                  mesh=mesh))
    s = k.prep(lv.as_dict(), sigma=1.0)

    def kkt(s):
        return k._kkt(constrain(s, sh))

    b = collective_bytes(kkt, s)
    assert b <= KKT_BOUND, f"halo KKT collectives {b/1e6:.2f} MB > bound"


def test_halo_sgs_step_collective_bytes(halo_setup):
    """The sGS-inPALM step through the halo engine: sweep ppermutes plus
    the stencil halos must stay within one-slab economics."""
    lv, mesh, sh = halo_setup
    k = SgsKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                               dtype=jnp.float32, layout="halo", mesh=mesh))
    s = k.prep(lv.as_dict(), sigma=1.0)

    def step(s):
        return constrain(k._step(constrain(s, sh)), sh)

    b = collective_bytes(step, s)
    assert b <= STEP_BOUND + SWEEP_BOUND, (
        f"halo sGS step collectives {b/1e6:.2f} MB > bound"
    )


@pytest.mark.slow
def test_gspmd_vs_halo_ratio(halo_setup):
    """The halo engine must keep a large margin over the GSPMD layout (the
    reason it is the default mesh layout)."""
    lv, mesh, sh = halo_setup
    kd = InPALMKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                                   dtype=jnp.float32, layout="3d"))
    kh = InPALMKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                                   dtype=jnp.float32, layout="halo",
                                   mesh=mesh))
    sd = kd.prep(lv.as_dict(), sigma=1.0)
    sh_state = kh.prep(lv.as_dict(), sigma=1.0)

    def step_d(s):
        return constrain(kd._step(constrain(s, sh)), sh)

    def step_h(s):
        return constrain(kh._step(constrain(s, sh)), sh)

    bd = collective_bytes(step_d, sd)
    bh = collective_bytes(step_h, sh_state)
    assert bh * 5 <= bd, (
        f"halo ({bh/1e6:.2f} MB) lost its margin over GSPMD ({bd/1e6:.2f} MB)"
    )
