"""Anderson acceleration on the inPALM fixed-point tail (round 4).

Plain inPALM tail (1e-4 -> 1e-6) converges at the linear ADMM rate
(~650 iters/decade on example1 65^2x17); sigma/restart tuning measured
dead (scripts/refine_tail_experiment2.py). AA-II with small memory +
safeguard is the standard fixed-point accelerator for this regime (SCS
uses it for ADMM). Frozen sigma for a clean A/B.

RESULT (recorded 2026-08, example1 65^2x17 f64, tol 1e-4 -> 1e-6,
plain tail = 2350 T-evals):
  - safeguarded AA (m=10, residual-probe accept/reject): 2151 T-evals —
    the extrapolation works (>96% acceptance, ~2.2x fewer outer rounds)
    but the safeguard probe doubles the per-round cost;
  - probe-free AA (accept unconditionally, rollback on >2% residual
    growth; m=10): 2100 T-evals, zero rollbacks.
Net gain 8-11% in all variants: the ADMM operator's slow spectrum is not
low-dimensional here, so small-memory extrapolation barely bites. NOT
integrated into the drivers — the cost/complexity is not worth <15%.
The remaining tail lever is per-iteration cost (f32-pair arithmetic for
the emulated-f64 tail), not iteration count.

  python scripts/anderson_tail_experiment.py [problem] [m]
"""
import os
import sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from dotsocp.algorithms.core import LevelConfig
from dotsocp.algorithms.variants import InPALMKernels
from dotsocp.multilevel.level import initial_scaling, initialize
from dotsocp.models.examples import get_example_2d

PROBLEM = sys.argv[1] if len(sys.argv) > 1 else "example1"
N, NT = 65, 17
M = int(sys.argv[2]) if len(sys.argv) > 2 else 10   # AA memory
REG = 1e-10

rho0, rho1 = get_example_2d(PROBLEM, N, N)
lv = initialize(rho0, rho1, NT, dtype=jnp.float64)
initial_scaling(lv, scaling=True)
cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9, dtype=jnp.float64,
                  layout="flat")
k = InPALMKernels(cfg)
s0 = k.prep(lv.as_dict(), sigma=1.0)

step = jax.jit(k._step)
kkt = jax.jit(lambda st: jnp.stack(list(map(jnp.asarray, [
    k._kkt(st)["kkt_org"][i] for i in (0, 2, 5, 6)]))))

ITER_FIELDS = ("phi", "q", "z", "alpha", "beta")


def pack(st):
    leaves = []
    for f in ITER_FIELDS:
        leaves += [x.ravel() for x in jax.tree.leaves(getattr(st, f))]
    return jnp.concatenate(leaves)


def unpack(st, vec):
    out = {}
    off = 0
    for f in ITER_FIELDS:
        obj = getattr(st, f)
        leaves, treedef = jax.tree.flatten(obj)
        new = []
        for x in leaves:
            n = x.size
            new.append(vec[off:off + n].reshape(x.shape))
            off += n
        out[f] = jax.tree.unflatten(treedef, new)
    return st._replace(**out)


T = jax.jit(lambda st, v: pack(step(unpack(st, v))))

# -------- head: run to 1e-4 --------
st = s0
it = 0
while True:
    for _ in range(10):
        st = step(st)
    it += 10
    r = np.asarray(kkt(st))
    if r.max() < 1e-4 or it > 6000:
        break
print(f"{PROBLEM}: head reached {r.max():.2e} at iter {it}", flush=True)
v0 = pack(st)

# -------- plain tail --------
v = v0
tail = 0
while tail < 12000:
    for _ in range(10):
        v = T(st, v)
    tail += 10
    r = np.asarray(kkt(unpack(st, v)))
    if r.max() < 1e-6:
        break
print(f"  plain tail: {tail} iters (kkt {r.max():.2e})", flush=True)

# -------- AA-II tail with safeguard --------
v = v0
g = T(st, v)
r = g - v
R_hist, G_hist = [], []
best_res = float(jnp.linalg.norm(r))
tail = 1
accepted = rejected = 0
v_prev, g_prev, r_prev = v, g, r
v = g  # first step plain
while tail < 12000:
    g = T(st, v)
    r = g - v
    rn = float(jnp.linalg.norm(r))
    # history update (differences)
    R_hist.append(r - r_prev)
    G_hist.append(g - g_prev)
    if len(R_hist) > M:
        R_hist.pop(0); G_hist.pop(0)
    r_prev, g_prev = r, g
    # AA candidate
    Rm = jnp.stack(R_hist, axis=1)           # (n, m)
    rhs = Rm.T @ r
    A = Rm.T @ Rm + REG * jnp.eye(Rm.shape[1])
    gam = jnp.linalg.solve(A, rhs)
    v_aa = g - jnp.stack(G_hist, axis=1) @ gam
    # safeguard: residual of AA candidate must beat plain residual decay
    g_aa = T(st, v_aa)
    r_aa_n = float(jnp.linalg.norm(g_aa - v_aa))
    tail += 1  # the probe T-eval counts as work
    if r_aa_n < rn:
        v = v_aa
        accepted += 1
        # reuse the probe: v <- g_aa directly (one more free step)
        R_hist.append((g_aa - v_aa) - r_prev)
        G_hist.append(g_aa - g_prev)
        if len(R_hist) > M:
            R_hist.pop(0); G_hist.pop(0)
        r_prev, g_prev = g_aa - v_aa, g_aa
        v = g_aa
    else:
        v = g
        rejected += 1
    tail += 1
    if tail % 50 < 2:
        res = np.asarray(kkt(unpack(st, v)))
        if res.max() < 1e-6:
            break
print(f"  AA(m={M}) tail: {tail} iters (kkt {res.max():.2e}; "
      f"acc {accepted} rej {rejected})", flush=True)
