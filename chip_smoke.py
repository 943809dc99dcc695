"""GPU smoke test of the multilevel DOT solver: one process, one card.

    python chip_smoke.py           # one card: the phases below
    python chip_smoke.py --multi   # four cards: the mesh and fleet paths only

One-card phases, each printing one JSON line (the card's ``nvidia-smi``
name and power limit sit beside every time):

1. ``device``  platform, device kind, count and card.
2. ``solve``   the main path through ``solve_dot`` on the device driver:
   DOTmark_4stitch 129^2x33 continued to KKT 1e-6 by the f64 tail, the
   weighted love-heart 129^3, and DOTmark_4stitch 513^2x65 (3 levels,
   inPALM, f32, tol 1e-4). Each solve runs cold (compiling) and warm;
   per level it prints iterations, warm wall time and the cold-minus-warm
   time (compilation), and ``peak_bytes_in_use`` after the solve. The
   small solves run first and nothing larger runs before them, so each
   peak is that solve's own.
3. ``copy_rate`` a large device copy's rate beside the published peak
   bandwidth, then the warm solves' per-phase rates on the finest level
   (``profile_phases``) as shares of both.
4. ``parity``  every operator of the step at 513^2x65, GPU f32 against a
   float64 reference on the CPU device of the same process.
5. ``sgs``     sGS-inPALM at 129^2x33 to tol 1e-3, and the red-black sweep's
   rate at 513^2x65.

``--multi`` runs only: a halo-engine solve on a (y=2, x=2) mesh at
513^2x65 against the same solve on one card, and the sharded
``solve_fleet`` of four DOTmark pairs at 129^2x33 against sequential mode
on one card.

The last line is ``{"ok": true, "device": {...}}``. A failed check exits
non-zero without it; so does a process where JAX finds no GPU, or a
directory without the ``dotsocp`` package beside this script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

KKT_DOT = [0, 2, 5, 6]      # KKT entries {1,3,6,7} stop an unweighted solve
KKT_WEIGHTED = [0, 2, 5]    # {1,3,6} for the weighted family
TOL_ELEMENTWISE = 1e-5      # elementwise and stencil ops, f32 vs f64
TOL_DCT = 1e-4              # HIGHEST-precision f32 DCT solve sits near 1e-5;
                            # a TF32 one near 1e-3
TOL_TRANSFER = 1e-6         # restriction / prolongation matmuls

CARD = None  # nvidia-smi "name, power.limit", set in main()


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_name_and_power_limit():
    """``nvidia-smi``'s name and power limit, one card per line (a child
    process that never touches JAX); None where nvidia-smi is missing."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() if proc.returncode == 0 else None


def result_line(device, count: int) -> dict:
    """The contract's last line, from the device JAX reports."""
    return {"ok": True, "device": {"platform": device.platform,
                                   "kind": device.device_kind,
                                   "count": int(count)}}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| over every leaf (host float64)."""
    import jax

    worst = 0.0
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        g = np.asarray(g, np.float64)
        r = np.asarray(r, np.float64)
        check(g.shape == r.shape, f"shape {g.shape} != reference {r.shape}")
        check(np.isfinite(g).all(), "non-finite values")
        worst = max(worst, float(np.max(np.abs(g - r)) / max(np.max(np.abs(r)), 1e-300)))
    return worst


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def copy_rate_gbps(n_bytes: int = 1 << 30, reps: int = 20) -> float:
    """Achieved read+write rate of ``x + 1`` over an ``n_bytes`` f32 array."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x + 1.0)
    x = jax.block_until_ready(f(jnp.zeros((n_bytes // 4,), jnp.float32)))
    t0 = time.perf_counter()
    for _ in range(reps):
        x = f(x)
    jax.block_until_ready(x)
    return 2.0 * n_bytes * reps / (time.perf_counter() - t0) / 1e9


def phase_device():
    import jax
    import jax.numpy as jnp

    from dotsocp.algorithms.core import LevelConfig, _zstep_kernel_applies
    from dotsocp.ops.geometry import Geometry

    dev = jax.devices()[0]
    flat32 = LevelConfig(geom=Geometry(nt=5, space=(9, 9)), D=1.0, E=1.0,
                         dtype=jnp.float32, layout="flat")
    active = _zstep_kernel_applies(flat32)
    emit("device", platform=dev.platform, device_kind=dev.device_kind,
         count=len(jax.devices()), zstep_kernel_active=active)
    check(active, "the z-step kernel is not selected on this GPU")


def phase_copy_rate(tables):
    """Copy rate, then each stored phase table as shares of it."""
    import jax

    from dotsocp.utils.profiling import roofline_gbps

    rate = copy_rate_gbps()
    emit("copy_rate", copy_gbps=rate,
         published_gbps=roofline_gbps(jax.devices()[0]))
    for case, phases in tables.items():
        emit("phase_rates", case=case, phases=_phase_rows(phases, rate))
    return rate


# ---------------------------------------------------------------------------
# 2. main path
# ---------------------------------------------------------------------------

class _CompileClock:
    """Seconds XLA spent in backend compilation (JAX's monitoring event)."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kwargs):
        if event == self.EVENT:
            self.total += duration


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _phase_rows(phases, copy_gbps):
    rows = {}
    for name, row in phases.items():
        r = {"ms": row["ms"]}
        if "gbps" in row:
            r["gbps"] = row["gbps"]
            r["pct_published"] = row.get("pct_roofline")
            if copy_gbps:
                r["pct_copy"] = 100.0 * row["gbps"] / copy_gbps
        rows[name] = r
    return rows


def run_solve(case, rho0, rho1, nt, levels, opts, method, kkt_idx, tol,
              clock, tables=None, weight=None, barrier=None):
    """Cold then warm ``solve_dot``; checks mass and final KKT <= tol. With
    ``tables``, the warm run also profiles its phases, and the finest
    level's table is stored there under ``case``."""
    import jax.numpy as jnp

    from dotsocp.multilevel.solve import solve_dot

    def solve(o):
        return solve_dot(rho0, rho1, nt, levels, o, method, weight=weight,
                         barrier=barrier, dtype=jnp.float32, verbose=False)

    c0 = clock.total
    t0 = time.perf_counter()
    cold, _, _ = solve(dict(opts))
    cold_wall = time.perf_counter() - t0
    compile_s = clock.total - c0
    peak = _peak_bytes()  # before the warm run's profiling buffers
    warm, _, hist = solve(dict(opts, profile=tables is not None))
    final = np.asarray(hist["kkt"][-1])
    kkt = float(np.max(final[kkt_idx]))
    levels_out = []
    for lc, lw in zip(cold["levels"], warm["levels"]):
        g = lw["geom"]
        levels_out.append({
            "level": lw["level"], "refine": bool(lw.get("refine", False)),
            "grid": [g.nt, *g.space], "iters": lw["iters"],
            "cold_iters": lc["iters"], "wall_s": lw["time"],
            "cold_minus_warm_s": lc["time"] - lw["time"],
        })
    if tables is not None:
        tables[case] = [l for l in warm["levels"] if "phases" in l][-1]["phases"]
    emit("solve", case=case, method=method, levels=levels_out,
         warm_total_s=sum(l["time"] for l in warm["levels"]),
         cold_process_wall_s=cold_wall, backend_compile_s=compile_s,
         final_kkt=kkt, tol=tol, mass_ok=bool(warm["mass_ok"]),
         peak_bytes_in_use=peak)
    check(bool(warm["mass_ok"]), f"{case}: mass conservation violated")
    check(kkt <= tol, f"{case}: final KKT {kkt:.3e} above tol {tol:g}")


def phase_solve(clock, tables, n=513, nt=65, wn=129, hn=129, hnt=33):
    from dotsocp.models import wdot2d as W
    from dotsocp.models.examples import get_example_2d

    r0, r1 = get_example_2d("DOTmark_4stitch", hn, hn)
    run_solve("dotmark_%dx%dx%d_refine1e-6" % (hn, hn, hnt), r0, r1, hnt, 3,
              {"tol": 1e-4, "maxit": 6000, "driver": "device",
               "refine_tol": 1e-6}, "inPALM", KKT_DOT, 1e-6, clock)

    w0, w1 = W.get_example_w2d("love-heart", wn, wn)
    barrier = W.barrier_love_heart()
    weight = W.get_weight_by_barrier(wn, wn, wn, barrier)
    w0, w1, _ = W.ensure_barrier_validity(w0, w1, barrier)
    run_solve("weighted_love_heart_%d^3" % wn, w0, w1, wn, 3,
              {"tol": 1e-3, "driver": "device"}, "inPALM", KKT_WEIGHTED,
              1e-3, clock, tables, weight=weight, barrier=barrier)

    r0, r1 = get_example_2d("DOTmark_4stitch", n, n)
    run_solve("dotmark_%dx%dx%d" % (n, n, nt), r0, r1, nt, 3,
              {"tol": 1e-4, "maxit": 3000, "driver": "device"}, "inPALM",
              KKT_DOT, 1e-4, clock, tables)


# ---------------------------------------------------------------------------
# 3. operator parity
# ---------------------------------------------------------------------------

def phase_parity(n=513, nt=65, seed=0):
    """The flat-layout operators the solver runs (GPU, f32) against the
    shaped float64 operators on the CPU, on identical f32-rounded inputs."""
    import jax
    import jax.numpy as jnp

    from dotsocp.multilevel import transfer as T
    from dotsocp.ops import cone, grad as G
    from dotsocp.ops.engine import make_ops
    from dotsocp.ops.geometry import Geometry
    from dotsocp.ops.poisson import make_dct_poisson
    from dotsocp.ops.sgs import make_sgs
    from dotsocp.ops.staggered import Staggered
    from dotsocp.ops.zstep_triton import make_zstep

    geom = Geometry(nt=nt, space=(n, n))
    cgeom = geom.coarse()
    rng = np.random.default_rng(seed)

    def rnd(shape, positive=False):
        x = rng.standard_normal(shape)
        return (np.exp(0.3 * x) if positive else x).astype(np.float32)

    def stag(g, positive=False):
        return Staggered(q0=rnd(g.q0_shape, positive),
                         bs=tuple(rnd(g.b_shape(a), positive)
                                  for a in range(g.ndim_space)))

    inputs = {"phi": rnd(geom.phi_shape), "rhs": rnd(geom.phi_shape),
              "z": rnd(geom.z_shape), "q": stag(geom),
              "rho": rnd(geom.space, positive=True),
              "w": stag(geom, positive=True),
              "phi_c": rnd(cgeom.phi_shape), "beta_c": rnd(cgeom.z_shape)}
    sbf, sd = 0.7, 0.3
    ops = make_ops(geom, jnp.float32, "flat")
    pois32 = ops.make_poisson(1.0)
    sgs32 = make_sgs(geom, D=1.0, dtype=jnp.float32)
    accel, cpu = jax.devices()[0], jax.devices("cpu")[0]
    with jax.default_device(cpu):  # the reference's constants live there
        pois64 = make_dct_poisson(geom, D=1.0, dtype=jnp.float64)
        sgs64 = make_sgs(geom, D=1.0, dtype=jnp.float64)
    flat, fz, fs = ops.phi_to_internal, ops.z_to_internal, ops.stag_to_internal
    zstep_kernel = make_zstep(nt, ops.S, ops.strides)

    def zstep_xla(q, z):
        return ops.z_from_internal(cone.proj_soc(ops.bfd(fs(q), sbf, sd) - fz(z)))

    def zstep_triton(q, z):
        qi = fs(q)
        return ops.z_from_internal(zstep_kernel(qi.q0, qi.bs, fz(z), sbf, sd))

    # name: (operands, the solver's GPU form, the shaped f64 reference, limit)
    cases = {
        "proj_soc": (("z",), lambda z: ops.z_from_internal(cone.proj_soc(fz(z))),
                     cone.proj_soc, TOL_ELEMENTWISE),
        "bfd": (("q",), lambda q: ops.z_from_internal(ops.bfd(fs(q), sbf, sd)),
                lambda q: cone.bfd(geom, q, sbf, sd), TOL_ELEMENTWISE),
        "bfd_T": (("z",), lambda z: ops.stag_from_internal(ops.bfd_T(fz(z), sbf)),
                  lambda z: cone.bfd_T(geom, z, sbf), TOL_ELEMENTWISE),
        "zstep_xla": (("q", "z"), zstep_xla,
                      lambda q, z: cone.proj_soc(cone.bfd(geom, q, sbf, sd) - z),
                      TOL_ELEMENTWISE),
        "zstep_triton": (("q", "z"), zstep_triton,
                         lambda q, z: cone.proj_soc(cone.bfd(geom, q, sbf, sd) - z),
                         TOL_ELEMENTWISE),
        "grad": (("phi",), lambda p: ops.stag_from_internal(ops.grad(flat(p))),
                 lambda p: G.grad(geom, p), TOL_ELEMENTWISE),
        "grad_T": (("q",), lambda q: ops.phi_from_internal(ops.grad_T(fs(q))),
                   lambda q: G.grad_T(geom, q), TOL_ELEMENTWISE),
        "dct_poisson_solve": (
            ("rhs",), lambda r: ops.phi_from_internal(pois32.solve(flat(r), scale=0.5)),
            lambda r: pois64.solve(r, scale=0.5), TOL_DCT),
        "sgs_sweep": (("phi", "rhs"), lambda p, r: sgs32.sweep(p, r, 1, d2=0.5),
                      lambda p, r: sgs64.sweep(p, r, 1, d2=0.5), TOL_ELEMENTWISE),
        "restrict_density": (("rho",), T.restrict_density, T.restrict_density,
                             TOL_TRANSFER),
        "restrict_staggered": (("w",), T.restrict_staggered,
                               T.restrict_staggered, TOL_TRANSFER),
        "restrict_staggered_log": (
            ("w",), lambda w: T.restrict_staggered(w, log_space=True),
            lambda w: T.restrict_staggered(w, log_space=True), TOL_TRANSFER),
        "prolong_phi": (("phi_c",), T.prolong_phi, T.prolong_phi, TOL_TRANSFER),
        "prolong_z_like": (("beta_c",), T.prolong_z_like, T.prolong_z_like,
                           TOL_TRANSFER),
    }
    errs, limits = {}, {}
    for name, (args, fn, ref, limit) in cases.items():
        x32 = [jax.device_put(inputs[a], accel) for a in args]
        x64 = [jax.device_put(jax.tree.map(lambda v: np.asarray(v, np.float64),
                                           inputs[a]), cpu) for a in args]
        got = jax.device_get(jax.jit(fn)(*x32))
        with jax.default_device(cpu):
            want = jax.device_get(jax.jit(ref)(*x64))
        errs[name], limits[name] = rel_err(got, want), limit
    # the surviving kernel against the plain XLA version, both on the card
    x32 = [jax.device_put(inputs[a], accel) for a in ("q", "z")]
    errs["zstep_triton_vs_xla"] = rel_err(jax.jit(zstep_triton)(*x32),
                                          jax.jit(zstep_xla)(*x32))
    limits["zstep_triton_vs_xla"] = TOL_ELEMENTWISE
    bad = {k: v for k, v in errs.items() if not v <= limits[k]}
    emit("parity", grid=[nt, n, n], max_rel_err=errs, limits=limits,
         failed=sorted(bad))
    check(not bad, f"operator parity above limit: {bad}")


# ---------------------------------------------------------------------------
# 4. sGS family
# ---------------------------------------------------------------------------

def phase_sgs(clock, copy_gbps, n=129, nt=33, big_n=513, big_nt=65):
    import jax.numpy as jnp

    from dotsocp.algorithms.core import LevelConfig
    from dotsocp.algorithms.variants import SgsKernels
    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.level import initial_scaling, initialize
    from dotsocp.utils.profiling import profile_phases

    r0, r1 = get_example_2d("DOTmark_4stitch", n, n)
    run_solve("sgs_inpalm_dotmark_%dx%dx%d" % (n, n, nt), r0, r1, nt, 3,
              {"tol": 1e-3, "driver": "device"}, "sGS-inPALM", KKT_DOT,
              1e-3, clock)

    r0, r1 = get_example_2d("DOTmark_4stitch", big_n, big_n)
    lv = initialize(r0, r1, big_nt, dtype=jnp.float32)
    initial_scaling(lv, scaling=True)
    k = SgsKernels(LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                               dtype=jnp.float32))
    phases = profile_phases(k, k.prep(lv.as_dict(), 0.1), iters=10)
    emit("sgs_sweep_rate", grid=[big_nt, big_n, big_n],
         phases=_phase_rows(phases, copy_gbps))
    check(all(np.isfinite(r["ms"]) for r in phases.values()),
          "sGS phase timing not finite")


# ---------------------------------------------------------------------------
# --multi: four cards
# ---------------------------------------------------------------------------

def phase_multi_halo(n=513, nt=65, maxit=200):
    """Halo-engine solve on a (y=2, x=2) mesh vs the same solve on one card."""
    import jax
    import jax.numpy as jnp

    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.solve import solve_dot
    from dotsocp.parallel.sharding import make_mesh

    mesh = make_mesh(4, axis_names=("y", "x"))
    ids = sorted(d.id for d in mesh.devices.flat)
    check(dict(mesh.shape) == {"y": 2, "x": 2} and len(set(ids)) == 4,
          f"mesh does not span four devices: {dict(mesh.shape)} {ids}")
    r0, r1 = get_example_2d("DOTmark_4stitch", n, n)
    opts = {"tol": 1e-4, "maxit": maxit, "driver": "device"}
    runs = {}
    for name, o in (("one_card", opts), ("mesh_2x2", dict(opts, mesh=mesh))):
        solve_dot(r0, r1, nt, 2, dict(o), "inPALM", dtype=jnp.float32,
                  verbose=False)  # compile
        out, hml, _ = solve_dot(r0, r1, nt, 2, dict(o), "inPALM",
                                dtype=jnp.float32, verbose=False)
        runs[name] = {
            "iters": [l["iters"] for l in out["levels"]],
            "wall_s": [l["time"] for l in out["levels"]],
            "kkt": np.asarray(hml["kkt"][-1])[KKT_DOT[:3]].tolist(),
            "mass_ok": bool(out["mass_ok"]),
        }
    one, four = runs["one_card"], runs["mesh_2x2"]
    emit("multi_halo", grid=[nt, n, n], levels=2, maxit=maxit,
         mesh=dict(mesh.shape), device_ids=ids, **runs)
    check(one["iters"] == four["iters"],
          f"halo trajectory diverged: {four['iters']} vs {one['iters']}")
    check(four["mass_ok"], "halo solve violates mass conservation")
    check(np.allclose(four["kkt"], one["kkt"], rtol=0.05, atol=1e-7),
          f"halo KKT {four['kkt']} vs one card {one['kkt']}")


def phase_multi_fleet(n=129, nt=33, levels=3, tol=1e-3):
    """Sharded ``solve_fleet`` of four DOTmark pairs vs sequential mode."""
    import jax.numpy as jnp

    from dotsocp.models.examples import get_example_2d
    from dotsocp.parallel.batch import solve_fleet

    pairs = [get_example_2d("DOTmark_4stitch", n, n,
                            stitch1_indices=tuple(np.roll([1, 2, 3, 4], s)),
                            stitch2_indices=tuple(np.roll([5, 6, 7, 8], s)))
             for s in range(4)]
    r0 = np.stack([p[0] for p in pairs])
    r1 = np.stack([p[1] for p in pairs])
    opts = {"tol": tol, "maxit": 3000}
    runs = {}
    for mode in ("sequential", "sharded"):
        t0 = time.perf_counter()
        runs[mode] = solve_fleet(r0, r1, nt, dict(opts), "inPALM",
                                 dtype=jnp.float32, level_n=levels,
                                 mode=mode, verbose=False)
        runs[mode]["process_wall_s"] = time.perf_counter() - t0
    seq, sh = runs["sequential"], runs["sharded"]
    rho_s, rho_h = np.asarray(seq["rho"]), np.asarray(sh["rho"])
    rel = [float(np.linalg.norm(rho_h[b] - rho_s[b]) / np.linalg.norm(rho_s[b]))
           for b in range(len(pairs))]
    emit("multi_fleet", grid=[nt, n, n], instances=len(pairs), tol=tol,
         modes={m: {"done": np.asarray(r["done"]).tolist(),
                    "kkt_max": np.max(np.asarray(r["kkt"])[:, KKT_DOT], axis=1).tolist(),
                    "solve_s": r["time"], "process_wall_s": r["process_wall_s"]}
                for m, r in runs.items()},
         rho_rel_l2=rel)
    for m, r in runs.items():
        check(bool(np.all(r["done"])), f"fleet {m}: not every instance converged")
    check(max(rel) < 5e-2, f"sharded fleet densities differ from sequential: {rel}")


# ---------------------------------------------------------------------------

def main(argv) -> int:
    global CARD
    multi = "--multi" in argv
    try:
        from dotsocp.utils.cache import enable_compilation_cache
    except ImportError as e:
        print(f"chip_smoke: the dotsocp package is not importable ({e}); "
              "run from a checkout of the repository", file=sys.stderr)
        return 2
    enable_compilation_cache()
    import jax

    jax.config.update("jax_enable_x64", True)  # the f64 tail and references
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX finds no GPU (platform "
              f"{devices[0].platform!r}); this test runs on the card only",
              file=sys.stderr)
        return 1
    CARD = card_name_and_power_limit()
    if multi:
        check(len(devices) >= 4, f"--multi needs four GPUs, found {len(devices)}")
        phases = [("multi_halo", phase_multi_halo),
                  ("multi_fleet", phase_multi_fleet)]
    else:
        clock = _CompileClock()
        tables, rate = {}, {}
        phases = [
            ("device", phase_device),
            ("solve", lambda: phase_solve(clock, tables)),
            ("copy_rate", lambda: rate.setdefault("copy", phase_copy_rate(tables))),
            ("parity", phase_parity),
            ("sgs", lambda: phase_sgs(clock, rate.get("copy"))),
        ]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # report every phase, then fail the run
            failed.append(name)
            emit("failed", failed_phase=name, error=f"{type(e).__name__}: {e}")
        emit("phase_done", name=name, wall_s=time.perf_counter() - t0)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(CARD, flush=True)
    print(json.dumps(result_line(devices[0], len(devices))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
