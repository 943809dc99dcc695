"""Benchmark: the reference's headline configs on one accelerator.

Three metrics, each best-of-N with every pass recorded (N and the raw
times land in the JSON, so warm-cache variance is visible in the artifact):

1. headline — ``demo_dot2d.m:10-17,55-60``: nt=33, nx=ny=129, tol=1e-4,
   3 levels, inPALM, DOTmark-4stitch densities (bundled/procedural tiles
   when the DOTmark assets are absent — the source is stamped into the
   result).
2. scale   — the BASELINE.json north-star class (512x512x64): 513x513x65,
   tol=1e-4, 3 levels, inPALM, flat layout, device driver.
3. wdot2d  — ``demo_wdot2d.m:10-17,67``: 129^3, tol=1e-3, 3 levels,
   love-heart barrier (analytic), weighted inPALM.
4. refine  — the NORTH-STAR metric (BASELINE.json: "wall-clock to KKT tol
   1e-6"): the headline config continued to KKT 1e-6 via the f64 IR-DCT
   tail (``refine_tol=1e-6``, stop rule ``solver_socp_inPALM.m:287``).
5. dot1d   — ``demo_dot1d.m:10-17``: nt=33, nx=1025, tol=1e-5 (the
   reference's own 1D tolLowerBound, ``solver_dotsocp1d.m:121``), 3
   levels, Gaussian pair, mixed-precision path (f32 multilevel + f64
   IR-DCT tail to 1e-5).

The scale metric additionally stamps per-phase GB/s vs roofline
(``utils/profiling.profile_phases`` on the finest level — the
BASELINE.json "kernel efficiency" target, ``solver_socp_inPALM.m:339-341``
taxonomy) into ``scale_513_phases``.

Timeout-proofing: each metric runs in its OWN subprocess under a
per-metric wall budget, one at a time (one process per device: a JAX
process reserves most of the card's memory), and the orchestrator, which
never imports JAX, prints-and-flushes the FULL cumulative JSON line after
EVERY metric completes (headline first). A stalled or crashed metric is
killed by exact PID, recorded as ``<metric>_error``, and the remaining
metrics still run. The last stdout line is therefore always the most
complete parseable result, even if the whole process is later killed.
Every metric records the device it ran on (``platform``, ``device_kind``,
``device_count``); the orchestrator records the card's name and power
limit from ``nvidia-smi`` (``gpu``).

Knobs: DOTSOCP_BENCH_SCALE=0 / DOTSOCP_BENCH_WDOT=0 /
DOTSOCP_BENCH_REFINE=0 / DOTSOCP_BENCH_DOT1D=0 skip those metrics; DOTSOCP_BENCH_BUDGET=<s> per-metric wall budget
(default 1200); DOTSOCP_BENCH_DEADLINE=<s> global soft deadline
(default 4500) after which remaining metrics are skipped rather than
started.

All metrics run f32 on the device-resident driver (the production path).
On a cold compilation cache the level executables compile concurrently up
front (opts["prewarm"]); D/E/tol/sigma are traced into the solver state,
so the compiled chunks are shape-only and reruns hit the persistent cache.

vs_baseline compares against the single-host CPU float64 reference-
equivalent run recorded in BASELINE.md (this repo's stand-in for the
unpublished MATLAB numbers; same algorithm, same tolerance, same
iteration counts).
"""
import json
import os
import subprocess
import sys
import time

# Our own CPU f64 3-level run of the headline config (see BASELINE.md,
# "measured stand-in baseline") — reproduce with: python bench.py --cpu
BASELINE_CPU_SECONDS = 52.7

NT, NX, NY = 33, 129, 129
TOL = 1e-4
LEVELS = 3
SCALE_N, SCALE_NT = 513, 65

_RESULT_PREFIX = "##BENCH_METRIC## "


def _best_of(fn, repeats):
    """Run ``fn(rep)`` ``repeats`` times; return (best_time, info_of_best,
    all_times). Pass 0 warms the jit caches."""
    best, info, times = None, None, []
    for rep in range(repeats):
        out = fn(rep)
        t = out["total_time"]
        times.append(round(t, 3))
        if best is None or t < best:
            best, info = t, out
    return best, info, times


def run(dtype, repeats=2, verbose=False, driver="device"):
    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_2d("DOTmark_4stitch", NX, NY)

    def one(rep):
        out, hml, h = solve_dot(
            rho0, rho1, NT, LEVELS,
            {"tol": TOL, "maxit": 3000, "driver": driver,
             "prewarm": rep == 0 and driver != "host"},
            "inPALM", dtype=dtype, verbose=verbose,
        )
        return out

    return _best_of(one, repeats)


def run_wdot(dtype, time_limit=900.0, repeats=2):
    """Secondary metric: the weighted headline (129^2 x 129, tol 1e-3,
    3 levels, inPALM, love-heart barrier — ``demo_wdot2d.m:10-17,67``)."""
    from dotsocp.models.wdot2d import (
        barrier_love_heart,
        ensure_barrier_validity,
        get_example_w2d,
        get_weight_by_barrier,
    )
    from dotsocp.multilevel.solve import solve_dot

    n = 129
    rho0, rho1 = get_example_w2d("love-heart", n, n)
    barrier = barrier_love_heart()
    weight = get_weight_by_barrier(n, n, n, barrier)
    rho0, rho1, _ = ensure_barrier_validity(rho0, rho1, barrier)

    def one(rep):
        out, _, _ = solve_dot(
            rho0, rho1, n, 3,
            {"tol": 1e-3, "driver": "device", "time_limit": time_limit,
             "prewarm": rep == 0},
            "inPALM", weight=weight, barrier=barrier, dtype=dtype,
            verbose=False,
        )
        return out

    return _best_of(one, repeats)


def run_refine(dtype, repeats=2):
    """North-star metric: headline config to KKT tol 1e-6 (f32 multilevel
    + f64 IR-DCT tail; BASELINE.json ``metric``)."""
    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_2d("DOTmark_4stitch", NX, NY)

    def one(rep):
        out, hml, h = solve_dot(
            rho0, rho1, NT, LEVELS,
            {"tol": TOL, "maxit": 6000, "driver": "device",
             "refine_tol": 1e-6, "prewarm": rep == 0},
            "inPALM", dtype=dtype, verbose=False,
        )
        out["final_kkt"] = h["kkt"][-1]
        return out

    return _best_of(one, repeats)


def run_dot1d(dtype, repeats=2):
    """The 1D reference config (``demo_dot1d.m:10-17``): 1025x33, 3
    levels, tol 1e-5 via the mixed-precision path (tolLowerBound=1e-5 is
    the reference's own floor, ``solver_dotsocp1d.m:121``)."""
    from dotsocp.models.examples import get_example_1d
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_1d("gaussian", 1025)

    def one(rep):
        out, hml, h = solve_dot(
            rho0, rho1, NT, LEVELS,
            {"tol": TOL, "maxit": 3000, "driver": "device",
             "refine_tol": 1e-5, "prewarm": rep == 0},
            "inPALM", dtype=dtype, verbose=False,
        )
        out["final_kkt"] = h["kkt"][-1]
        return out

    return _best_of(one, repeats)


def run_scale(dtype, time_limit=1200.0, repeats=2):
    """The BASELINE 512x512x64-class config as a captured end-to-end
    metric: 513x513x65, tol 1e-4, 3 levels (129^2x17 -> 257^2x33 ->
    513^2x65), inPALM on the device driver. Reference anchor: the hot loop of
    ``solver_socp_inPALM.m:192-216`` at BASELINE.json scale."""
    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.solve import solve_dot

    rho0, rho1 = get_example_2d("DOTmark_4stitch", SCALE_N, SCALE_N)

    prof = {}

    def one(rep):
        out, _, h = solve_dot(
            rho0, rho1, SCALE_NT, 3,
            {"tol": TOL, "maxit": 3000, "driver": "device",
             "time_limit": time_limit, "prewarm": rep == 0,
             # per-phase GB/s vs roofline, captured on the cold rep (its
             # wall time is compile-dominated anyway; best-of ignores it)
             "profile": rep == 0},
            "inPALM", dtype=dtype, verbose=False,
        )
        out["final_kkt"] = h["kkt"][-1]
        for lvl in out["levels"]:  # keep the finest level's phase table
            if "phases" in lvl:
                prof["phases"] = lvl["phases"]
        return out

    best, info, times = _best_of(one, repeats)
    info["profile_phases"] = prof.get("phases")
    return best, info, times


def _child_metric(name):
    """Run one metric in this (child) process and print its result dict
    on a marker line. Any exception propagates -> nonzero rc, recorded by
    the orchestrator."""
    from dotsocp.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    dev = jax.devices()[0]
    fields = {}
    if name == "headline":
        from dotsocp.models.examples import density_source

        driver = os.environ.get("DOTSOCP_BENCH_DRIVER", "device")
        t, out, times = run(jnp.float32, driver=driver)
        fields = {
            "metric": "dot2d_dotmark_129x129x33_tol1e-4_3level_inpalm",
            "value": round(t, 3),
            "unit": "s",
            "vs_baseline": round(BASELINE_CPU_SECONDS / t, 2),
            "iters": sum(l["iters"] for l in out["levels"]),
            "mass_ok": bool(out["mass_ok"]),
            "driver": driver,
            "repeats": len(times),
            "times": times,
            "density_source": density_source("DOTmark_4stitch"),
        }
    elif name == "scale":
        ts, outs, tss = run_scale(jnp.float32)
        fin = next(l for l in reversed(outs["levels"])
                   if not l.get("refine"))
        fields = {
            "scale_513x513x65_tol1e-4_s": round(ts, 3),
            "scale_513_iters": sum(l["iters"] for l in outs["levels"]),
            "scale_513_ms_per_iter": round(
                1e3 * fin["time"] / max(fin["iters"], 1), 2
            ),
            "scale_513_mass_ok": bool(outs["mass_ok"]),
            "scale_513_final_kkt_max": float(
                np.max(np.asarray(outs["final_kkt"])[[0, 2, 5, 6]])
            ),
            "scale_513_times": tss,
        }
        phases = outs.get("profile_phases")
        if phases:
            fields["scale_513_phases"] = {
                k: {m: round(float(v), 2) for m, v in row.items()}
                for k, row in phases.items()
            }
    elif name == "refine":
        jax.config.update("jax_enable_x64", True)
        tr, outr, trs = run_refine(jnp.float32)
        tail = [l for l in outr["levels"] if l.get("refine")]
        fields = {
            "dot2d_tol1e-6_s": round(tr, 3),
            "dot2d_tol1e-6_iters": sum(l["iters"] for l in outr["levels"]),
            "dot2d_tol1e-6_tail_s": round(sum(l["time"] for l in tail), 3),
            "dot2d_tol1e-6_tail_iters": sum(l["iters"] for l in tail),
            "dot2d_tol1e-6_final_kkt": float(
                np.max(np.asarray(outr["final_kkt"])[[0, 2, 5, 6]])
            ),
            "dot2d_tol1e-6_mass_ok": bool(outr["mass_ok"]),
            "dot2d_tol1e-6_times": trs,
        }
    elif name == "dot1d":
        jax.config.update("jax_enable_x64", True)
        t1, out1, t1s = run_dot1d(jnp.float32)
        fields = {
            "dot1d_1025x33_tol1e-5_s": round(t1, 3),
            "dot1d_iters": sum(l["iters"] for l in out1["levels"]),
            "dot1d_final_kkt": float(
                np.max(np.asarray(out1["final_kkt"])[[0, 2, 5, 6]])
            ),
            "dot1d_mass_ok": bool(out1["mass_ok"]),
            "dot1d_times": t1s,
        }
    elif name == "wdot":
        from dotsocp.models.wdot2d import wdot_provenance

        tw, outw, tws = run_wdot(jnp.float32)
        fields = {
            "wdot2d_129x129x129_tol1e-3_s": round(tw, 3),
            "wdot2d_iters": sum(l["iters"] for l in outw["levels"]),
            "wdot2d_mass_ok": bool(outw["mass_ok"]),
            "wdot2d_times": tws,
            "wdot2d_source": wdot_provenance("love-heart"),
        }
    else:
        raise SystemExit(f"unknown metric {name!r}")
    fields[f"{name}_device"] = {"platform": dev.platform,
                                "device_kind": dev.device_kind,
                                "device_count": len(jax.devices())}
    print(_RESULT_PREFIX + json.dumps(fields), flush=True)


def _run_metric_subprocess(name, budget, result):
    """Spawn ``bench.py --metric name`` under a wall budget; merge its
    marker-line dict into ``result``. Timeouts kill the exact child PID
    (never a pattern) and record an error field instead of sinking the
    bench."""
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--metric", name],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            timeout=budget, text=True,
        )
    except subprocess.TimeoutExpired:
        result[f"{name}_error"] = f"timeout after {budget:.0f}s"
        return False
    payload = None
    for line in proc.stdout.splitlines():
        if line.startswith(_RESULT_PREFIX):
            payload = line[len(_RESULT_PREFIX):]
    if proc.returncode != 0 or payload is None:
        tail = "; ".join(proc.stdout.strip().splitlines()[-3:])
        result[f"{name}_error"] = (
            f"rc={proc.returncode} after {time.time() - t0:.0f}s: {tail[-400:]}"
        )
        return False
    result.update(json.loads(payload))
    result[f"{name}_wall_s"] = round(time.time() - t0, 1)
    return True


def gpu_name_and_power_limit():
    """``nvidia-smi``'s name and power limit of each card (one line per
    card), read by a child process that never touches JAX; None where
    there is no nvidia-smi."""
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


def main():
    if "--cpu" in sys.argv:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        t, out, _ = run(jnp.float64, repeats=1, verbose=True, driver="host")
        print(f"CPU f64 3-level solve: {t:.1f}s")
        return
    if "--metric" in sys.argv:
        _child_metric(sys.argv[sys.argv.index("--metric") + 1])
        return

    budget = float(os.environ.get("DOTSOCP_BENCH_BUDGET", "1200"))
    deadline = time.time() + float(
        os.environ.get("DOTSOCP_BENCH_DEADLINE", "4500")
    )
    env = os.environ.get
    metrics = [
        ("headline", True),
        ("refine", env("DOTSOCP_BENCH_REFINE", "1") != "0"),
        ("scale", env("DOTSOCP_BENCH_SCALE", "1") != "0"),
        ("wdot", env("DOTSOCP_BENCH_WDOT", "1") != "0"),
        ("dot1d", env("DOTSOCP_BENCH_DOT1D", "1") != "0"),
    ]

    result = {"gpu": gpu_name_and_power_limit()}
    for name, enabled in metrics:
        if not enabled:
            continue
        remaining = deadline - time.time()
        if name != "headline" and remaining < 60:
            result[f"{name}_error"] = "skipped: global deadline reached"
        else:
            _run_metric_subprocess(name, min(budget, max(remaining, 120)),
                                   result)
        # Flush the full cumulative line after EVERY metric so a later
        # stall/kill still leaves the completed metrics on stdout.
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
