"""Top-level multilevel solver API — the equivalent of
``solver_dotsocp1d.m`` / ``solver_dotsocp2d.m`` / ``solver_wdotsocp2d.m`` in
one dimension-polymorphic entry point.

``solve_dot(rho0, rho1, nt, level_n, opts, method)`` builds the coarse
pyramid, runs the chosen algorithm per level with warm-started sigma and
E2 feedback, prolongates between levels, and recovers (rho, E, q).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..algorithms.core import LevelConfig
from ..algorithms.driver import SolveOptions
from ..algorithms.solvers import (
    AccADMMSolver,
    AccSgsADMMSolver,
    ALG2Solver,
    InPALMSolver,
    PALMSolver,
    SgsInPALMSolver,
)
from ..algorithms.variants import (
    AccADMMKernels,
    AccSgsADMMKernels,
    InPALMKernels,
    PALMKernels,
    SgsKernels,
)
from ..ops.cone import bfd_T
from ..ops.grad import grad
from ..ops.staggered import Staggered
from .level import (
    LevelVar,
    check_mass_conservation,
    initial_scaling,
    initialize,
    recover_org_var,
    recover_q_centered,
    recover_rho_e,
)
from .transfer import prolong_phi, prolong_z_like, restrict_density, restrict_staggered

DOT_METHODS = ("PALM", "inPALM", "ALG2", "acc-ADMM", "sGS-inPALM", "acc-sGS-ADMM")
WDOT_METHODS = ("inPALM", "ALG2", "acc-ADMM")

KKT_LEGEND = [
    "||A psi - q|| / (1 + ||A psi|| + ||q||)",
    "||B F q + d - z|| / (1 + ||d||)",
    "||A* alpha + c|| / (1 + ||c||)",
    "||z - Pi_Q(z - beta)|| / (1 + ||z|| + ||beta||)",
    "||F* B* beta + alpha|| / (1 + ||F* B* beta|| + ||alpha||)",
    "||alpha1 - Pi_+(alpha1 + f(q))|| / (1 + ||alpha1|| + ||f(q)||)",
    "||alpha2 - g(alpha1, q)|| / (1 + ||alpha2|| + ||g(alpha1, q)||)",
]

ADMM_MAXIT = 3000
SGS_MAXIT = 6000
WDOT_MAXIT = 10000
ALM_STEPSIZE = 1.9
ALG2_STEPSIZE = 1.0


def _is_sgs(method: str) -> bool:
    return method in ("sGS-inPALM", "acc-sGS-ADMM")


# jitted executables are expensive to rebuild (a fresh trace +
# compile-cache load of the device while_loop costs seconds), so
# kernels/driver objects are memoized across solve_dot calls. Keyed by every
# compile-relevant static; runtime-only options (sigma, time_limit) are
# refreshed on each hit.
import hashlib as _hashlib
import weakref as _weakref
from collections import OrderedDict as _OrderedDict

_SOLVER_CACHE: "_OrderedDict[tuple, object]" = _OrderedDict()
_SOLVER_CACHE_MAX = 10

# content digests of weight arrays, memoized per live array object. A
# content key (not id()) is required for correctness: weights are baked
# into the compiled kernels, and an id() key can serve a stale kernel when
# a collected array's address is reused by a different weight. The weak
# keying just avoids re-hashing the same live array on every level.
_WEIGHT_DIGESTS: "_weakref.WeakKeyDictionary" = _weakref.WeakKeyDictionary()


def _weight_digest(w) -> tuple:
    parts = []
    for leaf in jax.tree.leaves(w):
        dig = None
        try:
            dig = _WEIGHT_DIGESTS.get(leaf)
        except TypeError:  # np.ndarray leaves are not weak-referenceable
            pass
        if dig is None:
            dig = _hashlib.sha1(
                np.ascontiguousarray(np.asarray(leaf)).tobytes()
            ).hexdigest()
            try:
                _WEIGHT_DIGESTS[leaf] = dig
            except TypeError:
                pass
        parts.append(dig)
    return tuple(parts)


def _solver_cache_key(method, lv, o: SolveOptions, dtype, driver,
                      checkpoint_path, device_kw, layout,
                      mesh=None, dct_split=False):
    weight_key = None if lv.weight is None else _weight_digest(lv.weight)
    mesh_key = (
        None if mesh is None
        else (tuple(mesh.axis_names), tuple(mesh.shape.values()),
              tuple(d.id for d in mesh.devices.flat))
    )
    # D, E and tol are traced into the solver state (core.SolverState /
    # device_driver.LoopState), so they do NOT key the cache: one compiled
    # executable serves every level/problem with the same shapes.
    return (
        method, driver, lv.geom, float(o.tau),
        weight_key, bool(o.check_prim_dual_feas), str(jnp.dtype(dtype)),
        int(o.maxit), int(o.restart),
        float(o.rho), float(o.theta), bool(o.check_step_by_step),
        checkpoint_path, layout, mesh_key, str(dct_split),
        tuple(sorted((device_kw or {}).items())),
    )


def clear_solver_cache():
    _SOLVER_CACHE.clear()


def _build_solver(method: str, lv: LevelVar, o: SolveOptions, dtype,
                  driver: str = "auto", checkpoint_path=None,
                  device_kw=None,
                  reuse: bool = True, layout: str = "auto", mesh=None,
                  dct_split: bool = False):
    """driver: 'device' runs the whole level loop inside one jitted
    while_loop (one host round-trip per ~600 iterations — the production
    path); 'host' uses the readable host-orchestrated driver (needed
    for step-by-step checking). 'auto' picks device where supported.
    layout 'auto' packs the spatial axes flat (ops/engine.py) on one device;
    under a mesh it selects the halo engine (padded shard_map stencils +
    red-black halo sweep, ops/halo_engine.py — 25x less collective traffic
    than GSPMD on the odd grids); pass layout='3d' for the GSPMD fallback."""
    if mesh is not None:
        layout = "halo" if layout in ("auto", "halo") else "3d"
    elif layout == "halo":
        import warnings

        warnings.warn(
            "layout='halo' requires a mesh (opts={'mesh': ...}); "
            "falling back to the single-device 'flat' layout",
            stacklevel=2,
        )
        layout = "flat"
    if layout == "auto":
        layout = "flat"
    if reuse:
        key = _solver_cache_key(method, lv, o, dtype, driver,
                                checkpoint_path, device_kw,
                                layout, mesh, dct_split)
        cached = _SOLVER_CACHE.get(key)
        if cached is not None:
            _SOLVER_CACHE.move_to_end(key)
            solver = cached() if callable(cached) else cached
            # runtime-only fields (sigma warm start, remaining time budget)
            solver.opts = o
            return solver
    solver = _make_solver(method, lv, o, dtype, driver, checkpoint_path,
                          device_kw, layout, mesh, dct_split)
    if reuse:
        from .. import algorithms as _alg  # noqa: F401  (package anchor)
        from ..algorithms.device_driver import AccDeviceDriver, DeviceDriver

        if isinstance(solver, (DeviceDriver, AccDeviceDriver)):
            # device drivers are stateless per solve: cache the object
            _SOLVER_CACHE[key] = solver
        else:
            # host solvers carry per-solve state (sGS win-count history):
            # cache a factory that rebinds the (jit-caching) kernels
            kernels = solver.k
            cls = type(solver)
            _SOLVER_CACHE[key] = lambda: cls(kernels, o)
        while len(_SOLVER_CACHE) > _SOLVER_CACHE_MAX:
            _SOLVER_CACHE.popitem(last=False)
    return solver


def _make_solver(method: str, lv: LevelVar, o: SolveOptions, dtype,
                 driver: str = "auto", checkpoint_path=None,
                 device_kw=None,
                 layout: str = "flat", mesh=None, dct_split: bool = False):
    weighted = lv.weight is not None
    cfg = LevelConfig(
        geom=lv.geom,
        D=lv.D,
        E=lv.E,
        tau=o.tau,
        weighted=weighted,
        check_prim_dual_feas=o.check_prim_dual_feas,
        dtype=dtype,
        layout=layout,
        mesh=mesh if layout == "halo" else None,
        dct_split=dct_split,
    )
    w = lv.weight
    use_device = driver == "device" or mesh is not None or (
        driver == "auto" and not o.check_step_by_step
    )
    dev_kw = dict(device_kw or {})
    if mesh is not None:
        dev_kw["mesh"] = mesh
    if method in ("inPALM", "ALG2"):
        k = InPALMKernels(cfg, w)
        if use_device:
            from ..algorithms.device_driver import DeviceDriver

            return DeviceDriver(k, o, checkpoint_path=checkpoint_path,
                                **dev_kw)
        return (ALG2Solver if method == "ALG2" else InPALMSolver)(k, o)
    if method == "PALM":
        k = PALMKernels(cfg, w)
        if use_device:
            from ..algorithms.device_driver import DeviceDriver

            return DeviceDriver(k, o, checkpoint_path=checkpoint_path,
                                **dev_kw)
        return PALMSolver(k, o)
    if method == "acc-ADMM":
        if o.theta != 2.0:
            # non-Halpern Nesterov branch (host driver only)
            from ..algorithms.variants import AccADMMNesterovKernels

            return AccADMMSolver(
                AccADMMNesterovKernels(cfg, w, restart=o.restart, rho=o.rho,
                                       theta=o.theta), o
            )
        k = AccADMMKernels(cfg, w, restart=o.restart, rho=o.rho)
        if use_device:
            from ..algorithms.device_driver import AccDeviceDriver

            return AccDeviceDriver(k, o, checkpoint_path=checkpoint_path,
                                   **dev_kw)
        return AccADMMSolver(k, o)
    # sGS variants: the device drivers replicate the host win-count sigma
    # machinery exactly (tests/test_device_driver.py parity tests), so
    # 'auto' promotes them like the inPALM family; the host driver remains
    # the readable parity oracle (driver='host').
    if method == "sGS-inPALM":
        k = SgsKernels(cfg, w)
        if use_device:
            from ..algorithms.device_sgs import SgsDeviceDriver

            return SgsDeviceDriver(k, o, checkpoint_path=checkpoint_path,
                                   **dev_kw)
        return SgsInPALMSolver(k, o)
    if method == "acc-sGS-ADMM":
        k = AccSgsADMMKernels(cfg, w, restart=o.restart, rho=o.rho)
        if use_device:
            from ..algorithms.device_sgs import AccSgsDeviceDriver

            return AccSgsDeviceDriver(k, o, checkpoint_path=checkpoint_path,
                                      **dev_kw)
        return AccSgsADMMSolver(k, o)
    raise ValueError(f"unknown method {method!r}")


from functools import partial as _partial


@_partial(jax.jit, static_argnums=(0, 3))
def _jump_arrays(geom_f, phi_c, beta_c, weighted: bool, weight_f,
                 rho0_f, rho1_f):
    """Jitted prolongation + warm start (one dispatch instead of ~40 eager
    ops). Also rebuilds the fine-level c and fresh z on device, so no
    multi-MB host arrays cross to the device between levels."""
    phi_f = prolong_phi(phi_c)
    beta_f = prolong_z_like(beta_c)
    q = grad(geom_f, phi_f)
    alpha = bfd_T(geom_f, -beta_f, 1.0)
    if weighted:
        q = q / weight_f
        alpha = alpha / weight_f
    dtype = phi_f.dtype
    c = jnp.zeros(geom_f.phi_shape, dtype)
    c = c.at[0].set(-jnp.asarray(rho0_f, dtype) / jnp.asarray(geom_f.ht, dtype))
    c = c.at[-1].set(jnp.asarray(rho1_f, dtype) / jnp.asarray(geom_f.ht, dtype))
    z = jnp.zeros(geom_f.z_shape, dtype)
    return phi_f, beta_f, q, alpha, c, z


def _jump_next_level(lv: LevelVar, rho0_f, rho1_f, nt_f: int, dtype,
                     weight_f: Optional[Staggered] = None) -> LevelVar:
    """Prolongate (phi, beta), rebuild the fine model, and warm-start
    q = A phi, alpha = -(BF)^T beta (``jump_nextLevel.m``; weighted variant
    divides both by the fine weight)."""
    lv_f = initialize(rho0_f, rho1_f, nt_f, dtype=dtype, weight=weight_f)
    weighted = weight_f is not None
    w = weight_f if weighted else stg_ones_like_placeholder(lv_f.geom, dtype)
    phi_f, beta_f, q, alpha, c, z = _jump_arrays(
        lv_f.geom, lv.phi.astype(dtype), lv.beta.astype(dtype), weighted, w,
        jnp.asarray(rho0_f, dtype), jnp.asarray(rho1_f, dtype),
    )
    lv_f.phi = phi_f
    lv_f.beta = beta_f
    lv_f.q = q
    lv_f.alpha = alpha
    lv_f.c = c
    lv_f.z = z
    return lv_f


def stg_ones_like_placeholder(geom, dtype):
    from ..ops import staggered as stg

    return stg.ones(geom, dtype)


def _prewarm_levels(method, rho0s, rho1s, nts, weights, opts, dtype,
                    sigma0, tau, maxit, scaling, check_sbs, check_pdf,
                    level_n, verbose):
    """Compile every level's device-loop executable concurrently before the
    solve starts. The chunk executables are shape-only (D, E, tol, sigma are
    traced — see core.SolverState), so they can be built from the pyramid
    alone; a cold chunk compile takes seconds to minutes, and the levels
    overlap to ~the slowest one. Solver
    objects land in the module solver cache, so the subsequent solve reuses
    the exact jitted callables (zero-iteration warm call => jit cache hit)."""
    import threading

    sgs_method = _is_sgs(method)
    solvers = []
    states = []
    for lev in range(level_n):
        lev_method = method
        o = SolveOptions(
            tol=1e-4, maxit=maxit, sigma=sigma0, tau=tau,
            time_limit=3600.0, scaling=scaling,
            check_step_by_step=check_sbs, check_prim_dual_feas=check_pdf,
            restart=int(opts.get("restart", 100)),
            rho=float(opts.get("rho", 2.0)),
            theta=float(opts.get("theta", 2.0)),
        )
        if sgs_method and lev < level_n - 1:
            lev_method = "inPALM"
            o.maxit = ADMM_MAXIT
            o.tau = ALM_STEPSIZE
        lv = initialize(rho0s[lev], rho1s[lev], nts[lev], dtype=dtype,
                        weight=weights[lev])
        initial_scaling(lv, scaling)
        device_kw = {}
        if "chunk_iters" in opts:
            device_kw["chunk_iters"] = int(opts["chunk_iters"])
        if "max_chunks" in opts:
            device_kw["max_chunks"] = int(opts["max_chunks"])
        solver = _build_solver(lev_method, lv, o, dtype,
                               driver=str(opts.get("driver", "auto")),
                               device_kw=device_kw,
                               reuse=bool(opts.get("reuse_solvers", True)),
                               layout=str(opts.get("layout", "auto")),
                               mesh=opts.get("mesh"))
        chunk = getattr(solver, "_chunk", None)
        if chunk is None:
            continue  # host drivers compile per-call; nothing to prewarm
        solvers.append(solver)
        states.append(solver.init_loop_state(
            solver._init_extra(solver.k.prep(lv.as_dict(), o.sigma))
        ))

    t0 = time.monotonic()

    def warm(i):
        # zero-iteration chunk: full trace + compile, immediate loop exit
        jax.block_until_ready(
            solvers[i]._chunk(states[i], jnp.zeros((), jnp.int32))
        )

    threads = [threading.Thread(target=warm, args=(i,))
               for i in range(len(solvers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if verbose and solvers:
        print(f"prewarm: {len(solvers)} level executables compiled in "
              f"{time.monotonic() - t0:.1f}s")


def _cat_hist(hists):
    """Concatenate per-level histories with time/iter offsets
    (``solver_dotsocp2d.m:389-407``)."""
    out = {"kkt": [], "time": [], "iter": [], "pdGap": []}
    t_off = 0.0
    i_off = 0
    for h in hists:
        out["kkt"].append(h["kkt"])
        out["pdGap"].append(h["pdGap"])
        out["time"].append(h["time"] + t_off)
        out["iter"].append(h["iter"] + i_off)
        if len(h["time"]):
            t_off = out["time"][-1][-1]
            i_off = out["iter"][-1][-1]
    return {
        "kkt": np.concatenate(out["kkt"]) if out["kkt"] else np.zeros((0, 7)),
        "time": np.concatenate(out["time"]),
        "iter": np.concatenate(out["iter"]),
        "pdGap": np.concatenate(out["pdGap"]),
        "len": sum(len(h["iter"]) for h in hists),
    }


def solve_dot(
    rho0,
    rho1,
    nt: int,
    level_n: int = 1,
    opts: Optional[dict] = None,
    method: str = "inPALM",
    weight: Optional[Staggered] = None,
    barrier=None,
    dtype=None,
    verbose: bool = True,
):
    """Multilevel DOT-SOCP solve. ``weight`` switches to the weighted
    problem (wdot family). Returns (output, run_hist_ml, run_hist).

    output: rho (nt, *space), E (list per axis; Ex/Ey aliases in 2D), q0,
    b (list per axis), mass_ok, iters/time per level.
    """
    opts = dict(opts or {})
    weighted = weight is not None
    methods = WDOT_METHODS if weighted else DOT_METHODS
    if method not in methods:
        raise ValueError(f"method {method!r} not in {methods}")
    if not (isinstance(level_n, int) and level_n >= 1):
        raise ValueError("level_n must be a positive integer")

    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if opts.get("debug_nans"):
        # NaN tripwire (the in-place-MEX analogue of sanitizers the
        # reference lacks; SURVEY.md section 5)
        jax.config.update("jax_debug_nans", True)
    trace_dir = opts.get("trace_dir")
    if trace_dir:
        # jax.profiler trace of the whole solve (SURVEY.md section 5's
        # tracing mandate beyond the per-phase tables): view with
        # tensorboard/xprof. Started here and stopped in the finally
        # below so partial solves still flush a usable trace.
        jax.profiler.start_trace(str(trace_dir))
    try:
        return _solve_dot_impl(rho0, rho1, nt, level_n, opts, method,
                               weight=weight, barrier=barrier, dtype=dtype,
                               verbose=verbose)
    finally:
        if trace_dir:
            jax.profiler.stop_trace()


def _solve_dot_impl(rho0, rho1, nt, level_n, opts, method, weight=None,
                    barrier=None, dtype=None, verbose=True):
    weighted = weight is not None
    sgs_method = _is_sgs(method)
    if dtype == jnp.float32 and float(opts.get("tol", 1e-4)) < 5e-5 and verbose:
        print(
            "WARNING: float32 stalls around KKT ~1e-4; tolerances below "
            "5e-5 need dtype=jnp.float64 (enable jax x64)."
        )

    sgs_method = _is_sgs(method)
    tol = float(opts.get("tol", 1e-4))
    scaling = bool(opts.get("scaling", True))
    maxit = int(
        opts.get(
            "maxit",
            WDOT_MAXIT if weighted else (SGS_MAXIT if sgs_method else ADMM_MAXIT),
        )
    )
    sigma0 = float(opts.get("sigma", 0.1 if sgs_method else 1.0))
    time_limit = float(opts.get("time_limit", 3600.0))
    check_sbs = bool(opts.get("ifCheckStepByStep", False))
    check_pdf = bool(opts.get("checkPrimDualFeas", not weighted))

    if method in ("PALM", "inPALM", "sGS-inPALM"):
        tau = ALM_STEPSIZE
    elif method == "ALG2":
        tau = ALG2_STEPSIZE
    else:
        tau = 1.0  # acc-ADMM multiplier steps are unit

    # tolerance pyramid (``solver_dotsocp2d.m:124-130,166-178``)
    tol_factor = -1.0 if tol > 0.99e-3 else -0.5
    ndim = np.asarray(rho0).ndim
    tol_lower = 1e-5 if ndim == 1 else 1e-4

    rho0s = [None] * level_n
    rho1s = [None] * level_n
    nts = [0] * level_n
    tols = [0.0] * level_n
    weights = [None] * level_n
    rho0s[-1] = jnp.asarray(rho0, dtype)
    rho1s[-1] = jnp.asarray(rho1, dtype)
    nts[-1] = nt
    tols[-1] = tol
    weights[-1] = weight

    for lev in range(level_n - 2, -1, -1):
        nts[lev] = (nts[lev + 1] - 1) // 2 + 1
        tols[lev] = max(tols[lev + 1] * 2.0 ** tol_factor, tol_lower)
        r0 = restrict_density(rho0s[lev + 1])
        r1 = restrict_density(rho1s[lev + 1])
        if weighted:
            weights[lev] = restrict_staggered(
                weights[lev + 1], log_space=barrier is not None
            )
            if barrier is not None:
                from ..models.wdot2d import ensure_barrier_validity

                r0, r1, _ = ensure_barrier_validity(r0, r1, barrier)
                r0 = jnp.asarray(r0, dtype)
                r1 = jnp.asarray(r1, dtype)
            else:
                r0 = r0 / (r0.mean())
                r1 = r1 / (r1.mean())
        else:
            # renormalize to unit mean (``solver_dotsocp2d.m:174-178``)
            r0 = r0 / r0.mean()
            r1 = r1 / r1.mean()
        rho0s[lev] = r0
        rho1s[lev] = r1

    if opts.get("prewarm"):
        _prewarm_levels(method, rho0s, rho1s, nts, weights, opts, dtype,
                        sigma0, tau, maxit, scaling, check_sbs, check_pdf,
                        level_n, verbose)

    # multilevel loop
    lv = initialize(rho0s[0], rho1s[0], nts[0], dtype=dtype, weight=weights[0])
    last_kkt = None
    prev_e2 = None
    hists = []
    level_reports = []
    sigma = sigma0
    t_start = time.monotonic()

    for lev in range(level_n):
        initial_scaling(lv, scaling, last_kkt, prev_e2)
        prev_e2 = lv.E2

        o = SolveOptions(
            tol=tols[lev],
            maxit=maxit,
            sigma=sigma,
            tau=tau,
            time_limit=time_limit,
            scaling=scaling,
            check_step_by_step=check_sbs,
            check_prim_dual_feas=check_pdf,
            restart=int(opts.get("restart", 100)),
            rho=float(opts.get("rho", 2.0)),
            theta=float(opts.get("theta", 2.0)),
        )
        lev_method = method
        lev_maxit = maxit
        if sgs_method and lev < level_n - 1:
            # non-final levels of sGS methods run inPALM
            # (``solver_dotsocp2d.m:209-223``)
            lev_method = "inPALM"
            o.maxit = ADMM_MAXIT
            o.tau = ALM_STEPSIZE

        ckpt_dir = opts.get("checkpoint_dir")
        ckpt_path = (
            os.path.join(ckpt_dir, f"level{lev + 1}.npz") if ckpt_dir else None
        )
        device_kw = {}
        if "chunk_iters" in opts:
            device_kw["chunk_iters"] = int(opts["chunk_iters"])
        if "max_chunks" in opts:
            device_kw["max_chunks"] = int(opts["max_chunks"])
        solver = _build_solver(lev_method, lv, o, dtype,
                                driver=str(opts.get("driver", "auto")),
                                checkpoint_path=ckpt_path,
                                device_kw=device_kw,
                                reuse=bool(opts.get("reuse_solvers", True)),
                                layout=str(opts.get("layout", "auto")),
                                mesh=opts.get("mesh"))
        hist, out = solver.solve(lv.as_dict())
        hist["method"] = solver.name
        hists.append(hist)

        recover_org_var(lv, out)
        report = {
            "level": lev + 1,
            "geom": lv.geom,
            "iters": out["iters"],
            "time": out["solve_time"],
            "method": solver.name,
        }
        if opts.get("profile"):
            # per-phase timing + roofline (the record_time equivalent,
            # ``solver_socp_inPALM.m:339-341`` — covers all six algorithms,
            # sGS sweep / Halpern phases included); run on the level's state
            from ..utils.profiling import profile_phases

            report["phases"] = profile_phases(
                solver.k, solver.k.prep(lv.as_dict(), 1.0), iters=20
            )
        level_reports.append(report)
        if verbose:
            print(
                f"Completed level {lev + 1}/{level_n} "
                f"(nt={lv.geom.nt}, space={lv.geom.space}): "
                f"{out['iters']} iters, {out['solve_time']:.2f}s, "
                f"final KKT max={np.max(hist['kkt'][-1][[0, 2, 5]]):.2e}"
            )

        if lev < level_n - 1:
            time_limit -= out["solve_time"]
            sigma = 10.0 ** (math.log10(sigma * out["sigma_out"]) / 2.0)
            last_kkt = hist["kkt"][-1]
            lv = _jump_next_level(
                lv, rho0s[lev + 1], rho1s[lev + 1], nts[lev + 1], dtype,
                weights[lev + 1],
            )

    # mixed-precision refinement: continue the finest level in float64 to a
    # tighter tolerance. The multilevel f32 solve already did the bulk of
    # the work, so only the tail below the f32 floor (~1e-4) runs in f64.
    # This is the supported route to reference-grade tolerances
    # (1e-5/1e-6); absent from the reference (MATLAB is all-double).
    refine_tol = opts.get("refine_tol")
    if refine_tol is not None:
        import jax as _jax

        if not _jax.config.jax_enable_x64:
            raise ValueError(
                "refine_tol needs float64: enable x64 before any jax op "
                "(jax.config.update('jax_enable_x64', True))"
            )
        refine_dtype = opts.get("refine_dtype", jnp.float64)
        time_limit -= out["solve_time"]
        sigma = 10.0 ** (math.log10(sigma * out["sigma_out"]) / 2.0)
        # tail tuning knobs (scripts/refine_tail_experiment2.py): the tail
        # regime is plain linear-rate ADMM with balanced residuals, so the
        # xi-driven sigma machinery leaves sigma nearly fixed; these let
        # experiments (and expert users) move the tail's operating point.
        sigma *= float(opts.get("refine_sigma_scale", 1.0))
        tau = float(opts.get("refine_tau", tau))
        last_kkt = hist["kkt"][-1]
        # same-geometry warm restart: keep (phi, q, z, alpha, beta), rebuild
        # c (recover_org_var does not unscale it — the normal flow rebuilds
        # it at every level jump), then re-run InitialScaling with E2
        # feedback; the solver's prep casts to f64
        ht = jnp.asarray(lv.geom.ht, lv.phi.dtype)
        c_new = jnp.zeros(lv.geom.phi_shape, lv.phi.dtype)
        c_new = c_new.at[0].set(-jnp.asarray(rho0s[-1], lv.phi.dtype) / ht)
        c_new = c_new.at[-1].set(jnp.asarray(rho1s[-1], lv.phi.dtype) / ht)
        lv.c = c_new
        initial_scaling(lv, scaling, last_kkt, prev_e2)
        prev_e2 = lv.E2
        # the tail may run a different algorithm than the multilevel sweep
        # (opts['refine_method']). Measured (scripts/refine_tail_experiment
        # .py / _experiment2.py, 65^2x17 f64 tails to 1e-6): acc-ADMM is
        # NOT a shortcut at ANY restart period (100/500/2000/inf all lose
        # to inPALM); tail iteration counts are bit-identical across a
        # 100x refine_sigma_scale range (the xi-balancing sigma machinery
        # re-locks); Anderson acceleration (AA-II m=5..20) gains only
        # 8-11%. The tail runs at the problem's linear ADMM rate — so any
        # speedup comes from PER-ITERATION cost instead, which the f64 DCT
        # matmuls dominate. The split path runs them as split-f32 matmuls
        # (KKT floor ~2e-8*n); the IR-DCT (ops/poisson.py:_solve_ir — f32
        # transforms + f64 stencil residual) has NO floor, so 'auto' runs
        # the whole tail as one IR phase at any tol.
        refine_method = str(opts.get("refine_method", method))
        methods_ok = WDOT_METHODS if lv.weight is not None else DOT_METHODS
        if refine_method not in methods_ok:
            raise ValueError(
                f"refine_method {refine_method!r} not in {methods_ok}")
        split_opt = opts.get("refine_dct_split", "auto")
        # The split path's KKT floor scales with the longest transform
        # axis (the phi noise is amplified by the gradient): measured
        # stalls at 2.1e-6 (n=65) and 1.9e-5 (n=1025) -> floor ~2e-8*n;
        # the phase threshold doubles it for safety margin. The 'ir' mode
        # (round 5, ops/poisson.py:_solve_ir) has no floor — f32 DCTs +
        # f64-residual refinement reach f64-grade phi at split-level cost,
        # so the tail runs as ONE phase at any tolerance.
        _split_floor = max(4e-6, 4e-8 * max((lv.geom.nt,) + lv.geom.space))
        if split_opt == "auto":
            # IR is the default on every backend. On CPU native f64 GEMM
            # costs ~2x f32 — measured 1D 257x17 tail to 1e-6: 26.3 vs
            # 35.8 s, identical 7529-iteration trajectory and final KKT.
            # Whether IR beats native f64 on an H100 is not measured yet
            # (ROADMAP speed item 2). One refinement round is trajectory-
            # identical to the 2-round and plain-f64 tails at 129^2x33 and
            # 1025x33 down to 1e-6; keep the second round for tighter
            # targets as floor margin. Under a mesh the halo
            # engine supports only the plain f64 transform (its padded
            # matrices bypass the inner solver's split/ir strategy).
            if opts.get("mesh") is not None:
                split_opt = False
            else:
                split_opt = "ir1" if float(refine_tol) >= 1e-6 else "ir"
        if split_opt in ("ir", "ir1"):
            phases = [(split_opt, float(refine_tol))]
        elif split_opt:
            if float(refine_tol) >= _split_floor:
                phases = [(True, float(refine_tol))]
            else:
                phases = [(True, _split_floor), (False, float(refine_tol))]
        else:
            phases = [(False, float(refine_tol))]

        var = lv.as_dict()
        ref_iters = 0
        ref_time = 0.0
        for use_split, phase_tol in phases:
            o = SolveOptions(
                tol=phase_tol, maxit=maxit, sigma=sigma, tau=tau,
                time_limit=max(time_limit, 0.0), scaling=scaling,
                check_step_by_step=check_sbs,
                check_prim_dual_feas=check_pdf,
                restart=int(opts.get("restart", 100)),
                rho=float(opts.get("rho", 2.0)),
                theta=float(opts.get("theta", 2.0)),
            )
            solver = _build_solver(refine_method, lv, o, refine_dtype,
                                   driver=str(opts.get("driver", "auto")),
                                   device_kw=device_kw,
                                   reuse=bool(opts.get("reuse_solvers",
                                                       True)),
                                   layout=str(opts.get("layout", "auto")),
                                   mesh=opts.get("mesh"),
                                   dct_split=use_split)
            hist, out = solver.solve(var)
            var = out
            sigma = sigma * out["sigma_out"]
            time_limit -= out["solve_time"]
            ref_iters += out["iters"]
            ref_time += out["solve_time"]
            hist["method"] = solver.name + (
                " (f64 refine, IR-DCT)" if use_split in ("ir", "ir1")
                else " (f64 refine, split-DCT)" if use_split
                else " (f64 refine)"
            )
            hists.append(hist)
        recover_org_var(lv, out)
        level_reports.append({
            "level": level_n,
            "geom": lv.geom,
            "iters": ref_iters,
            "time": ref_time,
            "method": hist["method"],
            "refine": True,
        })
        if verbose:
            print(
                f"f64 refine (tol={refine_tol:g}, "
                f"{len(phases)} phase(s)): {ref_iters} iters, "
                f"{ref_time:.2f}s, final KKT "
                f"max={np.max(hist['kkt'][-1][[0, 2, 5]]):.2e}"
            )

    total_time = time.monotonic() - t_start

    # recover solution + mass check, one device dispatch
    from .level import recover_solution

    rho, Es, q0, bs, mass_ok = recover_solution(lv)
    if not mass_ok and verbose:
        print("WARNING: mass conservation violation exceeds 1e-2")

    output = {
        "rho": rho,
        "E": Es,
        "q0": q0,
        "b": bs,
        "mass_ok": mass_ok,
        "levels": level_reports,
        "total_time": total_time,
        "kkt_names": KKT_LEGEND,
    }
    if lv.geom.ndim_space == 2:
        # space = (ny, nx): axis 0 = y, axis 1 = x
        output["Ey"], output["Ex"] = Es[0], Es[1]
        output["by"], output["bx"] = bs[0], bs[1]
    elif lv.geom.ndim_space == 1:
        output["Ex"] = Es[0]
        output["bx"] = bs[0]

    run_hist_ml = _cat_hist(hists)
    run_hist_ml["method"] = hists[-1]["method"]
    run_hist_ml["kktNames"] = KKT_LEGEND
    run_hist = hists[-1]
    return output, run_hist_ml, run_hist
