"""Device busy and idle share of a warm multilevel solve, from a trace.

    python scripts/device_idle.py [--n 129] [--nt 33] [--trace-dir DIR]

Solves DOTmark_4stitch n^2 x nt (3 levels, inPALM, f32, tol 1e-4, device
driver) once to compile, then traces a second, warm solve with
``jax.profiler`` and reduces the trace:

- busy = union of the intervals in which a kernel or copy runs on the
  GPU's streams, within the host span of the traced solve; idle share =
  1 - busy / span;
- the count of device-to-host copies beside the iteration count, which
  shows whether the device loop reads its loop conditions back to the host
  once per iteration or once per chunk.

Prints one JSON line. Needs a GPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WINDOW = "device_idle_window"


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str) -> dict:
    """Busy/idle share and copy counts from one ``.xplane.pb`` file."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    window = None
    for plane in pd.planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name == WINDOW:
                        window = (ev.start_ns, ev.start_ns + ev.duration_ns)
    if window is None:
        raise RuntimeError(f"no {WINDOW!r} span in {path}")
    lines, names, busy = {}, Counter(), []
    d2h = 0
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [ev for ev in line.events
                   if ev.start_ns < window[1]
                   and ev.start_ns + ev.duration_ns > window[0]]
            lines[f"{plane.name}|{line.name}"] = {
                "events": len(evs),
                "ms": sum(ev.duration_ns for ev in evs) / 1e6}
            if not line.name.startswith("Stream"):
                continue  # module/op summary lines repeat the stream events
            for ev in evs:
                names[ev.name] += 1
                low = ev.name.lower()
                if "d2h" in low or "dtoh" in low or "devicetohost" in low:
                    d2h += 1
                busy.append((max(ev.start_ns, window[0]),
                             min(ev.start_ns + ev.duration_ns, window[1])))
    span = window[1] - window[0]
    busy_ns = _union_ns(busy)
    return {"span_ms": span / 1e6, "busy_ms": busy_ns / 1e6,
            "idle_share": 1.0 - busy_ns / span if span else None,
            "d2h_copies": d2h, "lines": lines,
            "top_events": names.most_common(15)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=129)
    p.add_argument("--nt", type=int, default=33)
    p.add_argument("--trace-dir",
                   default=os.path.join(REPO, ".traces", "device_idle"))
    a = p.parse_args(argv)

    from dotsocp.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from dotsocp.models.examples import get_example_2d
    from dotsocp.multilevel.solve import solve_dot

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"device_idle: JAX finds no GPU ({dev.platform})", file=sys.stderr)
        return 1
    r0, r1 = get_example_2d("DOTmark_4stitch", a.n, a.n)
    opts = {"tol": 1e-4, "maxit": 3000, "driver": "device"}
    solve_dot(r0, r1, a.nt, 3, dict(opts), "inPALM", dtype=jnp.float32,
              verbose=False)
    jax.profiler.start_trace(a.trace_dir)
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(WINDOW):
        out, _, _ = solve_dot(r0, r1, a.nt, 3, dict(opts), "inPALM",
                              dtype=jnp.float32, verbose=False)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(
        a.trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    res = reduce_trace(path)
    res.update(device_kind=dev.device_kind, grid=[a.nt, a.n, a.n],
               traced_wall_s=wall,
               iters=[l["iters"] for l in out["levels"]],
               level_wall_s=[l["time"] for l in out["levels"]])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
