"""Wall-clock timing of jitted calls.

JAX dispatch is asynchronous, so every timed call ends in
jax.block_until_ready: the clock stops when the device has finished.
"""

import time

import jax


def timed(fn, *args, iters: int = 5, warmup: int = 1):
    """Run fn(*args) `warmup` times untimed, then `iters` timed times.

    Returns (seconds of each timed call, last output)."""
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times, out


def busy_union(intervals) -> int:
    """Total length covered by the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0)


def device_trace(fn, *args, steps: int = 5) -> dict:
    """Trace `steps` warm calls of fn(*args) with the JAX profiler and reduce
    the GPU's kernel events (lines named "Stream..." on "/device:GPU" planes).

    Returns window_ns (first kernel start to last kernel end), busy_ns (the
    union of kernel intervals), idle_share (1 - busy / window), events,
    top (the 5 kernels with the most device time) and lines (every plane
    and line name seen, to tell an empty reduction from an idle device)."""
    import glob
    import tempfile

    from jax.profiler import ProfileData, trace

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory(prefix="armour_trace_") as d:
        with trace(d):
            for _ in range(steps):
                jax.block_until_ready(fn(*args))
        (path,) = glob.glob(f"{d}/plugins/profile/*/*.xplane.pb")
        profile = ProfileData.from_file(path)
        intervals, per_kernel, lines = [], {}, []
        for plane in profile.planes:
            for line in plane.lines:
                lines.append(f"{plane.name}:{line.name}")
                if not (plane.name.startswith("/device:GPU")
                        and line.name.startswith("Stream")):
                    continue
                for ev in line.events:
                    intervals.append((ev.start_ns, ev.end_ns))
                    per_kernel[ev.name] = (per_kernel.get(ev.name, 0)
                                           + ev.duration_ns)
    out = {"events": len(intervals), "lines": sorted(set(lines))}
    if intervals:
        window = max(e for _, e in intervals) - min(s for s, _ in intervals)
        busy = busy_union(intervals)
        out.update(window_ns=window, busy_ns=busy,
                   idle_share=1.0 - busy / window if window else 0.0,
                   top=sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5])
    return out
