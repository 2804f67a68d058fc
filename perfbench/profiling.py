"""The traced segment: a phase of the cell's traffic under torch.profiler,
reduced to device busy time, kernel time by name and the idle gaps.

Some profiler sessions come back with no device records; such a session
is thrown away and the phase traced again, ``PROFILE_TRIES`` times in all.
After the last empty try the run fails: a share is never reported from a
session that saw no device work.
"""
from __future__ import annotations

import time

PROFILE_TRIES = 5
WINDOW_MARK = "perfbench.window"
# the benchmark's own ranges, which the profiler may also draw on the
# device's timeline: never device work
OWN_MARKS = ("perfbench.",)
TOP = 10


class EmptyProfile(RuntimeError):
    """Every try's session came back without device records."""


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict | None:
    """{"window_s", "busy_s", "kernels": {name: [seconds, count]},
    "copies_s", "idle_gaps": [[what the host ran, seconds], ...]} from a
    session's events, or None when it holds no device record or no
    window mark."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    mark = [e for e in events if e.name == WINDOW_MARK
            and e.device_type != cuda]
    dev = [e for e in events if e.device_type == cuda
           and e.time_range.end > e.time_range.start
           and not e.name.startswith(OWN_MARKS)]
    if not mark or not dev:
        return None
    w0, w1 = mark[0].time_range.start, mark[0].time_range.end
    kernels, copies, spans = {}, 0.0, []
    for e in dev:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        spans.append((s, t))
        dur = (t - s) * 1e-6
        if e.name.startswith(("Memcpy", "Memset")):
            copies += dur
            continue
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += dur
        k[1] += 1
    if not spans:
        return None
    busy = _merge(spans)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.device_type != cuda
            and not e.name.startswith(OWN_MARKS)]
    idle = []
    for s, t in gaps[:TOP]:
        best, best_key = "host: no operation recorded", None
        for e in host:
            ov = min(t, e.time_range.end) - max(s, e.time_range.start)
            if ov <= 0:
                continue
            key = (ov, -(e.time_range.end - e.time_range.start))
            if best_key is None or key > best_key:
                best, best_key = e.name, key
        idle.append([best, (t - s) * 1e-6])
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(t - s for s, t in busy) * 1e-6,
            "kernels": kernels, "copies_s": copies, "idle_gaps": idle}


def traced(run_phase, log) -> tuple[dict, dict, int]:
    """Run ``run_phase()`` under the profiler until a session holds device
    records: (the phase's own result, the reduced session, tries).
    ``log`` takes one line per empty try.  Raises EmptyProfile."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    for attempt in range(1, PROFILE_TRIES + 1):
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_MARK):
                t0 = time.perf_counter()
                out = run_phase()
                if cuda:
                    torch.cuda.synchronize()
                out["traced_wall_s"] = time.perf_counter() - t0
        red = reduce_events(prof.events())
        if red is not None:
            return out, red, attempt
        log(f"profiler try {attempt} of {PROFILE_TRIES}: no device records")
    raise EmptyProfile(f"{PROFILE_TRIES} profiler sessions came back "
                       "without device records")


def fragment_seconds(kernels: dict, fragments) -> float:
    """Device seconds of the kernels whose name holds any fragment."""
    return sum(s for name, (s, _) in kernels.items()
               if any(f in name for f in fragments))


def pattern_seconds(kernels: dict, pattern) -> float:
    """Device seconds of the kernels whose name the compiled regular
    expression ``pattern`` finds a match in."""
    return sum(s for name, (s, _) in kernels.items() if pattern.search(name))


def top_ops(kernels: dict) -> list:
    """The TOP kernels by device seconds, [[name, seconds], ...]."""
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return [[name[:160], s] for name, (s, _) in ranked]
