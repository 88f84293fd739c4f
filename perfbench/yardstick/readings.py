"""Arithmetic the per-layer readers share (``perfbench/metrics/*.py``).

The session's task records and ``TraceEvent`` times are on
``time.perf_counter``'s clock, like the benchmark's own stamps; the device
trace and the host spans are on ``time.time_ns``'s.
"""
from __future__ import annotations

import statistics


def window_tasks(ctx: dict, prefix: str = "") -> list:
    """Tasks of the window (dispatched inside it and done by its close)
    whose name starts with ``prefix``, in dispatch order."""
    out = [t for t in ctx["tasks"]
           if t.desc.name.startswith(prefix) and t.state.name == "DONE"
           and ctx["t0"] <= t.start_time and t.end_time <= ctx["t_end"]]
    return sorted(out, key=lambda t: t.start_time)


def mean_ms(values: list):
    return statistics.fmean(values) * 1e3 if values else None


def dispatch_waits(tasks: list, payload_ends: dict) -> list:
    """For each task after the first of a pipeline: its dispatch minus the
    later of its submit and the end of the previous task's payload (the
    benchmark's stamp, ``payload_ends[uid]``): how long the runtime took to
    hand the next task its ranks once the previous one's work was done."""
    waits, prev_end = [], None
    for t in tasks:
        if prev_end is not None:
            waits.append(t.start_time - max(t.submit_time, prev_end))
        prev_end = payload_ends.get(t.uid)
    return waits


def comm_builds(ctx: dict, tasks: list) -> list:
    uids = {t.uid for t in tasks}
    return [e.value for e in ctx["trace"]
            if e.kind == "comm_build" and e.uid in uids]


def idle_pct(ctx: dict):
    w = ctx.get("device_window")
    if w is None or w.window_s <= 0 or not w.kernels:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)


def containing(intervals: list, t: float):
    """The first (start, end, ...) record whose span holds ``t``."""
    for rec in intervals:
        if rec[0] <= t <= rec[1]:
            return rec
    return None
