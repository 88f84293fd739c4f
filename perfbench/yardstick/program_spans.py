"""The program's own spans for the per-layer readers: what the port's flight
recorder (``repro_torch.obs.spans``) kept on each task (``Task.spans``).

A span is a dict ``{kind, t0, t1, parent, attrs, ...}`` on the session's
clock, ``time.perf_counter``'s; ``wall_offset_ns`` of the program puts it
on ``time.time_ns``'s, the device trace's.  A program without spans on its
tasks, or without ``wall_offset_ns``, gives nothing to read: the readers
then return None.
"""
from __future__ import annotations

from yardstick.devtrace import gaps
from yardstick.readings import window_tasks


def window_spans(ctx: dict, match, prefix: str = "") -> list:
    """Spans of the window's tasks (``readings.window_tasks``, whose name
    starts with ``prefix``) that lie inside ``[t0, t_end]`` and whose kind
    ``match`` accepts, in start order."""
    out = [s for t in window_tasks(ctx, prefix)
           for s in getattr(t, "spans", None) or ()
           if match(s["kind"]) and ctx["t0"] <= s["t0"]
           and s["t1"] <= ctx["t_end"]]
    return sorted(out, key=lambda s: s["t0"])


def kind(name: str):
    return lambda k: k == name


def durations(spans: list) -> list:
    return [s["t1"] - s["t0"] for s in spans]


def wall_offset():
    """The program's ``perf_counter`` to ``time.time_ns`` offset in ns, or
    None where the program has no such function."""
    try:
        from repro_torch.obs.spans import wall_offset_ns
    except ImportError:
        return None
    return wall_offset_ns()


def device_clock(spans: list, offset_ns: int) -> list:
    """``(start_ns, end_ns)`` of each span on the device trace's clock."""
    return [(round(s["t0"] * 1e9) + offset_ns,
             round(s["t1"] * 1e9) + offset_ns) for s in spans]


def idle_pct_vs_spans(ctx: dict, match, inside: bool = False):
    """The share, in %, of the traced sub-window in which the device is
    idle and no span of a window task that ``match`` accepts is open: the
    stretches that neither a device operation nor such a span covers.  With
    ``inside``, the share in which the device is idle while such a span is
    open instead.  None without a device window or without such spans."""
    w = ctx.get("device_window")
    if w is None or w.window_s <= 0 or not w.kernels:
        return None
    spans = window_spans(ctx, match)
    off = wall_offset() if spans else None
    if off is None:
        return None
    lo, hi = w.t0_ns, w.t1_ns
    busy = [(s, e) for _, s, e in w.kernels]
    idle = sum(e - s for s, e in gaps(busy + device_clock(spans, off),
                                      lo, hi))
    if inside:
        idle = sum(e - s for s, e in gaps(busy, lo, hi)) - idle
    return 100.0 * idle / (hi - lo)
