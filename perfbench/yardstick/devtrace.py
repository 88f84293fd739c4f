"""The device's trace over a sub-window of a run, and the host spans the
benchmark records around its calls into the program.

``DeviceWindow`` runs ``torch.profiler`` with device activity only (tracing
host operations too would slow the host, which paces several of these
cells).  The reduction keeps every device operation as
an interval on the host's wall clock (the profiler reports its timestamps
on ``time.time_ns``'s clock), clipped to the sub-window, and gives:

* ``busy_s``: the union of the intervals.  Prefill and decode tasks issue
  from two threads, so intervals may overlap; a sum would count that twice.
* ``idle``: one minus busy over the sub-window's length.
* the device operations that took most time, and the longest idle gaps,
  each labelled by the host span (``Spans``) that covers its middle.
"""
from __future__ import annotations

import threading
import time
from typing import Optional


class Spans:
    """Host spans on ``time.time_ns``'s clock, appended from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: list = []        # (name, start_ns, end_ns, attrs)

    def add(self, name: str, start_ns: int, end_ns: int, **attrs):
        with self._lock:
            self.items.append((name, start_ns, end_ns, attrs))

    def named(self, name: str) -> list:
        with self._lock:
            return [s for s in self.items if s[0] == name]


def union_length(intervals: list) -> int:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list, lo: int, hi: int) -> list:
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [g for g in out if g[1] > g[0]]


class DeviceWindow:
    """Profile the device over a sub-window of ``span_s`` seconds that
    opens ``after_s`` into the measured window.

    The device tracing (CUPTI) is switched on by ``prepare`` before the
    window opens, while no thread of the program launches work: switched on
    while the program's threads launch kernels, it has crashed the process.
    From then on the device's activities are buffered; the driving loop's
    first ``tick`` past the sub-window's opening starts the capture, which
    only marks where the kept events begin, and ``close`` stops it once the
    window has closed and the program's threads are idle, so that stopping
    it and reading its events stalls nothing that the window measures."""

    def __init__(self, after_s: float, span_s: float):
        self.after_s, self.span_s = after_s, span_s
        self.kernels: list = []        # (name, start_ns, end_ns), clipped
        self.whole: list = []          # those wholly inside the sub-window
        self.t0_ns = self.t1_ns = 0
        self._open_ns = None
        self._prof = None
        self._started = False
        self.error: Optional[str] = None

    def prepare(self):
        """Switch the device tracing on; the program must be idle.  Its
        first start initialises CUPTI and takes seconds."""
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.prepare_trace()

    def open(self, t0_ns: int):
        """The measured window opens at ``t0_ns``."""
        self._open_ns = t0_ns

    def tick(self):
        """Called by the driving loop: starts the capture once due."""
        if self._started or self._prof is None or self._open_ns is None \
                or time.time_ns() < self._open_ns + self.after_s * 1e9:
            return
        self._prof.start_trace()
        self._started = True
        self.t0_ns = time.time_ns()
        self.t1_ns = self.t0_ns + int(self.span_s * 1e9)

    def close(self):
        """After the window: stop the profiler and keep the sub-window."""
        if not self._started:
            self.error = "the driving loop never started the capture"
            return
        try:
            self._prof.stop_trace()
            self.t1_ns = min(self.t1_ns, time.time_ns())
            self._reduce(self._prof)
        except Exception as e:  # noqa: BLE001 — reported in the result
            self.error = f"{type(e).__name__}: {e}"
        self._prof = None

    def _reduce(self, prof):
        lo, hi = self.t0_ns, self.t1_ns
        out, whole = [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type().name != "CUDA" or e.is_user_annotation():
                continue
            s, t = e.start_ns(), e.end_ns()
            if t <= lo or s >= hi:
                continue
            out.append((e.name(), max(s, lo), min(t, hi)))
            if lo <= s and t <= hi:
                whole.append((e.name(), s, t))
        self.kernels, self.whole = out, whole

    # -- readings ----------------------------------------------------------
    @property
    def ok(self) -> bool:
        return self.error is None and self.t1_ns > self.t0_ns

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.kernels]) / 1e9

    def matching(self, *names: str) -> list:
        """Operations wholly inside the sub-window whose name holds one of
        ``names`` (for per-kernel accounting: a call cut by the window's
        edge is left out, not counted whole)."""
        return [k for k in self.whole if any(x in k[0] for x in names)]

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], v / 1e9] for n, v in top]

    def idle_gaps(self, spans: Spans, k: int = 10) -> list:
        """The ``k`` longest idle stretches, each named by the host span
        that covers its middle (the innermost, i.e. the latest to start),
        or "no span" where the benchmark recorded none there."""
        found = sorted(gaps([(s, e) for _, s, e in self.kernels],
                            self.t0_ns, self.t1_ns),
                       key=lambda g: g[0] - g[1])[:k]
        with spans._lock:
            items = list(spans.items)
        out = []
        for g0, g1 in found:
            mid = (g0 + g1) // 2
            cover = [s for s in items if s[1] <= mid <= s[2]]
            name = max(cover, key=lambda s: s[1])[0] if cover else "no span"
            out.append([name, (g1 - g0) / 1e9])
        return out

