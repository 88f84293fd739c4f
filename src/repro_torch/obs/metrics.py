"""Counter/gauge registry — the telemetry side of the flight recorder.

One :class:`MetricsRegistry` per worker process aggregates what used to be
ad-hoc scattered attributes: ``ProcTaskComm``'s per-part counters now write
through a part-local registry *chained* to the worker registry, so the
worker-lifetime totals the heartbeat snapshots (queue depth, RSS, spill
bytes, peer-channel cache size, ``p2p_fallbacks``) stay consistent with the
per-part numbers shipped on PART_DONE without double bookkeeping.

``snapshot()`` is what a telemetry-carrying HEARTBEAT frame embeds: all
counters plus every registered gauge evaluated at call time.  Gauges are
plain callables (``lambda: len(self._tasks)``) so a stuck or swapping worker
reports its true current state, not a stale cache.
"""
from __future__ import annotations

import os
from typing import Callable, Optional


class MetricsRegistry:
    """Named monotonically-increasing counters + lazily-evaluated gauges.

    ``parent`` chains registries: every counter increment is mirrored into
    the parent, which is how per-part accounting (shipped on PART_DONE)
    also feeds the worker-lifetime totals the heartbeat reports.  Plain
    int ``+=`` under the GIL — the same atomicity story the ad-hoc
    attributes had, with one writer thread per part in practice.
    """

    def __init__(self, parent: Optional["MetricsRegistry"] = None):
        self.parent = parent
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, Callable[[], float]] = {}

    # -- counters ----------------------------------------------------------
    def inc(self, name: str, value: int = 1):
        if value:
            self._counters[name] = self._counters.get(name, 0) + value
            if self.parent is not None:
                self.parent.inc(name, value)

    def get(self, name: str) -> int:
        return self._counters.get(name, 0)

    def set_counter(self, name: str, value: int):
        """Absolute assignment with parent-consistent semantics: the parent
        receives the *delta* — what backs the ``comm.spills += n`` style
        attribute surface on :class:`ProcTaskComm`."""
        self.inc(name, int(value) - self._counters.get(name, 0))

    # -- gauges ------------------------------------------------------------
    def gauge(self, name: str, fn: Callable[[], float]):
        self._gauges[name] = fn

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Counters + gauges as one flat dict (the HEARTBEAT payload).  A
        gauge that raises reports -1 rather than killing the heartbeat
        loop — liveness must never depend on telemetry health."""
        out = dict(self._counters)
        for name, fn in self._gauges.items():
            try:
                out[name] = fn()
            except Exception:  # noqa: BLE001 — telemetry must not kill liveness
                out[name] = -1
        return out


def rss_mb() -> float:
    """Current resident set size in MiB — /proc-based on Linux (true current
    RSS, the early-warning signal for a swapping worker), ``ru_maxrss``
    high-water fallback elsewhere."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1 << 20)
    except (OSError, ValueError, IndexError):
        try:
            import resource
            ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # linux reports KiB, macOS bytes
            return ru / (1 << 10) if ru < (1 << 34) else ru / (1 << 20)
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            return -1.0
