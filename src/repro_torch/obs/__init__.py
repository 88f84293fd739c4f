"""Flight recorder, as far as this slice of the port needs it:

* ``spans``   — the per-part timing API (the out-of-core shuffle records
  ``spill_write`` and ``merge`` spans through the thread-bound recorder).
* ``metrics`` — the counter/gauge registry.
* ``trace``   — ``TraceWriter`` (crash-safe line-buffered JSONL via
  ``REPRO_TRACE`` / ``SchedulerSession(trace_path=)``), ``load_trace``,
  and replay through ``VirtualClockExecutor``.

The Perfetto export of the JAX package is a later slice.
"""
from repro_torch.obs.metrics import MetricsRegistry, rss_mb
from repro_torch.obs.spans import (NullRecorder, SpanRecorder, align, bound,
                                   current_recorder, set_current)
from repro_torch.obs.trace import (RecordedTrace, TraceWriter, load_trace,
                                   resolve_trace_path)

__all__ = [
    "MetricsRegistry", "NullRecorder", "RecordedTrace", "SpanRecorder",
    "TraceWriter", "align", "bound", "current_recorder", "load_trace",
    "resolve_trace_path", "rss_mb", "set_current",
]
