"""Flight recorder:

* ``spans``   — the per-task timing API: both live executors record a
  task's ``comm_build`` and ``compute`` (and how it was launched), and the
  code a payload calls records its own spans through the thread-bound
  recorder (the dataframe operators' ``df.*`` stages, the serving engine's
  issue and readback, the out-of-core shuffle's ``spill_write`` and
  ``merge``); ``wall_offset_ns`` puts them on a device trace's clock.
* ``metrics`` — the counter/gauge registry.
* ``trace``   — ``TraceWriter`` (crash-safe line-buffered JSONL via
  ``REPRO_TRACE`` / ``SchedulerSession(trace_path=)``) and
  ``load_trace``.
* ``perfetto`` — Chrome/Perfetto ``trace.json`` export with one row per
  worker/device lane plus counter tracks
  (``python -m repro_torch.obs.perfetto run.jsonl``).
"""
from repro_torch.obs.metrics import MetricsRegistry, rss_mb
from repro_torch.obs.perfetto import export_perfetto
from repro_torch.obs.spans import (NullRecorder, SpanRecorder, align, bound,
                                   current_recorder, set_current,
                                   wall_offset_ns)
from repro_torch.obs.trace import (RecordedTrace, TraceWriter, load_trace,
                                   resolve_trace_path)

__all__ = [
    "MetricsRegistry", "NullRecorder", "RecordedTrace", "SpanRecorder",
    "TraceWriter", "align", "bound", "current_recorder", "export_perfetto",
    "load_trace", "resolve_trace_path", "rss_mb", "set_current",
    "wall_offset_ns",
]
