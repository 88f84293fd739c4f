"""Durable trace capture and loading.

:class:`TraceWriter` streams every scheduler :class:`TraceEvent`, every
span, and every telemetry snapshot to a JSONL file as they happen — one
JSON object per line, line-buffered, so a SIGKILLed run still yields a
readable prefix (the crash-forensics contract).  The schema is identical on
all three executor backends: thread and process runs carry spans (the
thread executor's under ``"worker": "thread"``), process runs heartbeat
telemetry, and virtual-clock runs neither.

Line types::

  {"type": "meta",      "n_devices": 4, "backend": "proc",
                        "wall_offset_ns": ..., ...}
  {"type": "event",     "t": ..., "kind": "dispatch", "task": ..., ...}
  {"type": "span",      "kind": "compute", "t0": ..., "t1": ...,
                        "parent": null, "attrs": {}, "worker": "w0",
                        "part": 0, "uid": 7, "task": ...}
  {"type": "telemetry", "t": ..., "worker": "w0", "queue_depth": 1, ...}

Times are the executor's clock (``perf_counter`` on the live backends);
``wall_offset_ns`` in the meta line (live backends only) maps them onto
``time.time_ns``'s, a ``torch.profiler`` trace's clock:
``t * 1e9 + wall_offset_ns``.  A span's ``parent`` is the index, among the
same part's spans in order, of the span it was opened in.

:func:`load_trace` is the inverse: it reconstructs the run as a
:class:`RecordedTrace`, which the Perfetto exporter reads like a live
``SimReport``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


def resolve_trace_path(trace_path=None) -> Optional[str]:
    """Where this session's JSONL goes.  Explicit ``trace_path`` wins; else
    the ``REPRO_TRACE`` env knob.  A value naming a *directory* (existing,
    or spelled with a trailing separator) gets one unique file per session —
    that is what lets CI export ``REPRO_TRACE`` once for a whole test job
    without sessions clobbering each other."""
    path = trace_path or os.environ.get("REPRO_TRACE")
    if not path:
        return None
    path = str(path)
    if path.endswith(os.sep) or os.path.isdir(path):
        os.makedirs(path, exist_ok=True)
        n = 0
        while True:
            cand = os.path.join(path, f"trace-{os.getpid()}-{n}.jsonl")
            if not os.path.exists(cand):
                return cand
            n += 1
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return path


class TraceWriter:
    """Streams trace lines to ``path``; every line is flushed as written
    (text mode, ``buffering=1``) so the file is a valid prefix at any
    instant — a reader tolerates at most one torn final line."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w", buffering=1, encoding="utf-8")

    def _line(self, obj: dict):
        try:
            self._f.write(json.dumps(obj, default=str) + "\n")
        except ValueError:
            pass                      # writer closed mid-teardown: drop

    def meta(self, **fields):
        self._line({"type": "meta", **fields})

    def event(self, ev):
        self._line({"type": "event", **ev.asdict()})

    def span(self, span: dict):
        self._line({"type": "span", **span})

    def telemetry(self, rec: dict):
        self._line({"type": "telemetry", **rec})

    def close(self):
        try:
            self._f.close()
        except OSError:
            pass


@dataclasses.dataclass
class RecordedTrace:
    """A loaded JSONL trace, shaped like the slice of ``SimReport`` the
    trace consumers need (``.trace`` of TraceEvents, ``.spans``, plus the
    recorded telemetry stream and meta header) — what the Perfetto
    exporter reads."""
    meta: dict
    trace: list
    spans: list
    telemetry: list

    def events(self, kind: Optional[str] = None) -> list:
        if kind is None:
            return list(self.trace)
        return [e for e in self.trace if e.kind == kind]


def load_trace(path: str) -> RecordedTrace:
    """Parse a JSONL trace back into a :class:`RecordedTrace`.  A torn final
    line (SIGKILL mid-write) is skipped, not fatal — every complete line of
    a crashed run stays loadable."""
    from repro_torch.core.scheduler import TraceEvent

    meta: dict = {}
    trace: list = []
    spans: list = []
    telemetry: list = []
    fields = {f.name for f in dataclasses.fields(TraceEvent)}
    with open(path, encoding="utf-8") as f:
        for line in f:
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue              # torn tail of a killed run
            typ = obj.pop("type", None)
            if typ == "meta":
                meta.update(obj)
            elif typ == "event":
                trace.append(TraceEvent(**{k: v for k, v in obj.items()
                                           if k in fields}))
            elif typ == "span":
                spans.append(obj)
            elif typ == "telemetry":
                telemetry.append(obj)
    return RecordedTrace(meta=meta, trace=trace, spans=spans,
                         telemetry=telemetry)
