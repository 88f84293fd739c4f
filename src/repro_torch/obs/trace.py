"""Durable trace capture and replay loading.

:class:`TraceWriter` streams every scheduler :class:`TraceEvent`, every
worker span, and every telemetry snapshot to a JSONL file as they happen —
one JSON object per line, line-buffered, so a SIGKILLed run still yields a
readable prefix (the crash-forensics contract).  The schema is identical on
all three executor backends; sim/thread runs simply contain no span or
telemetry lines.

Line types::

  {"type": "meta",      "n_devices": 4, "backend": "proc", ...}
  {"type": "event",     "t": ..., "kind": "dispatch", "task": ..., ...}
  {"type": "span",      "kind": "compute", "t0": ..., "t1": ...,
                        "worker": "w0", "part": 0, "uid": 7, "task": ...}
  {"type": "telemetry", "t": ..., "worker": "w0", "queue_depth": 1, ...}

:func:`load_trace` is the inverse: it reconstructs the run as a
:class:`RecordedTrace` whose ``.trace``/``.tasks`` quack enough like a
``SimReport`` that ``benchmarks.common.trace_summary`` reports identical
counters, and whose :meth:`RecordedTrace.replay` re-runs the recorded
arrival/duration skeleton through ``VirtualClockExecutor`` — the first
concrete step of the ROADMAP's trace-replay policy-zoo item (record live,
score candidate policies offline on the virtual clock).
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
class _TaskStub:
    """Per-task counters reconstructed from terminal trace events — just
    enough surface for ``trace_summary``'s per-task sums."""
    name: str
    uid: int
    hub_calls: int = 0
    spills: int = 0
    p2p_fallbacks: int = 0
    hub_relay_bytes: int = 0
    raw_coll_bytes: int = 0
    shm_bytes: int = 0
    ring_steps: int = 0
    resumed_from_step: int = 0


@dataclasses.dataclass
class RecordedTrace:
    """A loaded JSONL trace, shaped like the slice of ``SimReport`` the
    trace consumers need (``.trace`` of TraceEvents, ``.tasks`` stubs,
    ``.spans``, plus the recorded telemetry stream and meta header)."""
    meta: dict
    trace: list
    spans: list
    telemetry: list
    tasks: list

    def events(self, kind: Optional[str] = None) -> list:
        if kind is None:
            return list(self.trace)
        return [e for e in self.trace if e.kind == kind]

    # -- replay ------------------------------------------------------------
    def replay_descs(self):
        """The recorded run's arrival/duration skeleton as (descs,
        n_devices): one TaskDescription per recorded uid, in submit order,
        with the measured dispatch->terminal duration as its virtual-clock
        ``duration_model`` and the recorded ranks/pipeline/priority-free
        tags.  Tasks that never reached a terminal event (crash-truncated
        trace) replay with zero duration — they still count a submit and a
        dispatch, which is what a schedule-shape comparison needs."""
        from repro_torch.core.task import TaskDescription

        dispatch: dict = {}
        duration: dict = {}
        order: list = []
        info: dict = {}
        for e in self.trace:
            if e.kind == "submit" and e.uid not in info:
                order.append(e.uid)
                info[e.uid] = e
            elif e.kind == "dispatch":
                dispatch[e.uid] = e.t
            elif e.kind in ("done", "fail") and e.uid in dispatch:
                duration[e.uid] = max(e.t - dispatch[e.uid], 0.0)
        descs = []
        for uid in order:
            e = info[uid]
            dur = duration.get(uid, 0.0)
            descs.append(TaskDescription(
                name=e.task, ranks=max(e.ranks, 1), fn=None,
                duration_model=(lambda r, d=dur: d),
                tags={"pipeline": e.pipeline or "default"}))
        n_devices = int(self.meta.get("n_devices") or 0)
        if n_devices <= 0:
            n_devices = max((d.ranks for d in descs), default=1)
        return descs, n_devices

    def replay(self, opts=None):
        """Re-run the skeleton through ``VirtualClockExecutor`` and return
        its ``SimReport``: for a clean recorded run, ``trace_summary`` of
        the replay matches the live run's n_submit/n_dispatch/n_done
        exactly (same tasks, same pool size, noise-free durations)."""
        from repro_torch.core.executors import SimOptions
        from repro_torch.core.scheduler import simulate

        descs, n_devices = self.replay_descs()
        opts = opts or SimOptions(
            noise=0.0, overhead_model=lambda r: 0.0,
            placement=self.meta.get("placement", "spread"))
        return simulate(descs, n_devices, opts)


def load_trace(path: str) -> RecordedTrace:
    """Parse a JSONL trace back into a :class:`RecordedTrace`.  A torn final
    line (SIGKILL mid-write) is skipped, not fatal — every complete line of
    a crashed run stays loadable."""
    from repro_torch.core.scheduler import TraceEvent

    meta: dict = {}
    trace: list = []
    spans: list = []
    telemetry: list = []
    stubs: dict = {}
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
                ev = TraceEvent(**{k: v for k, v in obj.items()
                                   if k in fields})
                trace.append(ev)
                if ev.kind in ("done", "fail") and ev.uid >= 0:
                    d = ev.data or {}
                    stubs[ev.uid] = _TaskStub(
                        name=ev.task, uid=ev.uid,
                        hub_calls=int(d.get("hub_calls", 0)),
                        spills=int(ev.spills),
                        p2p_fallbacks=int(d.get("p2p_fallbacks", 0)),
                        hub_relay_bytes=int(d.get("hub_relay_bytes", 0)),
                        raw_coll_bytes=int(d.get("raw_coll_bytes", 0)),
                        shm_bytes=int(d.get("shm_bytes", 0)),
                        ring_steps=int(d.get("ring_steps", 0)),
                        resumed_from_step=int(d.get("resumed_from_step", 0)))
            elif typ == "span":
                spans.append(obj)
            elif typ == "telemetry":
                telemetry.append(obj)
    return RecordedTrace(meta=meta, trace=trace, spans=spans,
                         telemetry=telemetry, tasks=list(stubs.values()))
