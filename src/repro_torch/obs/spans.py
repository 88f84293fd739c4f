"""Worker-side span tracing: the lightweight timing API the flight recorder
instruments task execution with.

A *span* is one timed section of a task part — ``launch_recv``,
``deserialize``, ``comm_build``, ``compute``, ``p2p_send``, ``p2p_recv``,
``spill_write``, ``merge`` — recorded as ``(kind, t0, t1)`` in the worker's
``perf_counter`` clock.  :class:`SpanRecorder` collects them with near-zero
overhead (two clock reads and a list append per span; no locks on the hot
path beyond a plain list, which is append-safe under the GIL), ships them
back piggybacked on the PART_DONE frame, and the parent aligns them into its
own clock with the per-worker offset established during the HELLO handshake
(see ``executors/proc.py``).

Deeply-nested code (``shuffle.SpillBuffer`` spilling inside a payload) does
not thread a recorder through every call: the worker binds the part's
recorder to the *thread* running the payload (:func:`set_current` /
:func:`current_recorder`), and un-instrumented contexts get a no-op recorder
— sim/thread backends produce empty span sections, never schema drift.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from time import perf_counter

#: span kinds the worker emits (documentation + the Perfetto exporter's
#: compute-vs-wait classification; recorders accept any string)
SPAN_KINDS = (
    "launch_recv",    # LAUNCH frame received -> part thread picked it up
    "deserialize",    # cloudpickle loads of the task payload
    "comm_build",     # local sub-mesh communicator construction
    "compute",        # the payload function itself
    "p2p_send",       # writing a peer-data frame to a peer channel
    "p2p_recv",       # waiting for a peer frame / hub collective result
    "spill_write",    # writing a spilled shuffle run to disk
    "merge",          # streaming k-way merge of spilled runs
)

#: span kinds that are *waits* (time the part was blocked on someone else),
#: as opposed to local work — the compute-vs-wait shading in trace_gantt and
#: the ``comm_wait_s`` breakdown in trace_summary
WAIT_KINDS = frozenset({"p2p_recv"})


class SpanRecorder:
    """Collects ``(kind, t0, t1)`` spans on the local ``perf_counter`` clock.

    ``span`` is the context-manager form; ``add`` records a finished span
    directly (for callers that already hold both timestamps).  ``export``
    returns plain tuples ready for a wire frame.
    """

    __slots__ = ("spans",)

    def __init__(self):
        self.spans: list[tuple] = []

    def add(self, kind: str, t0: float, t1: float):
        self.spans.append((kind, t0, t1))

    @contextmanager
    def span(self, kind: str):
        t0 = perf_counter()
        try:
            yield
        finally:
            self.spans.append((kind, t0, perf_counter()))

    def export(self) -> list:
        return list(self.spans)


class NullRecorder(SpanRecorder):
    """No-op recorder bound outside an instrumented part (sim/thread
    payloads, direct calls in tests): the ``span`` blocks run, nothing is
    kept — un-instrumented code pays two clock reads and nothing else."""

    def add(self, kind: str, t0: float, t1: float):
        pass

    @contextmanager
    def span(self, kind: str):
        yield

    def export(self) -> list:
        return []


_NULL = NullRecorder()
_local = threading.local()


def current_recorder() -> SpanRecorder:
    """The recorder bound to this thread (a no-op one when none is)."""
    return getattr(_local, "recorder", None) or _NULL


def set_current(recorder) -> None:
    """Bind ``recorder`` to this thread (None unbinds).  The worker's part
    thread binds its recorder around the payload call so nested library code
    (e.g. the shuffle's SpillBuffer) records spans without plumbing."""
    _local.recorder = recorder


@contextmanager
def bound(recorder):
    """Scoped :func:`set_current` — restores the previous binding on exit."""
    prev = getattr(_local, "recorder", None)
    _local.recorder = recorder
    try:
        yield recorder
    finally:
        _local.recorder = prev


def align(spans, offset: float, **tags) -> list:
    """Shift raw worker spans into the parent clock and attach identity
    tags: ``[(kind, t0, t1), ...] + offset -> [{kind, t0, t1, **tags}]``.
    Pure addition — relative order and nesting are preserved exactly (the
    property the flight-recorder tests check)."""
    return [dict(kind=k, t0=t0 + offset, t1=t1 + offset, **tags)
            for k, t0, t1 in spans]
