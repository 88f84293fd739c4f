"""Worker-side span tracing: the lightweight timing API the flight recorder
instruments task execution with.

A *span* is one timed section of a task part — see :data:`SPAN_KINDS` —
recorded as ``(kind, t0, t1, parent, attrs)`` in the worker's
``perf_counter`` clock: ``parent`` is the index of the span that was open on
the same recorder when it began (None at the top), ``attrs`` the keyword
attributes it was opened with (``rec.span("decode_issue", slots=3)``).
:class:`SpanRecorder` collects them with near-zero overhead (two clock reads
and a list append per span; no locks, one recorder per thread), the
executor ships them on the terminal event, and the parent aligns them into
its own clock (:func:`align`): the process executor with the per-worker
offset established during the HELLO handshake (see ``executors/proc.py``),
the thread executor with offset 0.

Deeply-nested code (the dataframe operators' stages, the serving engine's
issue and readback, ``shuffle.SpillBuffer`` spilling inside a payload) does
not thread a recorder through every call: the executor binds the task's
recorder to the *thread* running the payload (:func:`bound` /
:func:`current_recorder`), and un-instrumented contexts get a no-op
recorder — code called outside a task records nothing.

Spans are on ``perf_counter``'s clock; :func:`wall_offset_ns` maps them onto
``time.time_ns``'s, the clock of a ``torch.profiler`` device trace.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from time import perf_counter

#: span kinds the port emits (documentation, held to what the port's code
#: records by its tests; recorders accept any string)
SPAN_KINDS = (
    "launch_recv",    # proc: LAUNCH frame received -> part thread picked it up
    "launch",         # thread: launch() -> the task's worker thread running
    "deserialize",    # proc: cloudpickle loads of the task payload
    "comm_build",     # the task's private communicator construction
    "compute",        # the payload function itself
    "p2p_send",       # proc: writing a peer-data frame to a peer channel
    "p2p_recv",       # proc: waiting for a peer frame / hub collective result
    "spill_write",    # writing a spilled shuffle run to disk
    "merge",          # streaming k-way merge of spilled runs
    "df.target",      # dist op: hash target, or samples, splitters, searchsorted
    "df.pack",        # dist op: radix_partition and the send-buffer scatter
    "df.exchange",    # dist op: all_to_all / psum issue; attr bytes moved
    "df.compact",     # dist op: filter_rows of the received blocks
    "df.local_sort",  # dist op: a local sort_by on every rank
    "df.join_inner",  # dist op: the local sort-merge inner join on every rank
    "prefill_issue",  # serve: batch build + api.prefill issue; attr req
    "prefill_sync",   # serve: the first-token readback; attr req
    "decode_issue",   # serve: a decode round up to its readback; attr slots
    "decode_sync",    # serve: the round's logits.argmax(-1).cpu(); attr slots
    "moe",            # an expert layer's issue (Jamba); attrs layer, tokens
)


class _Open:
    """The context of one span being recorded: on entry it takes its slot
    in the recorder's list (a row, ``[kind, t0, t1, parent, attrs]``) under
    the span open then, on exit it stamps its end."""

    __slots__ = ("rec", "row")

    def __init__(self, rec, kind, attrs):
        self.rec = rec
        self.row = [kind, 0.0, None, None, attrs]

    def __enter__(self):
        rec, row = self.rec, self.row
        stack = rec._open
        row[3] = stack[-1] if stack else None
        stack.append(len(rec.spans))
        rec.spans.append(row)
        row[1] = perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        self.row[2] = perf_counter()
        self.rec._open.pop()
        return False


class SpanRecorder:
    """Collects ``(kind, t0, t1, parent, attrs)`` spans on the local
    ``perf_counter`` clock, in the order they began.

    ``span`` is the context-manager form; ``add`` records a finished span
    directly (for callers that already hold both timestamps), under the span
    open at the call.  ``export`` returns plain tuples ready for a wire
    frame.  One recorder belongs to one thread at a time.
    """

    __slots__ = ("spans", "_open")

    def __init__(self):
        self.spans: list[list] = []     # rows [kind, t0, t1, parent, attrs]
        self._open: list[int] = []      # indices of the open spans, a stack

    def add(self, kind: str, t0: float, t1: float):
        self.spans.append([kind, t0, t1,
                           self._open[-1] if self._open else None, {}])

    def span(self, kind: str, **attrs):
        return _Open(self, kind, attrs)

    def export(self) -> list:
        """The spans so far as tuples; one still open is cut at the call."""
        now = perf_counter()
        return [(k, t0, now if t1 is None else t1, parent, attrs)
                for k, t0, t1, parent, attrs in self.spans]


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False


_NO_SPAN = _NoSpan()


class NullRecorder(SpanRecorder):
    """No-op recorder bound outside an instrumented task (sim payloads,
    direct calls in tests): the ``span`` blocks run, nothing is kept, and
    every ``span`` call returns one shared no-op context."""

    def add(self, kind: str, t0: float, t1: float):
        pass

    def span(self, kind: str, **attrs):
        return _NO_SPAN

    def export(self) -> list:
        return []


class _Bound(threading.local):
    recorder = None     # a class default: no AttributeError on a lookup


_NULL = NullRecorder()
_local = _Bound()


def current_recorder() -> SpanRecorder:
    """The recorder bound to this thread (a no-op one when none is)."""
    return _local.recorder or _NULL


def set_current(recorder) -> None:
    """Bind ``recorder`` to this thread (None unbinds).  The executors bind
    a task's recorder around the payload call so nested library code
    (the dataframe operators, the serving engine, the shuffle's
    SpillBuffer) records spans without plumbing."""
    _local.recorder = recorder


@contextmanager
def bound(recorder):
    """Scoped :func:`set_current` — restores the previous binding on exit."""
    prev = _local.recorder
    _local.recorder = recorder
    try:
        yield recorder
    finally:
        _local.recorder = prev


def align(spans, offset: float, **tags) -> list:
    """Shift raw worker spans into the parent clock and attach identity
    tags: ``[(kind, t0, t1[, parent, attrs]), ...] + offset ->
    [{kind, t0, t1, parent, attrs, **tags}]`` (a 3-tuple has no parent and
    no attributes).  Pure addition — relative order and nesting are
    preserved exactly (the property the flight-recorder tests check)."""
    return [dict(kind=s[0], t0=s[1] + offset, t1=s[2] + offset,
                 parent=s[3] if len(s) > 3 else None,
                 attrs=s[4] if len(s) > 4 else {}, **tags)
            for s in spans]


def wall_offset_ns() -> int:
    """The offset, in ns, from ``perf_counter``'s clock to ``time.time_ns``'s
    (the clock of a ``torch.profiler`` device trace): a stamp ``t`` of
    ``perf_counter`` lies at ``round(t * 1e9) + wall_offset_ns()`` there.
    Taken now, from the tightest of five paired reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]
