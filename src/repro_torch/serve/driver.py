"""ServeDriver: the serving loop as SCHEDULER TASKS on the pilot runtime.

``ContinuousEngine.run`` is a tight in-process loop; this driver breaks it
into the two phases a serving tier actually schedules differently and
submits each as its own :class:`~repro_torch.core.task.TaskDescription`
through a :class:`~repro_torch.core.scheduler.SchedulerSession`:

* **prefill tasks** (pipeline tag ``serve-prefill``) — compute the
  single-slot caches for a chunk of queued requests.  Pure with respect to
  the shared slot cache (``ContinuousEngine.prefill_request``), so a
  prefill task runs CONCURRENTLY with the decode task on whatever devices
  the scheduler gives it;
* **decode tasks** (pipeline tag ``serve-decode``) — run decode rounds over
  the live batch (``decode_rounds``), returning early the moment a slot
  frees so capacity goes back to admission.

Because the two phases carry different pipeline tags, the session's policy
machinery applies unchanged: under ``BATCH`` each phase gets its own private
static sub-mesh next to ETL pipelines (the paper's heterogeneous-task
coupling), under ``HETEROGENEOUS`` they share the pool with everything
else.  Admissions produced by a finished prefill task are copied into the
shared cache by ServeDriver's own thread, and only while no decode task is
in flight — the one serialization point the shared cache needs.  The
driver takes the admissions out of the finished task (its ``result`` is
then None), and ``insert`` drops each single-slot cache once copied, so
a request's prefill cache lives from its prefill to its admission and
not until the session closes.

ServeDriver is the telemetry source for the tier: every loop it snapshots
the engine's :class:`~repro_torch.obs.MetricsRegistry` (queue depth, slot
occupancy, admitted/completed/evicted) into the session via
``SchedulerSession.record_telemetry`` — the same ``telemetry`` TraceEvent
stream worker heartbeats use, so the flight recorder and Perfetto export
pick the serve gauges up with zero new plumbing.  An optional
:class:`~repro_torch.serve.autoscale.ServeAutoscaler` observes the same
gauges and drives ``inject_grow`` / ``inject_retire`` — backlog grows the
pool, sustained idleness shrinks it.

The payloads close over the engine, so ServeDriver requires an IN-PROCESS
executor (``ThreadExecutor``): the prefill and decode tasks run on the
executor's threads, on the model's device, and the shared cache is mutated
only by the decode task and, between decode tasks, by ServeDriver's
thread.  The cross-process serving story is one engine per worker behind a
router, not one cache across workers.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

from repro_torch.core.scheduler import SchedulerSession
from repro_torch.core.task import TaskDescription, TaskState
from repro_torch.serve.autoscale import ServeAutoscaler
from repro_torch.serve.continuous import ContinuousEngine
from repro_torch.serve.engine import Request

PREFILL_PIPELINE = "serve-prefill"
DECODE_PIPELINE = "serve-decode"


class ServeDriver:
    def __init__(self, engine: ContinuousEngine, session: SchedulerSession,
                 *, prefill_ranks: int = 1, decode_ranks: int = 1,
                 decode_chunk: int = 8, admit_chunk: Optional[int] = None,
                 autoscaler: Optional[ServeAutoscaler] = None,
                 telemetry_interval: float = 0.05):
        self.engine = engine
        self.session = session
        self.prefill_ranks = prefill_ranks
        self.decode_ranks = decode_ranks
        self.decode_chunk = decode_chunk
        self.admit_chunk = admit_chunk or engine.max_batch
        self.autoscaler = autoscaler
        self.telemetry_interval = telemetry_interval
        self._seq = itertools.count()
        self._parked: list = []          # admissions awaiting a free slot
        self._prefill_uid: Optional[int] = None
        self._decode_uid: Optional[int] = None
        self._last_telemetry = -float("inf")

    # -- task factories ----------------------------------------------------
    def _submit_prefill(self, reqs: Sequence[Request]):
        eng = self.engine

        def payload(comm, reqs=tuple(reqs)):
            return [eng.prefill_request(r) for r in reqs]

        # max_retries=0: prefill is pure, but a retry would double-count the
        # serve_prefill_tokens evidence; failures surface to the caller
        [t] = self.session.submit([TaskDescription(
            name=f"serve-prefill#{next(self._seq)}", ranks=self.prefill_ranks,
            fn=payload, max_retries=0, tags={"pipeline": PREFILL_PIPELINE})])
        self._prefill_uid = t.uid

    def _submit_decode(self):
        eng, n = self.engine, self.decode_chunk

        def payload(comm):
            return eng.decode_rounds(n)

        # max_retries=0: decode_rounds mutates the slot cache per round, so
        # a blind re-run would decode the same positions twice
        [t] = self.session.submit([TaskDescription(
            name=f"serve-decode#{next(self._seq)}", ranks=self.decode_ranks,
            fn=payload, max_retries=0, tags={"pipeline": DECODE_PIPELINE})])
        self._decode_uid = t.uid

    # -- telemetry / autoscale --------------------------------------------
    def _pulse(self):
        eng = self.engine
        now = self.session.executor.now()
        if self.autoscaler is not None:
            self.autoscaler.observe(eng.queue_depth + len(self._parked),
                                    eng.slots_active, eng.max_batch)
        if now - self._last_telemetry < self.telemetry_interval:
            return
        self._last_telemetry = now
        snap = eng.metrics.snapshot()
        snap["serve_slot_occupancy"] = eng.slots_active / eng.max_batch
        self.session.record_telemetry(snap, worker="serve-driver")

    # -- the loop ----------------------------------------------------------
    def run(self, requests: Sequence[Request],
            timeout: Optional[float] = None) -> dict:
        """Serve ``requests`` to completion through scheduler tasks; returns
        uid -> generated tokens (evicted uids excluded).  Raises on a failed
        serve task — there is no silent partial result."""
        eng = self.engine
        pre_evicted, pre_results = len(eng.evicted), len(eng.results)
        eng.submit(list(requests))
        expected = len(requests) - (len(eng.evicted) - pre_evicted)
        deadline = None if timeout is None \
            else self.session.executor.now() + timeout
        while len(eng.results) - pre_results < expected:
            if deadline is not None and \
                    self.session.executor.now() > deadline:
                raise TimeoutError(
                    f"serve driver: {len(eng.results)}/{expected} finished")
            # 1. insert parked admissions — only while no decode task can
            #    be touching the shared cache
            if self._decode_uid is None:
                while self._parked and (eng.free_slots()
                                        or self._parked[0].req
                                        .max_new_tokens <= 1):
                    eng.insert(self._parked.pop(0))
            # 2. keep one prefill task in flight while requests queue and
            #    admission capacity (free + soon-free slots) exists
            if self._prefill_uid is None and eng.queue and \
                    len(self._parked) < self.admit_chunk:
                take = min(len(eng.queue),
                           self.admit_chunk - len(self._parked))
                reqs = [eng.queue.popleft() for _ in range(take)]
                self._submit_prefill(reqs)
            # 3. keep one decode task in flight while slots are live
            if self._decode_uid is None and eng.slots_active:
                self._submit_decode()
            self._pulse()
            if self._prefill_uid is None and self._decode_uid is None:
                continue   # nothing in flight: admission made progress above
            for task in self.session.wait_any(timeout=1.0):
                if task.uid == self._prefill_uid:
                    self._prefill_uid = None
                    if task.state is not TaskState.DONE:
                        raise RuntimeError(
                            f"serve prefill task failed: {task.error}")
                    self._parked.extend(task.result)
                    # the parked admissions now own their caches; a
                    # session keeps its tasks until it closes
                    task.result = None
                elif task.uid == self._decode_uid:
                    self._decode_uid = None
                    if task.state is not TaskState.DONE:
                        raise RuntimeError(
                            f"serve decode task failed: {task.error}")
        self._pulse()
        return dict(eng.results)
