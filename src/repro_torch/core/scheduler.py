"""Unified event-driven scheduler core — the paper's contribution, written
ONCE against an abstract ``Executor`` so the *identical* scheduling code runs
(a) live on real devices (``ThreadExecutor``), (b) on a virtual clock
at 84–2688 ranks (``VirtualClockExecutor``, the paper's ORNL-Summit scales),
and, in the JAX package and a later slice of this port, (c) across worker
*processes* (``ProcessExecutor``).

Two policies, mirroring the paper's §4.3 comparison:

* ``HETEROGENEOUS`` (Radical-Cylon): one shared pool; any released device
  immediately backfills any pending task from any pipeline.
* ``BATCH`` (LSF-style baseline): the pool is statically partitioned per
  pipeline; resources released by one pipeline are NOT available to others.
  Paper result: heterogeneous is 4–15 % faster at equal resources.

The core (``SchedulerSession``) owns policy, dispatch, retry with
device-exclusion, straggler detection with speculative re-execution, and
device-failure / elastic pool handling; the executor owns only the clock and
the mechanics of running one task.  Because the live executor is just another
backend, live mode gets retry-with-exclusion, spec-exec, stragglers, and
elastic shrink/grow for free — previously these existed only in the sim.

The session is persistent: tasks may be submitted while others run
(continuous DAG release, see ``core/pipeline.py``), and every lifecycle step
is appended to a per-task event trace (``TraceEvent``: submit / dispatch /
comm_build / done / fail / retry / speculate / cancel / device_failure /
steal / return / grow / retire / resume / cache_hit) consumed uniformly by
the benchmarks and ``SimReport``.

Long-running work survives churn cheaply: with ``ckpt_root`` (or
``REPRO_CKPT_DIR``) set, every launched attempt carries a checkpoint
namespace shared across the logical task's lineage, so retries and
spec-exec twins resume from the last durably completed step
(``resume`` trace event, ``resumed_from_step`` evidence); with
``result_cache`` (or ``REPRO_RESULT_CACHE``) naming a directory, a
resubmitted identical task completes straight from the stored result
(``cache_hit``) without dispatching.

The pool is elastic at runtime in BOTH directions on every backend: a
``grow`` event (``ProcessExecutor.add_worker``, ``inject_grow`` on live
executors, ``SimOptions.grow_at`` on the virtual clock) adds inventory and
backfills pending work in the same scheduler step; a ``retire`` event
(``ProcessExecutor.retire_worker``, ``inject_retire``, ``retire_at``)
withdraws inventory gracefully — draining tasks keep their devices until
they finish, the devices just never return to the free list.

Placement (``core/placement.py``) makes dispatch topology-aware: the core
asks the executor for its :class:`Topology` (node -> device handles) and
allocates through ``ResourceManager.allocate_placed`` under a placement
policy — ``spread`` (historical flat order) or ``pack`` (fewest nodes; on
the process executor a fitting task lands on ONE worker and its collectives
never touch the parent hub).  Under ``BATCH``, ``work_stealing=True`` makes
the static partitions elastic: a partition with a backlog leases idle
devices a sibling partition doesn't need (``steal`` trace event) and hands
them back on release (``return``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import statistics
import threading
import time as _time
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.core.executors import serialize as _serialize

from repro_torch.core.executors import (
    ExecEvent, Executor, SimOptions, StubComm, ThreadExecutor,
    VirtualClockExecutor, default_overhead_model,
)
from repro_torch.core.pilot import InsufficientResources, ResourceManager
from repro_torch.obs import trace as _obs_trace
from repro_torch.core.placement import PACK, PLACEMENTS, SPREAD, Topology
from repro_torch.core.task import Task, TaskDescription, TaskState

__all__ = [  # executor names are re-exported for historical import paths
    "BATCH", "HETEROGENEOUS", "PACK", "PLACEMENTS", "SPREAD", "ExecEvent",
    "Executor", "LiveScheduler", "SchedulerSession", "SimOptions",
    "SimReport", "StubComm", "ThreadExecutor", "Topology", "TraceEvent",
    "VirtualClockExecutor", "default_overhead_model",
    "interleave_by_pipeline", "simulate",
]

HETEROGENEOUS = "heterogeneous"
BATCH = "batch"

_SHARED = "_shared"


def interleave_by_pipeline(tasks):
    """Round-robin the pending queue across pipeline tags (stable within a
    pipeline, priority respected).  Prevents the convoy effect where one
    pipeline's long tasks monopolize the shared pool — without this, FIFO
    heterogeneous scheduling can lose to static batch partitions on
    imbalanced mixes (observed; see EXPERIMENTS.md §Perf notes)."""
    groups: dict = {}
    for t in tasks:
        groups.setdefault(t.desc.tags.get("pipeline", "default"), []).append(t)
    out = []
    while any(groups.values()):
        for g in list(groups):
            if groups[g]:
                out.append(groups[g].pop(0))
    out.sort(key=lambda t: -t.desc.priority)  # stable: RR preserved per prio
    return out


# ---------------------------------------------------------------------------
# event trace — one schema for sim and live, consumed by benchmarks/ and
# SimReport (schema documented in docs/ARCHITECTURE.md)
# ---------------------------------------------------------------------------

#: The closed vocabulary of ``TraceEvent.kind``.  Every ``_tr()`` call in
#: this module emits one of these, and docs/ARCHITECTURE.md documents each —
#: the docs-honesty check (tests/test_docs.py) holds both sides to it, so a
#: new kind cannot ship undeclared or undocumented.
TRACE_EVENT_KINDS = frozenset({
    "submit", "dispatch", "comm_build", "done", "fail", "retry", "speculate",
    "cancel", "device_failure", "steal", "return", "grow", "retire",
    "telemetry", "resume", "cache_hit",
})


@dataclasses.dataclass
class TraceEvent:
    t: float          # executor clock (virtual seconds or perf_counter)
    kind: str         # submit|dispatch|comm_build|done|fail|retry|speculate|
                      # cancel|device_failure|steal|return|grow|retire|
                      # telemetry|resume|cache_hit
    task: str = ""    # task name ("" for pool-level events)
    uid: int = -1
    pipeline: str = ""
    ranks: int = 0
    value: float = 0.0   # kind-specific payload (comm_build: seconds;
                         # device_failure: #devices lost; steal/return:
                         # #devices leased across partitions / handed back;
                         # grow/retire: #devices joining/leaving the pool;
                         # resume: checkpoint step the attempt restored)
    p2p: float = 0.0     # comm-stats evidence on terminal done/fail events:
                         # bytes the task's collectives moved worker-to-
                         # worker.  The process executor reports real bytes;
                         # sim/thread backends report 0 — same schema.
    spills: float = 0.0  # shuffle partitions the task spilled to disk
                         # (out-of-core shuffle evidence, same schema rule)
    data: dict = dataclasses.field(default_factory=dict)
                         # kind-specific structured payload: terminal events
                         # carry {hub_calls, p2p_fallbacks, hub_relay_bytes}
                         # (the comm-stats evidence trace_summary reports);
                         # telemetry events carry the worker id + its gauge
                         # snapshot.  Empty dict everywhere else — the
                         # schema never forks per backend.

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SimReport:
    makespan: float
    tasks: list
    overhead_total: float
    per_pipeline: dict
    n_speculative: int = 0
    n_retries: int = 0
    trace: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)   # worker-side
    # flight-recorder spans aligned into the executor clock; empty on
    # backends without instrumented workers (sim/thread) — same schema
    telemetry: list = dataclasses.field(default_factory=list)   # heartbeat
    # gauge snapshots ({t, worker, queue_depth, rss_mb, ...}); empty on
    # sim/thread backends

    def pipeline_makespan(self, key: str) -> float:
        return self.per_pipeline.get(key, 0.0)

    def events(self, kind: Optional[str] = None) -> list:
        """Filter the event trace by kind (None -> whole trace)."""
        if kind is None:
            return list(self.trace)
        return [e for e in self.trace if e.kind == kind]


# ---------------------------------------------------------------------------
# the scheduler core
# ---------------------------------------------------------------------------
class SchedulerSession:
    """Persistent scheduling session over one executor + one device pool.

    Supports continuous task release: ``submit`` may be called at any time
    (e.g. the moment a DAG stage's deps complete) and freed devices backfill
    pending work immediately — no wave barrier.  ``wait_any`` blocks until at
    least one task reaches DONE/FAILED; ``drain`` runs everything to
    completion; ``close`` returns the ``SimReport`` with the event trace.
    """

    def __init__(self, executor: Executor, resource_manager: ResourceManager,
                 policy: str = HETEROGENEOUS,
                 pipelines: Optional[Sequence[str]] = None,
                 speculative_factor: Optional[float] = None,
                 tick: float = 0.05, placement: str = SPREAD,
                 work_stealing: bool = False,
                 trace_path: Optional[str] = None,
                 ckpt_root: Optional[str] = None,
                 result_cache: Optional[str] = None):
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}; expected "
                             f"one of {PLACEMENTS}")
        self.executor = executor
        self.rm = resource_manager
        self.policy = policy
        self.placement = placement
        self.work_stealing = work_stealing
        self.speculative_factor = speculative_factor
        self.tick = tick
        self.t0 = executor.now()
        self.tasks: list[Task] = []
        self.pending: list[Task] = []
        self.running: dict[int, Task] = {}
        self.trace: list[TraceEvent] = []
        self.spans: list[dict] = []      # worker flight-recorder spans,
        # parent-clock aligned (empty on sim/thread — same schema)
        self.telemetry: list[dict] = []  # heartbeat gauge snapshots
        # durable capture: every TraceEvent/span/telemetry record streams to
        # JSONL as it happens (crash-safe line-buffered writes) when
        # trace_path or the REPRO_TRACE env knob names a destination
        self._writer = None
        path = _obs_trace.resolve_trace_path(trace_path)
        if path:
            self._writer = _obs_trace.TraceWriter(path)
            self._writer.meta(
                n_devices=resource_manager.total, policy=policy,
                placement=placement, t0=self.t0,
                backend=type(executor).__name__,
                wall_clock=bool(executor.wall_clock))
        self.overhead_total = 0.0
        self.n_speculative = 0
        self.n_retries = 0
        self._done_durations: dict[str, list] = {}
        self._finished_uids: set = set()
        self._ignored: set = set()   # live attempts whose outcome no longer
        # matters (spec-exec losers): their event only releases devices
        self._declared = list(pipelines) if pipelines else []
        self._pools: Optional[dict[str, ResourceManager]] = None
        self._batch_devs: tuple = ()
        self._leases: dict[int, list] = {}   # uid -> [(lender_pool, devs)]:
        # work-stealing bookkeeping so released devices return to the
        # partition they were leased from, never the thief's own pool
        self._max_timeout = 0.0   # largest wait budget seen; sizes the reaper
        # crash-safe resume: every attempt of one logical task checkpoints
        # under <ckpt_root>/t<primary_uid>, so retries and spec-exec twins
        # restore the doomed attempt's last durable step (REPRO_CKPT_DIR)
        if ckpt_root is None:
            ckpt_root = os.environ.get("REPRO_CKPT_DIR", "")
        self.ckpt_root = ckpt_root or None
        # result memoization keyed on (fn, args, kwargs, ranks) digests:
        # a repeated identical DAG run completes finished stages straight
        # from disk with a cache_hit event (REPRO_RESULT_CACHE=<dir>, "0"
        # or empty disables; live executors only — sim results are fake)
        if result_cache is None:
            result_cache = os.environ.get("REPRO_RESULT_CACHE", "")
        self.result_cache = None if result_cache in ("", "0") else result_cache
        self._cache_done: list[Task] = []   # cache-completed tasks awaiting
        # delivery through wait_any, so drain()/run_pipelines see them

    # -- trace ------------------------------------------------------------
    def _tr(self, kind: str, task: Optional[Task] = None, t: Optional[float] = None,
            value: float = 0.0, p2p: float = 0.0, spills: float = 0.0,
            data: Optional[dict] = None):
        ev = TraceEvent(
            t=self.executor.now() if t is None else t, kind=kind,
            task=task.desc.name if task else "",
            uid=task.uid if task else -1,
            pipeline=task.desc.tags.get("pipeline", "default") if task else "",
            ranks=task.desc.ranks if task else 0, value=value, p2p=p2p,
            spills=spills, data=data or {})
        self.trace.append(ev)
        if self._writer is not None:
            self._writer.event(ev)

    def _record_spans(self, spans):
        if not spans:
            return
        self.spans.extend(spans)
        if self._writer is not None:
            for s in spans:
                self._writer.span(s)

    # -- pools ------------------------------------------------------------
    def _ensure_pools(self, descs: Sequence[TaskDescription]):
        if self._pools is not None:
            if self.policy == BATCH:
                unknown = {d.tags.get("pipeline", "default") for d in descs} \
                    - set(self._pools)
                if unknown:
                    raise InsufficientResources(
                        f"batch policy: pipelines {sorted(unknown)} were not "
                        f"declared when the pool was partitioned; pass "
                        f"pipelines=[...] at session start")
            return
        if self.policy == BATCH:
            pipes = sorted(set(self._declared)
                           | {d.tags.get("pipeline", "default") for d in descs})
            share = self.rm.total // len(pipes)
            if share == 0:
                raise InsufficientResources(
                    f"batch policy: {len(pipes)} pipelines over "
                    f"{self.rm.total} devices leaves 0 devices per partition")
            devs = self.rm.allocate(share * len(pipes))
            self._batch_devs = devs
            self._pools = {p: ResourceManager(devs[i * share:(i + 1) * share])
                           for i, p in enumerate(pipes)}
        else:
            self._pools = {_SHARED: self.rm}

    def _pool_of(self, task: Task) -> ResourceManager:
        if self.policy == BATCH:
            return self._pools[task.desc.tags.get("pipeline", "default")]
        return self._pools[_SHARED]

    # -- public API -------------------------------------------------------
    def submit(self, descs: Sequence[TaskDescription]) -> list[Task]:
        """Enqueue tasks; dispatches immediately onto any free devices."""
        descs = list(descs)
        for d in descs:
            if self.executor.wall_clock and d.fn is None:
                raise ValueError(
                    f"task {d.name!r}: fn is required for live execution "
                    f"(duration_model alone only drives the virtual clock)")
            if not self.executor.wall_clock and d.duration_model is None:
                raise ValueError(
                    f"task {d.name!r}: duration_model is required on the "
                    f"virtual clock")
        self._ensure_pools(descs)
        now = self.executor.now()
        tasks = [Task(desc=d) for d in descs]
        for t in tasks:
            t.state = TaskState.PENDING
            t.submit_time = now
            self._tr("submit", t, t=now)
        self.tasks.extend(tasks)
        for t in tasks:
            if not self._cache_load(t):
                self.pending.append(t)
        self._dispatch()
        return tasks

    @property
    def outstanding(self) -> int:
        """Tasks still owed a terminal state.  Spec-exec losers do not
        count: their live threads may linger, but the workload result no
        longer depends on them."""
        return len(self.pending) + len(self._cache_done) + sum(
            1 for uid in self.running if uid not in self._ignored)

    def wait_any(self, timeout: Optional[float] = None) -> list[Task]:
        """Block until >=1 task finishes (DONE or FAILED); returns them.
        An empty list means stuck (nothing running and pending tasks cannot
        dispatch) or timeout."""
        finished: list[Task] = []
        if self._cache_done:
            # cache-completed tasks never touch the executor; deliver them
            # like any other completion so DAG drivers release dependents
            finished, self._cache_done = self._cache_done, []
        enforce = timeout is not None and self.executor.wall_clock
        if enforce:
            self._max_timeout = max(self._max_timeout, timeout)
        start = self.executor.now()
        while not finished:
            if enforce and self.executor.now() - start > timeout:
                break
            active = any(uid not in self._ignored for uid in self.running)
            if not active and not self.pending:
                break                          # fully drained (canceled
                                               # threads may still linger)
            if not self.running:
                self._dispatch()               # elastic grow may unblock us
                if self.running:
                    continue
                ev = self.executor.poll(self.tick)
                if ev is None:
                    break                      # virtual clock: truly stuck
                if ev.kind == "tick":
                    if enforce:
                        continue   # live + deadline: keep waiting — an
                                   # elastic grow may make pending feasible
                    break          # no deadline to bound the wait: stuck
                finished.extend(self._handle(ev))
                continue
            ev = self.executor.poll(self.tick)
            if ev is None:
                break   # virtual clock exhausted with tasks in flight: bug
            if ev.kind == "tick":
                self._maybe_speculate()
                self._dispatch()
                continue
            finished.extend(self._handle(ev))
        # opportunistically absorb events that are already ready
        while True:
            ev = self.executor.poll(0)
            if ev is None:
                break
            if ev.kind != "tick":
                finished.extend(self._handle(ev))
        return finished

    def drain(self, timeout: Optional[float] = None) -> "SchedulerSession":
        """Run until every submitted task reached a terminal state, the
        queue is stuck, or — on a wall-clock executor — ``timeout`` expires.
        Timeouts are a hang guard and are NOT applied to virtual clocks,
        whose runs always terminate on their own."""
        if not self.executor.wall_clock:
            timeout = None
        t_end = None if timeout is None else self.executor.now() + timeout
        while self.outstanding:
            remaining = None if t_end is None else t_end - self.executor.now()
            if remaining is not None and remaining <= 0:
                break
            got = self.wait_any(timeout=remaining)
            if not got and not self.running:
                break   # stuck: pending tasks can never dispatch
        return self

    def close(self) -> SimReport:
        """Return the report; batch partitions are handed back to the pool."""
        # spec-exec losers and (on a failure teardown) still-running sibling
        # tasks hold devices their live threads are still using; they are
        # reclaimed by the background reaper below as each thread actually
        # finishes — never eagerly, which would double-issue a busy device.
        if self._batch_devs:
            # hand partitions back to the parent pool, but (a) never a device
            # a still-running worker thread holds — it stays allocated rather
            # than being double-issued — and (b) never a device that failed
            # during the session: propagate the failure to the parent so dead
            # devices stay dead.
            busy = {d for t in self.running.values() for d in t.devices}
            dead = set()
            for pool in self._pools.values():
                dead |= pool.failed_devices
            self.rm.fail_devices([d for d in self._batch_devs if d in dead])
            self.rm.release([d for d in self._batch_devs
                             if d not in busy and d not in dead])
            self._batch_devs = ()
        if self.running:
            # live worker threads may outlive the session (e.g. a sibling
            # task mid-run when a stage failure tears the DAG down).  Their
            # devices cannot be released while busy, so reap in the
            # background: as each thread delivers its event, hand the
            # devices back to the caller's ResourceManager.
            leftovers = {uid: t for uid, t in self.running.items()}
            executor, rm = self.executor, self.rm
            # outlive any wait budget the session was driven with, so a
            # legitimately long sibling task finishing inside its timeout
            # always gets its devices returned
            deadline = _time.monotonic() + max(600.0, 2 * self._max_timeout)

            def _reap():
                remaining = set(leftovers)
                while remaining and _time.monotonic() < deadline:
                    ev = executor.poll(1.0)
                    if ev is None:
                        return
                    t = ev.task
                    if t is not None and t.uid in remaining:
                        remaining.discard(t.uid)
                        rm.release(t.devices)

            threading.Thread(target=_reap, daemon=True).start()
            self.running = {}
        t0 = self.t0
        done = [t for t in self.tasks if t.state == TaskState.DONE]
        makespan = max((t.end_time for t in done),
                       default=self.executor.now()) - t0
        per_pipeline: dict[str, float] = {}
        for t in done:
            key = t.desc.tags.get("pipeline", "default")
            per_pipeline[key] = max(per_pipeline.get(key, 0.0),
                                    t.end_time - t0)
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        return SimReport(makespan=makespan, tasks=list(self.tasks),
                         overhead_total=self.overhead_total,
                         per_pipeline=per_pipeline,
                         n_speculative=self.n_speculative,
                         n_retries=self.n_retries, trace=list(self.trace),
                         spans=list(self.spans),
                         telemetry=list(self.telemetry))

    def run(self, descs: Sequence[TaskDescription],
            timeout: Optional[float] = None) -> SimReport:
        """Convenience: submit everything, drain, close."""
        self.submit(descs)
        self.drain(timeout=timeout)
        return self.close()

    def record_telemetry(self, snapshot: dict, worker: str = "app"):
        """Public telemetry hook: surface an application-level gauge/counter
        snapshot (e.g. the serve tier's queue depth and slot occupancy) as a
        ``telemetry`` TraceEvent — the SAME stream worker heartbeats feed,
        so the flight recorder, ``load_trace`` and the Perfetto exporter
        pick application gauges up with zero extra plumbing."""
        rec = dict(snapshot)
        rec.setdefault("t", self.executor.now())
        rec.setdefault("worker", worker)
        self.telemetry.append(rec)
        self._tr("telemetry", t=rec["t"], data=rec)
        if self._writer is not None:
            self._writer.telemetry(rec)

    # -- checkpoint + result cache ----------------------------------------
    def _bind_ckpt(self, task: Task):
        """Stamp the attempt's checkpoint namespace before launch.  Every
        attempt of one logical task — primary retries ``a0, a1, ...`` and
        spec-exec twins ``s<uid>`` — shares ``<ckpt_root>/t<primary_uid>``,
        so a relaunch reads the doomed attempt's durable steps while writing
        only into its own attempt dir (see ``train.checkpoint``)."""
        if not self.ckpt_root:
            task.ckpt_dir = ""
            task.ckpt_attempt = ""
            return
        primary_uid = task.speculative_of \
            if task.speculative_of is not None else task.uid
        task.ckpt_dir = os.path.join(self.ckpt_root, f"t{primary_uid}")
        task.ckpt_attempt = (f"s{task.uid}" if task.speculative_of is not None
                             else f"a{task.retries}")

    def _cache_key(self, desc: TaskDescription) -> str:
        """Digest of (fn, args, kwargs, ranks) — "" when uncacheable (no fn,
        or the payload does not serialize deterministically)."""
        if desc.fn is None:
            return ""
        try:
            h = hashlib.sha256()
            h.update(_serialize.dumps((desc.fn, desc.args, desc.kwargs)))
            h.update(str(desc.ranks).encode())
            return h.hexdigest()
        except Exception:
            return ""

    def _cache_load(self, task: Task) -> bool:
        """Try to complete ``task`` straight from the result cache.  On a
        hit the task never dispatches: it goes DONE with the deserialized
        (bit-identical) stored result, emits ``cache_hit``, and is delivered
        through the next ``wait_any`` like any other completion."""
        if not (self.result_cache and self.executor.wall_clock):
            return False
        task.cache_key = self._cache_key(task.desc)
        if not task.cache_key:
            return False
        try:
            blob = (Path(self.result_cache)
                    / f"{task.cache_key}.pkl").read_bytes()
            result = _serialize.loads(blob)
        except Exception:
            return False   # miss, or a torn/unreadable entry: recompute
        now = self.executor.now()
        task.state = TaskState.DONE
        task.result = result
        task.cache_hit = True
        task.start_time = now
        task.end_time = now
        self._finished_uids.add(task.uid)
        self._tr("cache_hit", task, t=now)
        self._tr("done", task, t=now, data={"cache_hit": True})
        self._cache_done.append(task)
        return True

    def _cache_store(self, task: Task):
        """Persist a DONE task's result (tmp + os.replace, so concurrent
        sessions sharing a cache dir never observe a torn entry)."""
        if not (self.result_cache and task.cache_key) or task.cache_hit:
            return
        try:
            blob = _serialize.dumps(task.result)
        except Exception:
            return   # unserializable result: simply not cacheable
        try:
            root = Path(self.result_cache)
            root.mkdir(parents=True, exist_ok=True)
            tmp = root / f".{task.cache_key}.tmp.{os.getpid()}"
            tmp.write_bytes(blob)
            os.replace(tmp, root / f"{task.cache_key}.pkl")
        except OSError:
            return

    # -- internals --------------------------------------------------------
    def _allocate(self, pool: ResourceManager, n: int, exclude) -> tuple:
        """All scheduler allocations flow through the placement layer: the
        executor's topology report + the session's placement policy decide
        WHICH free devices a task gets, not just how many."""
        return pool.allocate_placed(n, topology=self.executor.topology,
                                    policy=self.placement, exclude=exclude)

    def _pending_need(self) -> dict:
        """Per-pool rank demand of the pending queue (keyed by pool id) —
        the floor below which a partition will not lend devices.  Computed
        once per dispatch sweep, decremented as tasks dispatch, so a deep
        backlog stays O(pending) per sweep instead of O(pending^2)."""
        need: dict[int, int] = {}
        for p in self.pending:
            pid = id(self._pool_of(p))
            need[pid] = need.get(pid, 0) + p.desc.ranks
        return need

    def _try_steal(self, task: Task, home: ResourceManager,
                   pending_need: dict) -> bool:
        """BATCH elasticity via work-stealing: when ``task`` overflows its
        own static partition, lease the shortfall from sibling partitions
        that have idle devices beyond their OWN pending demand (the
        ``pending_need`` floor; the thief's own demand presses only on its
        home pool, which is never a lender to itself).  Leased devices are
        tracked per task and handed back to their lender on release
        (``steal``/``return`` trace events) — the partitions stay
        statically owned, only idle capacity moves."""
        need = task.desc.ranks - home.n_free
        offers: list = []
        offered = 0
        for victim in self._pools.values():
            if victim is home or offered == need:
                continue
            spare = victim.n_free - pending_need.get(id(victim), 0)
            take = min(max(spare, 0), need - offered)
            if take > 0:
                offers.append((victim, take))
                offered += take
        if offered < need:
            return False
        leases = []
        stolen: list = []
        for victim, take in offers:
            got = self._allocate(victim, take, task.excluded_devices)
            leases.append((victim, got))
            stolen.extend(got)
        own = self._allocate(home, task.desc.ranks - len(stolen),
                             task.excluded_devices)
        task.devices = tuple(own) + tuple(stolen)
        self._leases[task.uid] = leases
        self._tr("steal", task, value=float(len(stolen)))
        return True

    def _release_task(self, task: Task):
        """Hand a task's devices back: leased devices return to the
        partition that lent them (``return`` trace event), the rest to the
        task's home pool.  The event's value counts devices ACTUALLY handed
        back — a leased device that died mid-lease left the lender's
        inventory via its device_failure event and must not be double-
        counted as returned."""
        leases = self._leases.pop(task.uid, None)
        if not leases:
            self._pool_of(task).release(task.devices)
            return
        leased: set = set()
        returned = 0
        for lender, devs in leases:
            returned += sum(1 for d in devs if d in lender)
            lender.release(devs)
            leased.update(devs)
        self._pool_of(task).release([d for d in task.devices
                                     if d not in leased])
        self._tr("return", task, value=float(returned))

    def _dispatch(self):
        progressed = True
        stealing = self.work_stealing and self.policy == BATCH
        while progressed:
            progressed = False
            pending_need = self._pending_need() if stealing else None
            for task in interleave_by_pipeline(list(self.pending)):
                pool = self._pool_of(task)
                if pool.n_free >= task.desc.ranks:
                    task.devices = self._allocate(pool, task.desc.ranks,
                                                  task.excluded_devices)
                elif not (stealing
                          and self._try_steal(task, pool, pending_need)):
                    continue
                if pending_need is not None:   # dispatched: its demand no
                    pending_need[id(pool)] -= task.desc.ranks   # longer queues
                self.pending.remove(task)
                task.state = TaskState.RUNNING
                task.placement = self.placement
                task.start_time = self.executor.now()
                self.running[task.uid] = task
                self._bind_ckpt(task)
                self._tr("dispatch", task)
                self.executor.launch(task)
                progressed = True

    def _maybe_speculate(self):
        """Spec-exec: if a running task exceeds factor x median of completed
        same-name tasks, launch a duplicate on free resources."""
        if not self.speculative_factor:
            return
        now = self.executor.now()
        for task in list(self.running.values()):
            if task.speculative_of is not None or \
                    task.uid in self._ignored or \
                    task.uid in self._finished_uids:
                # never duplicate a duplicate, a canceled loser whose live
                # thread lingers, or a task already decided
                continue
            hist = self._done_durations.get(task.desc.name)
            if not hist or len(hist) < 3:
                continue
            med = statistics.median(hist)
            if now - task.start_time > self.speculative_factor * med:
                pool = self._pool_of(task)
                if pool.n_free >= task.desc.ranks and \
                        not any(r.speculative_of == task.uid
                                for r in self.running.values()):
                    dup = Task(desc=task.desc)
                    dup.speculative_of = task.uid
                    dup.state = TaskState.RUNNING
                    dup.submit_time = now
                    dup.start_time = now
                    dup.placement = self.placement
                    dup.devices = self._allocate(pool, task.desc.ranks,
                                                 set(task.devices))
                    self.running[dup.uid] = dup
                    self._bind_ckpt(dup)
                    self._tr("speculate", dup)
                    self.executor.launch(dup, duration_hint=med)
                    self.n_speculative += 1

    def _cancel_twin(self, primary_uid: int):
        # a retry-pending primary whose duplicate already finished must be
        # purged from the queue, or it would be dispatched (and executed)
        # a second time after being marked DONE
        for p in list(self.pending):
            if p.uid == primary_uid or p.speculative_of == primary_uid:
                self.pending.remove(p)
        for r in list(self.running.values()):
            if r.uid == primary_uid or r.speculative_of == primary_uid:
                r.state = TaskState.CANCELED
                self._tr("cancel", r)
                if self.executor.cancel(r):
                    del self.running[r.uid]
                    self._release_task(r)
                else:
                    # the live thread finishes on its own; its event only
                    # releases the devices in _handle
                    self._ignored.add(r.uid)

    def _grow_pool(self) -> ResourceManager:
        """Where grown inventory lands: the shared pool (HETEROGENEOUS), or
        the parent pool under BATCH — the static partitions stay exactly as
        declared, so new devices are parent leftovers until a future session
        repartitions over them."""
        if self._pools and _SHARED in self._pools:
            return self._pools[_SHARED]
        return self.rm

    def _invent_devices(self, n: int) -> tuple:
        """Anonymous grow (virtual-clock injection): invent ``n`` fresh
        handles that cannot collide with live, busy, or previously failed
        inventory — an all-int pool (the sim's rank ids) keeps growing the
        integer range so ``SimOptions.devices_per_node`` topologies stay
        well-defined on the new devices."""
        known = set(self.rm.all_devices) | self.rm.failed_devices
        for pool in (self._pools or {}).values():
            known |= set(pool.all_devices) | pool.failed_devices
        if known and all(isinstance(d, int) for d in known):
            base = max(known) + 1
            return tuple(range(base, base + n))
        out, i = [], 0
        while len(out) < n:
            h = f"grown{i}"
            if h not in known:
                out.append(h)
            i += 1
        return tuple(out)

    def _handle(self, ev: ExecEvent) -> list[Task]:
        now = self.executor.now()
        if ev.kind == "telemetry":
            # a worker heartbeat's gauge snapshot: surfaced as a periodic
            # trace event so a stuck or swapping worker (climbing RSS, flat
            # queue) is visible in the recorded trace BEFORE it misses
            # liveness and becomes a device_failure
            rec = dict(ev.telemetry or {})
            rec.setdefault("t", now)
            rec["worker"] = ev.worker
            self.record_telemetry(rec, worker=ev.worker)
            return []
        if ev.kind == "grow":
            # elastic grow: the executor (ProcessExecutor.add_worker /
            # inject_grow) names the exact joining handles; the virtual
            # clock's grow_at injection leaves them anonymous and the core
            # invents fresh ones.  Pending work becomes feasible in the SAME
            # scheduler step: _dispatch runs before this event returns.
            devs = tuple(ev.devices) or self._invent_devices(ev.n_devices)
            pool = self._grow_pool()
            fresh = [d for d in devs if d not in pool]
            pool.add_devices(fresh)
            self._tr("grow", value=float(len(fresh)))
            self._dispatch()
            return []
        if ev.kind in ("device_failure", "retire"):
            if ev.devices:
                # targeted (process executor: a crashed worker's exact
                # inventory dies, or a retiring worker's inventory stops
                # being leased — busy or free).  Partition pools are checked
                # first; in BATCH the rounding leftovers live in the parent
                # pool.  Busy departed devices stay marked failed, so the
                # release() in their task's terminal event is a no-op — a
                # draining retire lets the task finish, but its devices
                # never return to the free list.
                pools = list(self._pools.values()) if self._pools else []
                if self.rm not in pools:
                    pools.append(self.rm)
                n, seen = 0, set()
                for pool in pools:
                    hit = [d for d in ev.devices
                           if d not in seen and d in pool]
                    if hit:
                        pool.fail_devices(hit)
                        seen.update(hit)
                        n += len(hit)
            else:
                # anonymous shrink (virtual-clock injection): lose up to
                # n_devices arbitrary FREE devices
                pool = max((self._pools or {_SHARED: self.rm}).values(),
                           key=lambda p: p.n_free)
                n = min(ev.n_devices, pool.n_free)
                if n:
                    pool.fail_devices(pool.allocate(n))
            self._tr(ev.kind, value=float(n))   # devices LOST/retired, which
            # may be fewer than requested when the pool is busy
            self._dispatch()
            return []

        task = ev.task
        if task.uid not in self.running:
            return []    # event for a task already aborted by the executor
        del self.running[task.uid]
        self._release_task(task)
        # comm-stats evidence travels with the completion event (last
        # attempt wins on retries); 0 on backends without a cross-process
        # data plane, real bytes/round-trips on the process executor
        task.p2p_bytes = ev.p2p_bytes
        task.hub_calls = ev.hub_calls
        task.spills = ev.spills
        task.p2p_fallbacks = ev.p2p_fallbacks
        task.hub_relay_bytes = ev.hub_relay_bytes
        task.raw_coll_bytes = ev.raw_coll_bytes
        task.shm_bytes = ev.shm_bytes
        task.ring_steps = ev.ring_steps
        task.resumed_from_step = ev.resumed_from_step
        # worker flight-recorder spans arrive piggybacked on the terminal
        # event, already aligned into this executor's clock
        self._record_spans(ev.spans)
        stats = {"hub_calls": ev.hub_calls,
                 "p2p_fallbacks": ev.p2p_fallbacks,
                 "hub_relay_bytes": ev.hub_relay_bytes,
                 "raw_coll_bytes": ev.raw_coll_bytes,
                 "shm_bytes": ev.shm_bytes,
                 "ring_steps": ev.ring_steps,
                 "resumed_from_step": ev.resumed_from_step}
        if task.uid in self._ignored:
            self._ignored.discard(task.uid)
            self._dispatch()   # live twin finished after cancel: reclaim only
            return []
        if ev.comm_build_s:
            task.comm_build_time = ev.comm_build_s
            self.overhead_total += ev.comm_build_s
            self._tr("comm_build", task, t=task.start_time + ev.comm_build_s,
                     value=ev.comm_build_s)
        if ev.resumed_from_step:
            # crash-safe resume evidence: this attempt restored the lineage's
            # durable step N instead of re-running from scratch
            self._tr("resume", task, value=float(ev.resumed_from_step))

        primary_uid = task.speculative_of if task.speculative_of is not None \
            else task.uid

        if ev.kind == "fail" and task.speculative_of is not None:
            # a speculative duplicate died: the primary is still running and
            # must not be cancelled or credited — just reclaim the devices
            task.state = TaskState.FAILED
            task.error = ev.error
            self._tr("fail", task, p2p=float(ev.p2p_bytes),
                     spills=float(ev.spills), data=stats)
            self._dispatch()
            return []

        if ev.kind == "fail" and task.speculative_of is None:
            task.retries += 1
            self.n_retries += 1
            task.excluded_devices |= set(task.devices)
            if task.retries <= task.desc.max_retries:
                task.state = TaskState.PENDING
                self._tr("retry", task)
                self.pending.append(task)
                self._dispatch()
                return []
            task.state = TaskState.FAILED
            task.error = ev.error
            task.end_time = now
            self._tr("fail", task, p2p=float(ev.p2p_bytes),
                     spills=float(ev.spills), data=stats)
            # terminal: a still-running speculative duplicate must not flip
            # this task back to DONE later
            self._finished_uids.add(task.uid)
            self._cancel_twin(task.uid)
            self._dispatch()
            return [task]

        if primary_uid in self._finished_uids:
            self._dispatch()
            return []
        self._finished_uids.add(primary_uid)
        self._cancel_twin(primary_uid)
        target = task if task.speculative_of is None else \
            next(t for t in self.tasks if t.uid == primary_uid)
        target.state = TaskState.DONE
        target.end_time = now
        target.result = ev.result
        target.p2p_bytes = ev.p2p_bytes
        target.hub_calls = ev.hub_calls
        target.spills = ev.spills
        target.p2p_fallbacks = ev.p2p_fallbacks
        target.hub_relay_bytes = ev.hub_relay_bytes
        target.raw_coll_bytes = ev.raw_coll_bytes
        target.shm_bytes = ev.shm_bytes
        target.ring_steps = ev.ring_steps
        target.resumed_from_step = ev.resumed_from_step
        self._done_durations.setdefault(target.desc.name, []).append(
            now - target.start_time)
        self._cache_store(target)
        self._tr("done", target, p2p=float(ev.p2p_bytes),
                 spills=float(ev.spills), data=stats)
        self._maybe_speculate()
        self._dispatch()
        return [target]


# ---------------------------------------------------------------------------
# the two historical entry points, now thin shims over the unified core
# ---------------------------------------------------------------------------
def simulate(descs: Sequence[TaskDescription], n_devices: int,
             opts: Optional[SimOptions] = None) -> SimReport:
    """Event-driven virtual-clock execution of ``descs`` on ``n_devices``.

    Deterministic for a given seed.  Each TaskDescription must provide
    ``duration_model(ranks) -> seconds`` and ``tags['pipeline']``.
    """
    opts = opts or SimOptions()
    rm = ResourceManager(list(range(n_devices)))
    sess = SchedulerSession(VirtualClockExecutor(opts), rm,
                            policy=opts.policy,
                            speculative_factor=opts.speculative_factor,
                            placement=opts.placement,
                            work_stealing=opts.work_stealing)
    return sess.run(descs)


class LiveScheduler:
    """Runs TaskDescriptions on real devices.  fn(comm, *args) is executed in
    a worker thread with a freshly built private Communicator; released
    devices backfill pending tasks (heterogeneous policy) or stay inside
    their pipeline partition (batch policy).

    Thin facade over ``SchedulerSession`` + a live executor — the same
    dispatch/retry/spec-exec code path as ``simulate``.  The backend is
    selectable: the default ``ThreadExecutor`` runs tasks in-process; pass a
    started :class:`ProcessExecutor` (whose ``resource_manager()`` supplied
    the device pool) to run the same workload across worker processes."""

    def __init__(self, resource_manager: ResourceManager,
                 policy: str = HETEROGENEOUS,
                 speculative_factor: Optional[float] = None,
                 executor: Optional[Executor] = None,
                 placement: str = SPREAD, work_stealing: bool = False):
        self.rm = resource_manager
        self.policy = policy
        self.placement = placement
        self.work_stealing = work_stealing
        self.speculative_factor = speculative_factor
        self.executor = executor
        self.tasks: list[Task] = []

    def run(self, descs: Sequence[TaskDescription],
            timeout: float = 600.0) -> SimReport:
        sess = SchedulerSession(self.executor or ThreadExecutor(), self.rm,
                                policy=self.policy,
                                speculative_factor=self.speculative_factor,
                                placement=self.placement,
                                work_stealing=self.work_stealing)
        rep = sess.run(descs, timeout=timeout)
        self.tasks = rep.tasks
        return rep
