"""Executor interface: the seam between the scheduler core (policy, retry,
spec-exec, pool handling) and the mechanics of actually running one task.

Three backends live behind this interface:

* ``VirtualClockExecutor`` (``virtual.py``) — deterministic event heap.
* ``ThreadExecutor`` (``thread.py``) — worker threads in this process.
* ``ProcessExecutor`` (``proc.py``) — one fresh interpreter per "node",
  devices spanning processes, heartbeat liveness (the paper's multi-node
  pilot runtime).
"""
from __future__ import annotations

import abc
import dataclasses
import queue as _queue
import time as _time
from typing import Any, Optional

from repro_torch.core.task import Task


@dataclasses.dataclass
class ExecEvent:
    """What an executor delivers back to the scheduler core."""
    kind: str        # done|fail|tick|device_failure|grow|retire|telemetry
    task: Optional[Task] = None
    result: Any = None
    error: Optional[str] = None
    comm_build_s: float = 0.0
    p2p_bytes: int = 0             # bytes the task's collectives moved
    # worker-to-worker (process executor's peer data plane; identically 0
    # on the in-process and virtual backends — uniform trace evidence)
    hub_calls: int = 0             # parent-hub round-trips the task paid
    spills: int = 0                # shuffle partitions the task spilled to
    # disk (out-of-core shuffle evidence; 0 on sim/thread backends)
    p2p_fallbacks: int = 0         # above-threshold payloads that fell back
    # to the hub relay (peer channel unusable)
    hub_relay_bytes: int = 0       # real payload bytes the hub relayed for
    # the task's collectives (control-only PEER_SENT frames excluded)
    raw_coll_bytes: int = 0        # collective bytes shipped with zero-copy
    # raw framing (generic raw frames + raw-layout shm segments)
    shm_bytes: int = 0             # payload bytes handed to same-host peers
    # through shared-memory segments (a subset of p2p_bytes)
    ring_steps: int = 0            # ring-allgather block forwards performed
    resumed_from_step: int = 0     # checkpoint step the attempt restored
    # before running (crash-safe resume evidence; 0 = ran from scratch,
    # max over a multi-part proc task's workers)
    spans: list = dataclasses.field(default_factory=list)   # worker-side
    # flight-recorder spans of a terminal event, already aligned into the
    # parent clock: [{kind, t0, t1, worker, part, uid, task}, ...]; empty
    # on sim/thread backends — same schema, empty section
    worker: str = ""               # telemetry: reporting worker id
    telemetry: Optional[dict] = None   # telemetry: the gauge/counter
    # snapshot a HEARTBEAT frame carried (queue depth, RSS, spill bytes,
    # peer channels, p2p_fallbacks), aligned timestamp under "t"
    n_devices: int = 0             # device_failure/grow/retire payload
    devices: tuple = ()            # device_failure/retire: the EXACT devices
    # lost or retired (empty -> the core shrinks the pool by n_devices
    # arbitrary free devices, the virtual-clock injection semantics;
    # non-empty -> those specific handles leave wherever they are, busy or
    # free — how a process executor reports a crashed or retired worker's
    # inventory).  grow: the EXACT devices joining the pool (empty -> the
    # core invents n_devices fresh handles, again the virtual-clock case)


class Executor(abc.ABC):
    """Runs one task at a time on behalf of the scheduler core.

    The core allocates ``task.devices`` from the policy pools, then calls
    ``launch``; the executor later delivers exactly one ``done``/``fail``
    ExecEvent per launch via ``poll`` (unless ``cancel`` returned True).
    The executor also owns the clock: virtual seconds or wall time.
    """

    #: True when ``now()`` is wall time.  Scheduler timeouts are liveness
    #: guards against hangs, so they are enforced only on wall-clock
    #: executors — a virtual clock drains its event heap deterministically
    #: and healthy simulations routinely span thousands of virtual seconds.
    wall_clock: bool = True

    @abc.abstractmethod
    def now(self) -> float:
        ...

    @abc.abstractmethod
    def launch(self, task: Task, duration_hint: Optional[float] = None):
        """Begin executing ``task`` on ``task.devices``.  ``duration_hint``
        is set for speculative duplicates (expected runtime on a healthy
        device); the virtual clock honours it, live executors ignore it."""

    @abc.abstractmethod
    def poll(self, timeout: Optional[float]) -> Optional[ExecEvent]:
        """Next event.  ``timeout == 0`` -> non-blocking (None if nothing is
        ready *right now*; must not advance a virtual clock).  Otherwise a
        live executor blocks up to ``timeout`` and returns a ``tick`` event
        on expiry; a virtual executor returns the next event (advancing its
        clock) or None when no event can ever arrive again."""

    def cancel(self, task: Task) -> bool:
        """Best-effort abort.  True -> the task is dead *now* and no event
        will be delivered for it (core reclaims devices immediately).
        False -> a completion event will still arrive later (live threads
        cannot be killed; the core ignores the event and reclaims then)."""
        return False

    def topology(self, devices):
        """Locality report for ``devices``: a ``placement.Topology`` grouping
        the handles by the node that hosts them.  Placement policies (pack /
        spread) consult it so a task's ranks can be kept on one node.

        Default: everything on one node — correct for in-process executors
        (``ThreadExecutor``), where every device shares an address space.
        ``ProcessExecutor`` reports one node per worker interpreter;
        ``VirtualClockExecutor`` synthesizes nodes per
        ``SimOptions.devices_per_node``."""
        from repro_torch.core.placement import Topology
        return Topology({"node0": tuple(devices)})


class QueueEventExecutor(Executor):
    """Shared wall-clock plumbing for live executors: completion events are
    pushed onto ``self._q`` from worker threads (or socket readers) and
    drained by ``poll`` with the tick-on-timeout contract the scheduler core
    expects.  Subclasses set ``self.tick`` and call ``super().__init__()``.
    """

    def __init__(self):
        self._q: "_queue.Queue[ExecEvent]" = _queue.Queue()

    def now(self) -> float:
        return _time.perf_counter()

    def poll(self, timeout: Optional[float]) -> Optional[ExecEvent]:
        if timeout == 0:
            try:
                return self._q.get_nowait()
            except _queue.Empty:
                return None
        try:
            return self._q.get(timeout=self.tick if timeout is None
                               else min(timeout, self.tick))
        except _queue.Empty:
            return ExecEvent("tick")

    # -- elastic pool injection --------------------------------------------
    # Any wall-clock executor can hand new device handles to (or withdraw
    # free ones from) the scheduler core at runtime: the core absorbs the
    # event on its next poll, mutates the pool, emits the matching
    # ``grow``/``retire`` trace event, and immediately re-dispatches pending
    # work.  ``ProcessExecutor.add_worker``/``retire_worker`` are the
    # full-stack variants (they spawn/drain a worker process around the same
    # injection); ``ThreadExecutor`` users call these directly.
    def inject_grow(self, devices):
        devices = tuple(devices)
        self._q.put(ExecEvent("grow", n_devices=len(devices),
                              devices=devices))

    def inject_retire(self, devices):
        devices = tuple(devices)
        self._q.put(ExecEvent("retire", n_devices=len(devices),
                              devices=devices))
