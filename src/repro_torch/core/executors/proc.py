"""ProcessExecutor: the multi-process pilot runtime (paper's multi-node mode).

One worker process per "node": a fresh interpreter that owns K logical
ranks on one torch device — by default the card, ``cuda:(i mod
device_count)`` for worker ``i``, so on one card every worker shares
``cuda:0``, each with its own CUDA context; ``device="cpu"`` puts them on
the CPU.  Without a visible card and without ``device`` the executor
refuses to start: it never falls back to the CPU.  The executor keeps a
worker registry whose combined device inventory — :class:`ProcDevice` handles
``worker:index`` — is what the scheduler's :class:`ResourceManager` carves
up, so ALL scheduling policy stays in ``SchedulerSession`` unchanged.

Task payloads are shipped as cloudpickle bytes over a length-prefixed socket
protocol (``protocol.py``).  A task whose ranks span several workers is split
into one *part* per worker; each part gets a :class:`ProcTaskComm` whose
local sub-mesh covers that worker's share and whose ``allgather``/``bcast``/
``barrier`` coordinate through the hub here — the paper's heterogeneous
communicator across nodes.  The task's result is part 0's (global rank 0)
return value.

Data plane vs control plane: each worker opens a peer-data listener and
advertises it in its HELLO; the parent ships the full address book (part ->
worker host:port) in every spanning LAUNCH, and collective payloads above
``p2p_threshold`` then move DIRECTLY between peer workers — the hub keeps
only the small per-collective control/barrier frame (and automatically
carries the payload again whenever a peer channel cannot be used, or when
``p2p=False`` / ``REPRO_P2P=0`` disables the plane).  ``hub_calls`` /
``hub_relay_bytes`` / ``p2p_bytes`` on the executor are the running
evidence.  Multi-HOST workers need nothing more than this address book —
the protocol is already plain TCP.

Liveness is real, not injected: workers heartbeat; an EOF/reset on a worker
channel or a stale heartbeat marks the worker lost, which surfaces as ONE
``device_failure`` ExecEvent naming the exact dead devices plus a ``fail``
event per task that had a part there — driving the scheduler's existing
retry-with-exclusion / pool-shrink logic with true process isolation.

The pilot is ELASTIC at runtime (the Radical-Pilot resize the paper leans
on): ``add_worker`` spawns a fresh interpreter mid-run, completes the same
HELLO handshake, pushes the refreshed peer address book to every live
worker (PEERS_UPDATE), and queues a ``grow`` ExecEvent so the scheduler
registers the new ``worker:index`` inventory and backfills pending work in
the same step; ``retire_worker`` is the graceful inverse — stop leasing,
drain in-flight parts (or fail them for retry-with-exclusion when
``immediate=True``), dismiss the process, and evict the retiree from the
survivors' peer-channel caches.  Worker ids are never reused.
"""
from __future__ import annotations

import itertools
import os
import secrets
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time as _time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Union

from repro_torch.core.executors import protocol, serialize
from repro_torch.core.executors import shm as _shmseg
from repro_torch.core.executors.base import ExecEvent, QueueEventExecutor
from repro_torch.core.executors.protocol import Channel, ConnectionClosed
from repro_torch.core.pilot import ResourceManager
from repro_torch.core.task import Task
from repro_torch.obs import spans as _spans


class ProcDevice(NamedTuple):
    """One device slot owned by one worker process (hashable RM handle)."""
    worker: str
    index: int

    def __repr__(self):
        return f"{self.worker}:{self.index}"


class _WorkerHandle:
    def __init__(self, wid: str, proc: subprocess.Popen, n_devices: int,
                 log_path: Path):
        self.wid = wid
        self.proc = proc
        self.n_devices = n_devices
        self.log_path = log_path
        self.spawned_at = _time.monotonic()
        self.hello_s: Optional[float] = None   # seconds from spawn to HELLO
        # (interpreter start, imports, CUDA context), the pilot's start-up
        # cost per node
        self.devices = tuple(ProcDevice(wid, i) for i in range(n_devices))
        self.chan: Optional[Channel] = None
        self.device: Optional[str] = None    # torch device of its ranks, from
        # its HELLO
        self.alive = False
        self.retiring = False    # graceful exit in progress: no new parts
        # may land here, but in-flight parts (and their hub collectives)
        # keep flowing until the drain completes
        self.last_hb = _time.monotonic()
        self.data_addr: Optional[tuple] = None   # (host, port) of the
        # worker's peer-data listener, from its HELLO; None when the peer
        # plane is disabled — the parent's address book entries
        self.clock_offset = 0.0   # parent perf_counter - worker perf_counter,
        # established at HELLO receipt (the worker stamps ``perf_t`` when it
        # sends); adding it shifts the worker's flight-recorder spans into
        # the parent clock — pure addition, order and nesting preserved

    def log_tail(self, n: int = 2000) -> str:
        try:
            return self.log_path.read_text(errors="replace")[-n:]
        except OSError:
            return "<no log>"


class _RawResult:
    """Still-serialized task result; materialized lazily in ``poll`` so the
    per-worker reader thread never stalls on a large deserialization."""
    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data


class _Tracker:
    """In-flight task bookkeeping: which parts ran where, what came back.

    ``attempt`` disambiguates retries: the scheduler reuses ``task.uid``
    across attempts, so every frame carries (uid, attempt) and stale frames
    from a failed attempt can never be credited to its retry.

    The terminal event is delivered only once EVERY part is accounted for
    (result, error, or hosted-on-a-dead-worker): the scheduler releases the
    task's devices on that event, and a surviving sibling part may still be
    computing on its devices — releasing early would double-issue them."""

    def __init__(self, task: Task, part_workers: list, attempt: int):
        self.task = task
        self.part_workers = part_workers          # part index -> worker id
        self.attempt = attempt
        self.n_parts = len(part_workers)
        self.results: list = [None] * self.n_parts
        self.remaining = set(range(self.n_parts))
        self.error: Optional[str] = None          # first part error wins
        self.comm_build_s = 0.0
        self.delivered = False
        self.p2p_bytes = 0                        # summed over parts: bytes
        self.hub_calls = 0                        # moved peer-to-peer / hub
        # round-trips paid — the comm-stats evidence on the terminal event
        self.spills = 0                           # partitions spilled to disk
        self.p2p_fallbacks = 0                    # hub-relay fallbacks paid
        self.hub_relay_bytes = 0                  # payload bytes the hub
        # relayed for this task (accumulated hub-side in _coll_contribution)
        self.raw_coll_bytes = 0                   # collective bytes shipped
        self.shm_bytes = 0                        # with zero-copy framing /
        self.ring_steps = 0                       # through shm segments /
        # ring forwards performed — the transport-tier evidence per task
        self.resumed_from_step = 0                # max over parts: checkpoint
        # step a part restored before running (crash-safe resume evidence)
        self.spans: list = []                     # worker flight-recorder
        # spans, aligned into the parent clock — piggybacked per PART_DONE


class ProcessExecutor(QueueEventExecutor):
    """Pilot-side runtime over ``n_workers`` fresh worker interpreters.

    Usage::

        with ProcessExecutor(n_workers=2, devices_per_worker=2) as ex:
            rm = ex.resource_manager()
            sess = SchedulerSession(ex, rm)
            ...

    ``devices_per_worker`` may be an int (homogeneous nodes) or a sequence
    (heterogeneous inventory).  ``device`` is the torch device of every
    worker's ranks; None (the default) means the card, worker ``i`` on
    ``cuda:(i mod device_count)``.  ``build_comm=False`` skips communicator
    construction in the workers (scheduling tests on logical devices).
    ``extra_pythonpath`` entries are appended to the workers' PYTHONPATH so
    payload functions defined in e.g. a test module stay importable.
    """

    def __init__(self, n_workers: int = 2,
                 devices_per_worker: Union[int, Sequence[int]] = 2,
                 build_comm: bool = True, tick: float = 0.05,
                 device: Optional[str] = None,
                 heartbeat_interval: Optional[float] = None,
                 heartbeat: Optional[float] = None,
                 heartbeat_timeout: Optional[float] = None,
                 start_timeout: float = 120.0,
                 python: str = sys.executable,
                 env: Optional[dict] = None,
                 extra_pythonpath: Sequence[str] = (),
                 p2p: Optional[bool] = None,
                 p2p_threshold: int = 1024,
                 raw_frames: Optional[bool] = None,
                 ring: Optional[bool] = None,
                 shm: Optional[bool] = None):
        super().__init__()
        if isinstance(devices_per_worker, int):
            devices_per_worker = [devices_per_worker] * n_workers
        assert len(devices_per_worker) == n_workers
        self.build_comm = build_comm
        self.tick = tick
        self.device = device
        # heartbeat cadence: explicit arg (``heartbeat`` and its historical
        # alias ``heartbeat_interval`` are equivalent) > REPRO_HEARTBEAT env
        # > 0.5s.  The liveness timeout defaults to 5 intervals (floor 2s):
        # a worker is declared hung only after missing that many consecutive
        # beats, so raising the interval proportionally slows failure
        # detection — set heartbeat_timeout explicitly to decouple them.
        hb = heartbeat if heartbeat is not None else heartbeat_interval
        if hb is None:
            hb = float(os.environ.get("REPRO_HEARTBEAT", "0.5"))
        self.hb_interval = hb
        self.hb_timeout = heartbeat_timeout or max(5 * hb, 2.0)
        self.start_timeout = start_timeout
        self.python = python
        self.env_override = dict(env or {})
        self.extra_pythonpath = list(extra_pythonpath)
        # peer data plane: None -> on unless REPRO_P2P=0 (the CI matrix
        # flips the env var to exercise the hub-relay fallback end to end)
        self.p2p = (os.environ.get("REPRO_P2P", "1") != "0") \
            if p2p is None else p2p
        self.p2p_threshold = p2p_threshold
        # raw-buffer peer framing (PEER_DATA_RAW) for the shuffle bucket
        # exchange: None -> on unless REPRO_RAW_FRAMES=0 (the A/B knob the
        # shuffle benchmark flips to measure pickled vs raw transport)
        self.raw_frames = (os.environ.get("REPRO_RAW_FRAMES", "1") != "0") \
            if raw_frames is None else raw_frames
        # ring allgather for wide (>= 4 part) tasks: None -> on unless
        # REPRO_RING=0 (tier A/B knob; direct all-to-all otherwise)
        self.ring = (os.environ.get("REPRO_RING", "1") != "0") \
            if ring is None else ring
        # same-host shared-memory payload handoff: None -> on unless
        # REPRO_SHM=0 (the CI matrix flips it so the tcp tiers stay
        # exercised end to end on single-host runners too)
        self.shm = (os.environ.get("REPRO_SHM", "1") != "0") \
            if shm is None else shm
        self.spills = 0         # shuffle partitions spilled to disk, summed
        # from the workers' PART_DONE accounting
        self.hub_calls = 0      # COLL round-trips served by this hub
        self.hub_relay_bytes = 0   # real payload bytes the hub relayed
        # (peer-mode collectives contribute only the tiny PEER_SENT marker)
        self.p2p_bytes = 0      # bytes moved worker-to-worker, summed from
        # the workers' PART_DONE accounting (the hub never sees these bytes)
        self.p2p_fallbacks = 0  # above-threshold payloads that fell back to
        # the hub relay, summed from the workers' PART_DONE accounting
        self.raw_coll_bytes = 0   # collective bytes shipped with zero-copy
        # raw framing (PEER_DATA_GEN frames + raw-layout shm segments)
        self.shm_bytes = 0      # payload bytes handed to same-host peers
        # through shared-memory segments (a subset of p2p_bytes)
        self.ring_steps = 0     # ring-allgather block forwards performed
        self._counts = list(devices_per_worker)
        self.workers: dict[str, _WorkerHandle] = {}
        self._running: dict[int, _Tracker] = {}
        self._attempts = itertools.count()
        self._coll: dict[tuple, dict] = {}  # (uid, attempt, seq) -> {part: b}
        self._lock = threading.Lock()
        self._started = False
        self._closed = False
        self._listener: Optional[socket.socket] = None
        self._logdir: Optional[Path] = None
        self._token: Optional[str] = None
        self._widx = len(self._counts)   # next elastic worker index: ids are
        # never reused, so a retired w1's stale state can't haunt a newcomer
        self._grow_lock = threading.Lock()   # serializes add_worker: the
        # registration accept loop matches HELLOs against ONE pending id

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def _worker_env(self) -> dict:
        env = dict(os.environ)
        import repro_torch
        src = str(Path(repro_torch.__file__).resolve().parents[1])
        paths = [src, *self.extra_pythonpath]
        if env.get("PYTHONPATH"):
            paths.append(env["PYTHONPATH"])
        env["PYTHONPATH"] = os.pathsep.join(paths)
        env.update(self.env_override)
        return env

    def _worker_device(self, index: int) -> str:
        """The torch device of worker ``index``'s ranks: ``self.device`` as
        given, or with none (or a bare ``"cuda"``) the card
        ``cuda:(index mod device_count)``."""
        if self.device not in (None, "cuda"):
            return str(self.device)
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "workers on the CPU")
        return f"cuda:{index % torch.cuda.device_count()}"

    def _spawn_worker(self, wid: str, k: int) -> _WorkerHandle:
        port = self._listener.getsockname()[1]
        log = self._logdir / f"{wid}.log"
        device = self._worker_device(int(wid[1:]))
        with open(log, "wb") as logf:   # Popen dups the fd; close ours
            proc = subprocess.Popen(
                [self.python, "-m", "repro_torch.core.executors.worker",
                 "--addr", f"127.0.0.1:{port}", "--worker", wid,
                 "--n-devices", str(k), "--device", device,
                 "--heartbeat", str(self.hb_interval),
                 "--token", self._token,
                 "--p2p", "1" if self.p2p else "0"],
                env=self._worker_env(), stdout=logf,
                stderr=subprocess.STDOUT)
        wh = _WorkerHandle(wid, proc, k, log)
        self.workers[wid] = wh
        return wh

    def _accept_hellos(self, pending: set, timeout: float):
        """Accept registrations on the pilot listener until every worker in
        ``pending`` completed its HELLO.  Raises RuntimeError (with the
        first culprit's log tail) on timeout or a worker dying first; the
        caller owns cleanup — start() kills the whole pilot, add_worker()
        reaps only the newcomer."""
        deadline = _time.monotonic() + timeout
        while pending:
            if _time.monotonic() > deadline:
                raise RuntimeError(
                    f"workers {sorted(pending)} did not register within "
                    f"{timeout}s; first log tail:\n"
                    f"{self.workers[sorted(pending)[0]].log_tail()}")
            for wid in list(pending):
                rc = self.workers[wid].proc.poll()
                if rc is not None:
                    raise RuntimeError(
                        f"worker {wid} exited rc={rc} during startup:\n"
                        f"{self.workers[wid].log_tail()}")
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError as e:
                raise RuntimeError(f"pilot listener closed: {e}") from e
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # accepted sockets are always blocking (they do not inherit the
            # listener's timeout); bound the handshake so a stray local
            # connection can neither hang startup nor crash it
            sock.settimeout(10.0)
            chan = Channel(sock)
            try:
                kind, d = chan.recv()
            except ConnectionClosed:
                chan.close()
                continue
            if kind != protocol.HELLO or d.get("token") != self._token or \
                    d.get("worker") not in pending:
                chan.close()
                continue
            sock.settimeout(None)
            wh = self.workers[d["worker"]]
            wh.chan, wh.alive = chan, True
            wh.device = d.get("device")
            wh.hello_s = _time.monotonic() - wh.spawned_at
            # clock alignment for the flight recorder: the worker stamped
            # its perf_counter as it sent HELLO; the difference (which
            # absorbs the one-way frame latency — microseconds on loopback)
            # maps every span the worker ships into this process's clock
            if d.get("perf_t") is not None:
                wh.clock_offset = _time.perf_counter() - d["perf_t"]
            if d.get("data_port"):
                wh.data_addr = (d.get("data_host") or "127.0.0.1",
                                d["data_port"])
            wh.last_hb = _time.monotonic()
            # byte progress counts as liveness: heartbeats queue behind any
            # large in-flight frame on the same stream
            def _touch(w=wh):
                w.last_hb = _time.monotonic()
            chan.on_traffic = _touch
            pending.discard(wh.wid)

    def start(self) -> "ProcessExecutor":
        if self._started:
            return self
        self._worker_device(0)      # no card and no device: refuse first
        self._logdir = Path(tempfile.mkdtemp(prefix="repro-procexec-"))
        self._token = secrets.token_hex(8)
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.bind(("127.0.0.1", 0))
        lst.listen(max(len(self._counts), 4))
        lst.settimeout(1.0)
        self._listener = lst
        for i, k in enumerate(self._counts):
            self._spawn_worker(f"w{i}", k)
        try:
            self._accept_hellos(set(self.workers), self.start_timeout)
        except RuntimeError:
            self._kill_all()
            raise
        for wh in self.workers.values():
            threading.Thread(target=self._reader, args=(wh,),
                             daemon=True).start()
        threading.Thread(target=self._monitor, daemon=True).start()
        self._started = True
        return self

    def __enter__(self) -> "ProcessExecutor":
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    def _kill_all(self):
        for wh in list(self.workers.values()):
            if wh.proc.poll() is None:
                wh.proc.kill()

    def shutdown(self, grace: float = 2.0):
        """Stop every worker (SHUTDOWN frame, then SIGKILL after ``grace``)."""
        self._closed = True
        for wh in list(self.workers.values()):
            if wh.alive and wh.chan is not None:
                try:
                    wh.chan.send(protocol.SHUTDOWN)
                except ConnectionClosed:
                    pass
            wh.alive = False
        deadline = _time.monotonic() + grace
        for wh in list(self.workers.values()):
            while wh.proc.poll() is None and _time.monotonic() < deadline:
                _time.sleep(0.02)
            if wh.proc.poll() is None:
                wh.proc.kill()
                wh.proc.wait()
            if wh.chan is not None:
                wh.chan.close()
        if self._listener is not None:
            self._listener.close()
        if self._logdir is not None:
            shutil.rmtree(self._logdir, ignore_errors=True)
            self._logdir = None
        self._sweep_segments()

    def _sweep_segments(self, wid: Optional[str] = None):
        """Remove ``/dev/shm`` residue of the shm transport tier.  Segments
        are named ``repro_{token8}_{creator_wid}_...``, so a dead or retired
        worker's leftovers (segments whose header never reached a receiver
        — the one cleanup the worker cannot do for itself after SIGKILL)
        are swept by its prefix; with no ``wid`` the whole pilot's prefix
        goes (shutdown safety net)."""
        if not self._token:
            return
        prefix = f"repro_{self._token[:8]}_"
        if wid is not None:
            prefix += f"{wid}_"
        _shmseg.sweep(prefix)

    def kill_worker(self, wid: str, sig: int = signal.SIGKILL):
        """Test/chaos hook: hard-kill one worker (true process isolation)."""
        self.workers[wid].proc.send_signal(sig)

    # ------------------------------------------------------------------ #
    # elasticity: grow and retire workers at runtime
    # ------------------------------------------------------------------ #
    def add_worker(self, devices_per_worker: Optional[int] = None,
                   timeout: Optional[float] = None) -> str:
        """Elastic grow: spawn ONE fresh worker interpreter mid-run and hand
        its inventory to the scheduler.

        The newcomer completes the normal HELLO handshake (including its
        peer-data port), the refreshed address book is pushed to every live
        worker (PEERS_UPDATE — subsequent spanning tasks can move payloads
        p2p to/from the new node), and a ``grow`` ExecEvent naming the exact
        new ``worker:index`` handles is queued for the scheduler core, which
        adds them to the live ResourceManager (``add_devices``), emits the
        ``grow`` trace event, and re-dispatches pending work in the same
        step.  ``Executor.topology`` needs no update call — it classifies by
        handle, so the placement layer sees the new node immediately.

        Returns the new worker id (e.g. ``"w2"``).  Ids are never reused.
        """
        self.start()
        if self._closed:
            raise RuntimeError("executor is shut down")
        k = devices_per_worker if devices_per_worker is not None else \
            (self._counts[0] if self._counts else 2)
        with self._grow_lock:
            wid = f"w{self._widx}"
            self._widx += 1
            wh = self._spawn_worker(wid, k)
            try:
                self._accept_hellos({wid}, timeout or self.start_timeout)
            except RuntimeError:
                self.workers.pop(wid, None)
                if wh.proc.poll() is None:
                    wh.proc.kill()
                    wh.proc.wait()
                raise
            self._counts.append(k)
            threading.Thread(target=self._reader, args=(wh,),
                             daemon=True).start()
        self._broadcast_peers()
        self._q.put(ExecEvent("grow", n_devices=k, devices=wh.devices))
        return wid

    def retire_worker(self, wid: str, immediate: bool = False,
                      drain_timeout: float = 120.0):
        """Elastic shrink, the graceful counterpart of a worker loss.

        Queues a ``retire`` ExecEvent FIRST (so the scheduler core stops
        leasing the worker's devices before it sees any later completion),
        then either *drains* — blocks until every in-flight part hosted on
        ``wid`` finished on its own, so no task loses results — or, with
        ``immediate=True``, fails the worker's in-flight parts now, driving
        the core's ordinary retry-with-exclusion onto the survivors (the
        retired inventory has already left the pool, so the retry cannot
        land back on it).  A drain that outlives ``drain_timeout`` escalates
        to the immediate path rather than wedging the caller.

        Either way the worker is then dismissed (SHUTDOWN, SIGKILL after a
        grace period), its channel closed, and the refreshed address book
        pushed to the survivors (PEERS_UPDATE) so their cached peer channels
        and mailboxes to the retiree are evicted — no per-payload fallback
        discovery, ``p2p_fallbacks`` stays 0 after a clean retire.  Unlike a
        crash, NO ``device_failure`` event is emitted."""
        wh = self.workers[wid]
        with self._lock:
            if not wh.alive or wh.retiring:
                return
            wh.retiring = True
        self._q.put(ExecEvent("retire", n_devices=wh.n_devices,
                              devices=wh.devices))
        if immediate:
            self._retire_parts(wid)
        else:
            deadline = _time.monotonic() + drain_timeout
            while wh.alive and self._busy_parts(wid):
                if _time.monotonic() > deadline:
                    self._retire_parts(wid)   # drain stuck: cut losses, the
                    break                     # retry lands on survivors
                _time.sleep(0.02)
        # dismiss the worker; its reader thread exits on the closed channel
        # and _worker_lost sees alive=False — a retire is not a failure
        wh.alive = False
        if wh.chan is not None:
            try:
                wh.chan.send(protocol.SHUTDOWN)
            except ConnectionClosed:
                pass
        deadline = _time.monotonic() + 2.0
        while wh.proc.poll() is None and _time.monotonic() < deadline:
            _time.sleep(0.02)
        if wh.proc.poll() is None:
            wh.proc.kill()
            wh.proc.wait()
        if wh.chan is not None:
            wh.chan.close()
        self._broadcast_peers(removed=(wid,))
        self._sweep_segments(wid)

    def _busy_parts(self, wid: str) -> bool:
        """True while any in-flight tracker still owes a part hosted on
        ``wid`` — the drain condition for a graceful retire."""
        with self._lock:
            return any(
                not t.delivered and any(
                    owner == wid and part in t.remaining
                    for part, owner in enumerate(t.part_workers))
                for t in self._running.values())

    def _retire_parts(self, wid: str):
        """Immediate retire: fail every in-flight part hosted on ``wid``.
        Sibling parts are aborted cooperatively (the usual partial-failure
        path) and the task's single fail event drives retry-with-exclusion
        on the surviving workers."""
        with self._lock:
            victims = [t for t in self._running.values()
                       if wid in t.part_workers and not t.delivered]
        for tracker in victims:
            for part, owner in enumerate(tracker.part_workers):
                if owner == wid:
                    self._part_terminal(tracker, part,
                                        error=f"worker {wid} retired")

    def _broadcast_peers(self, removed: Sequence[str] = ()):
        """Push the refreshed peer address book (PEERS_UPDATE) to every live
        worker after a membership change, naming departed ids so cached
        peer channels to a dead/retired worker are evicted promptly instead
        of being discovered per payload via the hub fallback."""
        # snapshot before iterating: a concurrent add_worker may resize the
        # dict mid-broadcast (this runs on monitor/reader threads too)
        handles = list(self.workers.values())
        book = {w.wid: w.data_addr for w in handles
                if w.alive and not w.retiring and w.data_addr is not None}
        for w in handles:
            if w.alive and w.chan is not None:
                try:
                    w.chan.send(protocol.PEERS_UPDATE, workers=book,
                                removed=list(removed))
                except ConnectionClosed:
                    pass

    # ------------------------------------------------------------------ #
    # inventory
    # ------------------------------------------------------------------ #
    def devices(self) -> tuple:
        """Current ProcDevice inventory, worker-major — feed to
        ResourceManager.  Retired and lost workers' handles are gone; a
        worker added at runtime contributes its handles the moment its
        HELLO completed."""
        self.start()
        # snapshot: add_worker inserts into the dict from another thread,
        # and dict iteration concurrent with a resize raises RuntimeError
        return tuple(d for wh in list(self.workers.values())
                     if wh.alive and not wh.retiring for d in wh.devices)

    def resource_manager(self) -> ResourceManager:
        return ResourceManager(self.devices())

    def topology(self, devices):
        """One node per worker interpreter: a ``ProcDevice`` lives on node
        ``worker``.  This is the report the pack policy uses to keep a
        fitting task's ranks inside ONE worker — a single local sub-mesh,
        zero parent-hub collectives."""
        from repro_torch.core.placement import Topology
        nodes: dict = {}
        for d in devices:
            nodes.setdefault(getattr(d, "worker", "node0"), []).append(d)
        return Topology(nodes)

    # ------------------------------------------------------------------ #
    # Executor interface (now comes from QueueEventExecutor)
    # ------------------------------------------------------------------ #
    def poll(self, timeout: Optional[float]) -> Optional[ExecEvent]:
        ev = super().poll(timeout)
        if ev is not None and isinstance(ev.result, _RawResult):
            try:
                ev.result = serialize.loads(ev.result.data)
            except Exception as e:  # noqa: BLE001 — undeserializable result
                ev.kind, ev.result = "fail", None
                ev.error = f"{type(e).__name__}: {e}"
        return ev

    def launch(self, task: Task, duration_hint: Optional[float] = None):
        self.start()
        parts: dict[str, dict] = {}
        for rank, dev in enumerate(task.devices):
            p = parts.setdefault(dev.worker,
                                 {"local_devices": [], "global_ranks": []})
            p["local_devices"].append(dev.index)
            p["global_ranks"].append(rank)
        part_workers = list(parts)
        tracker = _Tracker(task, part_workers, next(self._attempts))
        with self._lock:
            self._running[task.uid] = tracker
        if task.desc.mesh_shape and tracker.n_parts > 1:
            # a worker-local sub-mesh cannot honour a task-wide topology;
            # fail loudly instead of silently auto-factoring each part
            self._fail_all_parts(
                tracker, f"task {task.desc.name!r}: mesh_shape="
                f"{task.desc.mesh_shape} cannot be honoured when ranks span "
                f"{tracker.n_parts} workers; omit mesh_shape or pack the "
                f"task into one worker")
            return
        dead = [w for w in part_workers
                if not self.workers[w].alive or self.workers[w].retiring]
        if dead:
            # lost before launch, or racing a retire that the scheduler has
            # not absorbed yet: fail fast so the ordinary retry re-places
            # the task on the remaining pool
            self._fail_all_parts(
                tracker, f"worker {dead[0]} unavailable before launch")
            return
        try:
            payload = serialize.dumps(
                (task.desc.fn, task.desc.args, task.desc.kwargs))
        except Exception as e:  # noqa: BLE001 — unserializable payload
            self._fail_all_parts(tracker, f"{type(e).__name__}: {e}")
            return
        # the address book: every part's worker identity + peer-data address,
        # shipped with every spanning LAUNCH so large collective payloads can
        # move worker-to-worker (a None entry downgrades the whole task to
        # hub relay — the sentinel contract needs every part reachable)
        peer_addrs = None
        if self.p2p and tracker.n_parts > 1:
            peer_addrs = [
                (w, *self.workers[w].data_addr)
                if self.workers[w].data_addr else None
                for w in part_workers]
        for idx, wid in enumerate(part_workers):
            p = parts[wid]
            try:
                self.workers[wid].chan.send(
                    protocol.LAUNCH, uid=task.uid, attempt=tracker.attempt,
                    name=task.desc.name,
                    part=idx, n_parts=tracker.n_parts,
                    local_devices=p["local_devices"],
                    global_ranks=p["global_ranks"],
                    world_size=task.desc.ranks, payload=payload,
                    mesh_axes=task.desc.mesh_axes,
                    mesh_shape=task.desc.mesh_shape,
                    build_comm=self.build_comm,
                    placement=task.placement,
                    peer_addrs=peer_addrs,
                    p2p_threshold=self.p2p_threshold,
                    raw_frames=self.raw_frames,
                    ring=self.ring, shm=self.shm,
                    ckpt_dir=task.ckpt_dir,
                    ckpt_attempt=task.ckpt_attempt)
            except ConnectionClosed:
                # this part (and the never-launched rest) can't run; parts
                # already launched on other workers complete the tracker
                # with their own PART_DONEs
                for missing in range(idx, tracker.n_parts):
                    self._part_terminal(
                        tracker, missing,
                        error=f"worker {wid} lost at launch")
                self._worker_lost(wid, "connection lost at launch")
                return

    def cancel(self, task: Task) -> bool:
        with self._lock:
            tracker = self._running.get(task.uid)
        if tracker is None:
            return True          # nothing in flight: no event will come
        for wid in tracker.part_workers:
            wh = self.workers.get(wid)
            if wh is not None and wh.alive:
                try:
                    wh.chan.send(protocol.CANCEL, uid=task.uid,
                                 attempt=tracker.attempt)
                except ConnectionClosed:
                    pass
        return False             # cooperative: the completion event still
        # arrives (possibly as a fail) and the core reclaims devices then

    # ------------------------------------------------------------------ #
    # worker I/O
    # ------------------------------------------------------------------ #
    def _reader(self, wh: _WorkerHandle):
        while wh.alive:
            try:
                kind, d = wh.chan.recv()
            except ConnectionClosed as e:
                self._worker_lost(wh.wid, f"connection lost ({e})")
                return
            wh.last_hb = _time.monotonic()   # any traffic proves liveness
            if kind == protocol.PART_DONE:
                self._part_done(wh, d)
            elif kind == protocol.COLL:
                self._coll_contribution(wh, d)
            elif kind == protocol.HEARTBEAT and d.get("telemetry"):
                # telemetry-carrying heartbeat: surface the gauge snapshot
                # as an ExecEvent so the scheduler records a ``telemetry``
                # trace event; stamped in the parent clock via the offset
                rec = dict(d["telemetry"])
                if d.get("perf_t") is not None:
                    rec["t"] = d["perf_t"] + wh.clock_offset
                self._q.put(ExecEvent("telemetry", worker=wh.wid,
                                      telemetry=rec))

    def _monitor(self):
        while not self._closed:
            _time.sleep(self.hb_interval)
            for wh in list(self.workers.values()):
                if not wh.alive:
                    continue
                rc = wh.proc.poll()
                if rc is not None:
                    self._worker_lost(wh.wid, f"process exited rc={rc}")
                elif _time.monotonic() - wh.last_hb > self.hb_timeout:
                    wh.proc.kill()   # hung, not just slow: enforce isolation
                    self._worker_lost(
                        wh.wid, f"heartbeat timeout (> {self.hb_timeout}s)")

    # ------------------------------------------------------------------ #
    # completion / failure plumbing
    # ------------------------------------------------------------------ #
    def _abort_parts(self, tracker: _Tracker, error: str):
        """Prompt-unblock the surviving parts of a failing task: cooperative
        CANCEL plus a hub release so a part blocked in a collective raises
        now instead of waiting out the collective timeout.  The parts keep
        their devices until they actually finish (their PART_DONE completes
        the tracker) — releasing earlier would double-issue busy devices."""
        for wid in dict.fromkeys(tracker.part_workers):
            wh = self.workers.get(wid)
            if wh is not None and wh.alive:
                try:
                    wh.chan.send(protocol.CANCEL, uid=tracker.task.uid,
                                 attempt=tracker.attempt)
                    wh.chan.send(protocol.COLL_ERROR, uid=tracker.task.uid,
                                 attempt=tracker.attempt, seq=None,
                                 error=error)
                except ConnectionClosed:
                    pass

    def _part_terminal(self, tracker: _Tracker, part: int,
                       error: Optional[str] = None, result=None,
                       comm_s: float = 0.0, p2p_bytes: int = 0,
                       hub_calls: int = 0, spills: int = 0,
                       p2p_fallbacks: int = 0, raw_coll_bytes: int = 0,
                       shm_bytes: int = 0, ring_steps: int = 0,
                       resumed_from_step: int = 0, spans=()):
        """Record one part's fate; the task's single terminal ExecEvent is
        delivered only when EVERY part is accounted for (result, error, or
        hosted on a dead worker)."""
        with self._lock:
            if tracker.delivered or part not in tracker.remaining:
                return
            tracker.remaining.discard(part)
            tracker.results[part] = result
            tracker.comm_build_s = max(tracker.comm_build_s, comm_s)
            tracker.p2p_bytes += p2p_bytes
            tracker.hub_calls += hub_calls
            tracker.spills += spills
            tracker.p2p_fallbacks += p2p_fallbacks
            tracker.raw_coll_bytes += raw_coll_bytes
            tracker.shm_bytes += shm_bytes
            tracker.ring_steps += ring_steps
            tracker.resumed_from_step = max(tracker.resumed_from_step,
                                            resumed_from_step)
            tracker.spans.extend(spans)
            self.p2p_bytes += p2p_bytes
            self.spills += spills
            self.p2p_fallbacks += p2p_fallbacks
            self.raw_coll_bytes += raw_coll_bytes
            self.shm_bytes += shm_bytes
            self.ring_steps += ring_steps
            first_error = error is not None and tracker.error is None
            if first_error:
                tracker.error = error
            complete = not tracker.remaining
            if complete:
                tracker.delivered = True
                self._running.pop(tracker.task.uid, None)
                for k in [k for k in self._coll if k[0] == tracker.task.uid]:
                    del self._coll[k]
        if first_error and not complete:
            self._abort_parts(tracker, error)
        if not complete:
            return
        if tracker.error is not None:
            self._q.put(ExecEvent("fail", task=tracker.task,
                                  error=tracker.error,
                                  comm_build_s=tracker.comm_build_s,
                                  p2p_bytes=tracker.p2p_bytes,
                                  hub_calls=tracker.hub_calls,
                                  spills=tracker.spills,
                                  p2p_fallbacks=tracker.p2p_fallbacks,
                                  hub_relay_bytes=tracker.hub_relay_bytes,
                                  raw_coll_bytes=tracker.raw_coll_bytes,
                                  shm_bytes=tracker.shm_bytes,
                                  ring_steps=tracker.ring_steps,
                                  resumed_from_step=tracker.resumed_from_step,
                                  spans=list(tracker.spans)))
        else:
            # results stay as bytes until poll(): deserializing a large
            # result here would stall this reader thread past hb_timeout
            # and get a healthy worker killed as hung
            self._q.put(ExecEvent("done", task=tracker.task,
                                  result=_RawResult(tracker.results[0]),
                                  comm_build_s=tracker.comm_build_s,
                                  p2p_bytes=tracker.p2p_bytes,
                                  hub_calls=tracker.hub_calls,
                                  spills=tracker.spills,
                                  p2p_fallbacks=tracker.p2p_fallbacks,
                                  hub_relay_bytes=tracker.hub_relay_bytes,
                                  raw_coll_bytes=tracker.raw_coll_bytes,
                                  shm_bytes=tracker.shm_bytes,
                                  ring_steps=tracker.ring_steps,
                                  resumed_from_step=tracker.resumed_from_step,
                                  spans=list(tracker.spans)))

    def _fail_all_parts(self, tracker: _Tracker, error: str):
        """Abort a launch that never (fully) reached the workers."""
        for part in range(tracker.n_parts):
            self._part_terminal(tracker, part, error=error)

    def _part_done(self, wh: _WorkerHandle, d: dict):
        with self._lock:
            tracker = self._running.get(d["uid"])
        if tracker is None or tracker.attempt != d["attempt"]:
            return       # stale: task already failed/cancelled, or this part
            # belongs to a previous attempt of a retried task (same uid)
        self._part_terminal(tracker, d["part"], error=d["error"],
                            result=d["result"], comm_s=d["comm_build_s"],
                            p2p_bytes=d.get("p2p_bytes", 0),
                            hub_calls=d.get("hub_calls", 0),
                            spills=d.get("spills", 0),
                            p2p_fallbacks=d.get("p2p_fallbacks", 0),
                            raw_coll_bytes=d.get("raw_coll_bytes", 0),
                            shm_bytes=d.get("shm_bytes", 0),
                            ring_steps=d.get("ring_steps", 0),
                            resumed_from_step=d.get("resumed_from_step", 0),
                            spans=_spans.align(
                                d.get("spans") or (), wh.clock_offset,
                                worker=wh.wid, part=d["part"], uid=d["uid"],
                                task=tracker.task.desc.name))

    def _coll_contribution(self, sender: _WorkerHandle, d: dict):
        uid, attempt, seq = d["uid"], d["attempt"], d["seq"]
        with self._lock:
            # counter updates stay under the lock: += from concurrent
            # per-worker reader threads would drop updates
            self.hub_calls += 1
            relayed = 0 if d["payload"] == protocol.PEER_SENT \
                else len(d["payload"])
            self.hub_relay_bytes += relayed
            tracker = self._running.get(uid)
            if tracker is None or tracker.delivered or \
                    tracker.attempt != attempt:
                tracker = None
            else:
                # only the hub sees relayed bytes, so the per-task evidence
                # is accumulated here rather than on the workers' PART_DONE
                tracker.hub_relay_bytes += relayed
                entry = self._coll.setdefault((uid, attempt, seq), {})
                entry[d["part"]] = d["payload"]
                ready = len(entry) == tracker.n_parts
                if ready:
                    values = [entry[i] for i in range(tracker.n_parts)]
                    del self._coll[(uid, attempt, seq)]
        if tracker is None:      # aborted task or stale attempt: release the
            try:                 # sender's waiting thread
                sender.chan.send(protocol.COLL_ERROR, uid=uid,
                                 attempt=attempt, seq=seq,
                                 error="task aborted")
            except ConnectionClosed:
                pass
            return
        if ready:
            for wid in tracker.part_workers:
                wh = self.workers.get(wid)
                if wh is not None and wh.alive:
                    try:
                        wh.chan.send(protocol.COLL_RESULT, uid=uid,
                                     attempt=attempt, seq=seq, values=values)
                    except ConnectionClosed:
                        pass

    def _worker_lost(self, wid: str, reason: str):
        with self._lock:
            wh = self.workers[wid]
            if not wh.alive:
                return
            wh.alive = False
            victims = [t for t in self._running.values()
                       if wid in t.part_workers and not t.delivered]
        if wh.chan is not None:
            wh.chan.close()
        if wh.proc.poll() is None:
            wh.proc.kill()       # half-dead worker: finish the job
        # one pool-shrink event naming the exact dead inventory, then the
        # dead worker's parts are marked terminal — each victim task's fail
        # event goes out once its surviving parts also finish (they hold
        # their devices until then), driving device exclusion + retry on
        # the surviving workers
        self._q.put(ExecEvent("device_failure", n_devices=wh.n_devices,
                              devices=wh.devices))
        for tracker in victims:
            for part, owner in enumerate(tracker.part_workers):
                if owner == wid:
                    self._part_terminal(tracker, part,
                                        error=f"worker {wid} lost: {reason}")
        # survivors evict their cached peer channels to the dead worker now,
        # not on their next (doomed) send to it
        self._broadcast_peers(removed=(wid,))
        # reclaim /dev/shm segments the dead worker created but nobody will
        # consume (its receivers abort; the header may never have shipped)
        self._sweep_segments(wid)
