"""Worker-process entry point for :class:`ProcessExecutor`.

One worker == one "node" of the paper's pilot: a fresh interpreter that owns
K logical ranks on one torch device (``--n-devices K --device DEV``; the
card unless the parent passed ``cpu``; several workers may share one
card, each with its own CUDA context).  The worker

* starts its CUDA context first, when its device is a card, so that the
  context's start-up never delays a heartbeat,
* dials back to the parent, registers its device inventory (HELLO),
* sends HEARTBEAT frames so the scheduler gets real liveness detection,
* opens a peer-data listener (:class:`_PeerNet`) whose address is advertised
  in the HELLO frame — large collective payloads move worker-to-worker over
  persistent peer channels instead of relaying through the parent hub,
* runs each LAUNCH frame's task *part* in its own thread: builds the local
  communicator over its share of the ranks, wraps it in a
  :class:`ProcTaskComm` (which adds cross-process collectives via the peer
  data plane + parent's hub), calls the payload, and ships the serialized
  result back (PART_DONE).

Run as ``python -m repro_torch.core.executors.worker --addr HOST:PORT ...``.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time
from typing import Optional

from repro_torch.core.communicator import (
    build_communicator, logical_devices, resolve_device,
)
from repro_torch.core.executors import protocol, serialize
from repro_torch.core.executors import shm as _shmseg
from repro_torch.core.executors.protocol import Channel, ConnectionClosed
from repro_torch.core.executors.thread import StubComm
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import spans as _spans
from repro_torch.train.checkpoint import CheckpointContext


class CollectiveError(RuntimeError):
    """A collective could not complete (a participant's worker died)."""


class _Hub:
    """Client side of the parent-coordinated collectives: one outstanding
    request per (uid, attempt, seq), answered by COLL_RESULT or COLL_ERROR.
    ``attempt`` keeps a retried task (same uid) from ever being confused
    with frames or abort markers of its failed predecessor."""

    def __init__(self, chan: Channel):
        self.chan = chan
        self._lock = threading.Lock()
        self._waiting: dict = {}   # (uid, attempt, seq) -> [event, values]
        self._dead: dict = {}      # (uid, attempt) -> error (task aborted)

    def call(self, uid: int, attempt: int, seq: int, part: int,
             payload: bytes, timeout: float) -> list:
        with self._lock:
            if (uid, attempt) in self._dead:
                raise CollectiveError(self._dead[(uid, attempt)])
            slot = [threading.Event(), None]
            self._waiting[(uid, attempt, seq)] = slot
        self.chan.send(protocol.COLL, uid=uid, attempt=attempt, seq=seq,
                       part=part, payload=payload)
        if not slot[0].wait(timeout):
            with self._lock:
                self._waiting.pop((uid, attempt, seq), None)
            raise CollectiveError(
                f"collective uid={uid} seq={seq} timed out after {timeout}s")
        if isinstance(slot[1], Exception):
            raise slot[1]
        return slot[1]

    def deliver(self, uid: int, attempt: int, seq: int, values: list):
        with self._lock:
            slot = self._waiting.pop((uid, attempt, seq), None)
        if slot:
            slot[1] = values
            slot[0].set()

    def fail(self, uid: int, attempt: int, seq: Optional[int], error: str):
        with self._lock:
            self._dead[(uid, attempt)] = error
            keys = [k for k in self._waiting
                    if k[:2] == (uid, attempt) and (seq is None or k[2] == seq)]
            for k in keys:
                slot = self._waiting.pop(k)
                slot[1] = CollectiveError(error)
                slot[0].set()

    def forget(self, uid: int, attempt: int):
        """Drop the abort marker once the attempt's part thread has exited —
        a dead attempt never comes back, and without this the marker dict
        grows by one entry per cancelled attempt for the worker's life."""
        with self._lock:
            self._dead.pop((uid, attempt), None)

    def dead_error(self, uid: int, attempt: int) -> Optional[str]:
        """The abort reason for (uid, attempt), or None while it is live —
        polled by peer-data waits so a COLL_ERROR unblocks them too."""
        with self._lock:
            return self._dead.get((uid, attempt))


class _PeerNet:
    """Worker-to-worker data plane: one listening data port per worker plus
    a cache of persistent outgoing channels, moving collective payloads
    directly between peers (the length-prefixed ``protocol.py`` framing, the
    parent hub never sees the bytes).

    * inbound: every accepted connection authenticates with PEER_HELLO
      (shared pilot token), then streams PEER_DATA frames into the mailbox,
      keyed ``(uid, attempt, seq, src_part)`` — stale frames of a failed
      attempt can never be matched by its retry (different attempt id).
    * outbound: ``send`` reuses one cached channel per destination worker;
      a send failure drops the cached channel and retries once on a fresh
      connection, then reports failure so the caller can fall back to the
      hub relay — a dead peer never wedges a collective.
    """

    #: purged-attempt tombstones kept (FIFO); bounds the memory a late frame
    #: race can cost while covering far more history than can be in flight
    MAX_TOMBSTONES = 4096

    def __init__(self, worker_id: str, token: str):
        self.worker_id = worker_id
        self.token = token
        self.data_addr: Optional[tuple] = None    # (host, port) advertised
        self._cv = threading.Condition()
        self._mail: dict = {}                     # key -> payload bytes
        self._done: dict = {}                     # (uid, attempt) tombstones
        # of purged attempts (insertion-ordered): peer and hub channels have
        # no mutual ordering, so a frame may arrive AFTER its attempt ended
        # — without the tombstone it would park in the mailbox forever
        self._out: dict = {}                      # dest worker id -> Channel
        self._out_lock = threading.Lock()
        self._server: Optional[socket.socket] = None
        # shared-memory ledger: segments THIS worker created per attempt,
        # reclaimed by purge(failed=True) when the attempt aborts before
        # receivers could consume them (the receiver unlinks on consume)
        self._shm_sent: dict = {}                 # (uid, attempt) -> [name]
        self._shm_lock = threading.Lock()

    # --- inbound ----------------------------------------------------------
    def start(self, advertise_host: str):
        """Open the data port (any interface — multi-host workers need only
        a routable address book) and advertise ``advertise_host``: the local
        address of the parent channel, i.e. the interface peers on other
        hosts can reach the same way the parent does."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("", 0))
        srv.listen(64)
        self._server = srv
        self.data_addr = (advertise_host, srv.getsockname()[1])
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while True:
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(10.0)     # bound the PEER_HELLO handshake
            threading.Thread(target=self._serve, args=(Channel(sock),),
                             daemon=True).start()

    def _serve(self, chan: Channel):
        try:
            kind, d = chan.recv()
            if kind != protocol.PEER_HELLO or d.get("token") != self.token:
                chan.close()
                return
            chan.sock.settimeout(None)
            while True:
                kind, d = chan.recv()
                if kind == protocol.PEER_DATA:
                    self.put((d["uid"], d["attempt"], d["seq"], d["part"]),
                             d["payload"])
                elif kind in (protocol.PEER_DATA_RAW, protocol.PEER_DATA_GEN,
                              protocol.PEER_DATA_SHM):
                    # raw / generic / shm frame: park the whole header dict
                    # — it carries the layout metadata next to the raw body
                    # the Channel already read off the stream (or the name
                    # of the shared-memory segment holding it)
                    if kind == protocol.PEER_DATA_SHM:
                        # eager consume: copy the segment body out HERE so
                        # the tmpfs read overlaps the collective's hub
                        # barrier (matching the pipelining a streamed TCP
                        # body gets for free) and the segment's lifetime
                        # ends the moment the header lands.  A vanished
                        # segment (sender aborted and purged) keeps its
                        # "shm" key: the claimer surfaces the error.
                        try:
                            d["payload"] = _shmseg.read(d["shm"])
                            _shmseg.unlink(d.pop("shm"))
                        except OSError:
                            pass
                    self.put((d["uid"], d["attempt"], d["seq"], d["part"]), d)
        except (ConnectionClosed, OSError):
            chan.close()

    # --- mailbox ----------------------------------------------------------
    def put(self, key: tuple, payload):
        dropped = None
        with self._cv:
            if key[:2] in self._done:
                dropped = payload     # attempt already ended: unclaimable
            else:
                dropped = self._mail.get(key)    # displaced duplicate (a
                # ring rescue and a recovered link can both deliver a block)
                self._mail[key] = payload
                self._cv.notify_all()
        _discard_frame(dropped)

    def take(self, key: tuple, timeout: float, abort=None) -> bytes:
        """Blocking receive of one peer payload.  ``abort()`` (if given)
        returns an error string once the task is being torn down — a worker
        dying mid-transfer surfaces as the parent's COLL_ERROR/CANCEL, which
        must unblock this wait promptly instead of running out the clock."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if key in self._mail:
                    return self._mail.pop(key)
                if abort is not None:
                    err = abort()
                    if err:
                        raise CollectiveError(err)
                left = deadline - time.monotonic()
                if left <= 0:
                    raise CollectiveError(
                        f"peer payload {key} not received within {timeout}s")
                self._cv.wait(min(left, 0.05))

    def purge(self, uid: int, attempt: int, failed: bool = False):
        """Drop parked payloads of a finished/aborted attempt — they can
        never be claimed (keys carry the attempt id) and would otherwise
        accumulate for the worker's life.  The attempt is tombstoned so a
        frame still in flight on a peer channel is dropped on arrival.

        Parked shared-memory frames are unlinked here (nobody will consume
        them), and ``failed=True`` additionally reclaims every segment THIS
        worker created for the attempt: an aborted attempt's receivers
        raise out of their takes without consuming.  A clean finish leaves
        sent segments to the receivers, who unlink on consume."""
        with self._cv:
            dropped = []
            for k in [k for k in self._mail
                      if k[0] == uid and k[1] == attempt]:
                dropped.append(self._mail.pop(k))
            self._done[(uid, attempt)] = None
            while len(self._done) > self.MAX_TOMBSTONES:
                del self._done[next(iter(self._done))]
        for f in dropped:
            _discard_frame(f)
        with self._shm_lock:
            names = self._shm_sent.pop((uid, attempt), ())
        if failed:
            for name in names:
                _shmseg.unlink(name)

    def record_segment(self, uid: int, attempt: int, name: str):
        """Ledger a shared-memory segment created for (uid, attempt) so an
        aborted attempt's purge can reclaim it (see :meth:`purge`)."""
        with self._shm_lock:
            self._shm_sent.setdefault((uid, attempt), []).append(name)

    # --- outbound ---------------------------------------------------------
    def _channel(self, wid: str, addr: tuple,
                 fresh: bool = False) -> Optional[Channel]:
        if not fresh:
            with self._out_lock:
                chan = self._out.get(wid)
            if chan is not None:
                return chan
        try:
            sock = socket.create_connection(addr, timeout=5.0)
        except OSError:
            return None
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        chan = Channel(sock)
        try:
            chan.send(protocol.PEER_HELLO, worker=self.worker_id,
                      token=self.token)
        except ConnectionClosed:
            chan.close()
            return None
        with self._out_lock:
            old = self._out.get(wid)
            self._out[wid] = chan
        if old is not None and old is not chan:
            old.close()
        return chan

    def evict(self, wid: str):
        """Close and drop the cached outgoing channel to ``wid`` — called
        when the parent announces the peer retired or died (PEERS_UPDATE).
        Without this the half-dead channel lingers for the worker's life;
        worse, if a task's address book ever re-used the id, the first send
        would burn its one retry on the stale socket."""
        with self._out_lock:
            chan = self._out.pop(wid, None)
        if chan is not None:
            chan.close()

    def send_kind(self, wid: str, addr: tuple, kind: str, bufs=None,
                  **fields) -> bool:
        """Ship one peer frame of ``kind`` to worker ``wid``; True on
        success.  ``bufs`` (for RAW_BODY_KINDS) are written to the stream
        as the raw body after the header.  A stale cached channel (peer
        restarted its end, half-closed socket) is dropped and retried ONCE
        on a fresh connection — never reused for the caller's retry
        attempt."""
        for fresh in (False, True):
            chan = self._channel(wid, addr, fresh=fresh)
            if chan is None:
                continue
            try:
                if bufs is not None:
                    chan.send_raw(kind, bufs, **fields)
                else:
                    chan.send(kind, **fields)
                return True
            except ConnectionClosed:
                with self._out_lock:
                    if self._out.get(wid) is chan:
                        del self._out[wid]
                chan.close()
        return False

    def send(self, wid: str, addr: tuple, **fields) -> bool:
        """Ship one pickled-body PEER_DATA frame (see :meth:`send_kind`)."""
        return self.send_kind(wid, addr, protocol.PEER_DATA, **fields)

    def send_raw(self, wid: str, addr: tuple, bufs, **fields) -> bool:
        """Ship one PEER_DATA_RAW frame — header + raw buffer bytes, no
        pickle of the body (see :meth:`send_kind`)."""
        return self.send_kind(wid, addr, protocol.PEER_DATA_RAW, bufs=bufs,
                              **fields)


def _discard_frame(frame):
    """Reclaim resources owned by a peer frame that will never be consumed
    (tombstoned attempt, displaced duplicate): a shared-memory frame's
    segment must be unlinked NOW — the consume path will never see it."""
    if isinstance(frame, dict) and frame.get("shm"):
        _shmseg.unlink(frame["shm"])


def _encode_cols(chunk: dict):
    """Wire form of a column-dict for a raw peer frame: ``(metas, bufs)``
    where ``metas`` is ``[(name, dtype_str, shape), ...]`` (pickled in the
    frame header) and ``bufs`` the matching C-contiguous arrays whose bytes
    follow the header verbatim.  Column order is sorted-by-name so both
    sides agree without shipping an ordering."""
    import numpy as np
    metas, bufs = [], []
    for name in sorted(chunk):
        a = np.ascontiguousarray(chunk[name])
        metas.append((name, a.dtype.str, a.shape))
        bufs.append(a)
    return metas, bufs


def _decode_cols(metas, payload: bytes) -> dict:
    """Inverse of :func:`_encode_cols`: zero-copy ``np.frombuffer`` views
    into ``payload``.  The views are read-only (they alias the received
    bytes) — callers that mutate must copy first."""
    import numpy as np
    out, off = {}, 0
    for name, dtype, shape in metas:
        dt = np.dtype(dtype)
        count = 1
        for s in shape:
            count *= int(s)
        out[name] = np.frombuffer(payload, dt, count=count,
                                  offset=off).reshape(shape)
        off += dt.itemsize * count
    return out


class _WirePayload:
    """One collective payload in wire-ready form: either pickled (``data``
    set) or raw-split (``skel``/``metas``/``bufs`` set — the
    ``serialize.dumps_arrays`` shape, where ``bufs`` holds the array leaves
    on the sending side or the single received body-bytes object on a ring
    forward)."""

    __slots__ = ("data", "skel", "metas", "bufs")

    def __init__(self, data=None, skel=None, metas=None, bufs=None):
        self.data = data
        self.skel = skel
        self.metas = metas
        self.bufs = bufs

    @property
    def nbytes(self) -> int:
        """Raw body size: what a peer frame's stream body (or shm segment)
        carries."""
        if self.data is not None:
            return len(self.data)
        return sum(memoryview(b).nbytes for b in self.bufs)

    @property
    def size(self) -> int:
        """Total wire size, for threshold decisions (raw adds the pickled
        skeleton that rides in the frame header)."""
        if self.data is not None:
            return len(self.data)
        return len(self.skel) + self.nbytes


class ProcTaskComm:
    """The communicator a payload receives under :class:`ProcessExecutor`.

    Mirrors the thread-mode ``Communicator`` surface (``devices``,
    ``torch_devices``, ``device_of``, ``build_seconds``) for the ranks local
    to THIS worker, and adds the
    cross-process view: ``size`` is the task's total rank count (the paper's
    heterogeneous communicator spanning nodes), ``local_size`` the ranks this
    process owns, and ``allgather``/``bcast``/``barrier`` coordinate all
    parts through the pilot's hub.  Payloads written for ``ThreadExecutor``
    keep working unchanged as long as the task fits one worker (then
    ``size == local_size`` and ``local_comm`` covers every rank).

    Data plane: when the LAUNCH frame carried a complete peer address book
    (``peer_addrs``), a collective payload larger than ``p2p_threshold``
    moves DIRECTLY to every peer worker over persistent peer channels; the
    hub round-trip still happens per collective, but carries only the tiny
    ``PEER_SENT`` placeholder — it is the ordering/barrier control frame,
    not a data relay.  Payloads at or under the threshold (barrier tokens,
    small scalars) stay inline on the hub frame.  If any peer send fails,
    THIS part's payload falls back to the hub frame for that collective
    (``p2p_fallbacks``) and every receiver still completes — receivers
    decide per hub value whether to read it inline or await the peer copy,
    so mixed outcomes cannot deadlock.

    Transport tiers (chosen per payload, per destination, best first):

    1. **same-host shared memory** — the address book says the peer is on
       this host: the body goes into a tmpfs segment file
       (``executors.shm``), only name + layout header on the socket
       (``shm_bytes``).
    2. **raw peer frame** — array leaves ship as raw bytes after a pickled
       skeleton header, no pickle pass over the body (``raw_coll_bytes``;
       PEER_DATA_GEN, the generic sibling of the shuffle's PEER_DATA_RAW).
    3. **pickled peer frame** — cloudpickle body on the peer channel
       (payloads with no array leaves, or ``raw_frames=False``).
    4. **hub relay** — the per-payload fallback when no peer tier works.

    Wide tasks (``n_parts >= RING_MIN_PARTS``) additionally replace the
    every-part-sends-to-every-peer allgather with a P-1 step ring
    (``ring_steps``), cutting per-link traffic from O(P·B) to O(B); parts
    2-3 keep the direct path (fewer hops, same bytes).  Remote entries of
    a raw-framed gather are read-only ``np.frombuffer`` views — copy
    before mutating in place (the shuffle-frame contract)."""

    #: ring allgather needs at least this many parts to beat direct sends
    RING_MIN_PARTS = 4

    def __init__(self, uid: int, world_size: int, global_ranks: tuple,
                 part: int, n_parts: int, local_comm, hub: _Hub,
                 attempt: int = 0, coll_timeout: float = 120.0,
                 cancelled: Optional[threading.Event] = None,
                 placement: str = "", peer_net: Optional[_PeerNet] = None,
                 peer_addrs: Optional[list] = None,
                 p2p_threshold: int = 1024, raw_frames: bool = True,
                 ring: bool = True, shm: bool = True,
                 registry=None):
        self.uid = uid
        self.attempt = attempt
        self.world_size = world_size
        self.global_ranks = tuple(global_ranks)
        self.part = part
        self.n_parts = n_parts
        self.local_comm = local_comm
        self.cancelled = cancelled or threading.Event()
        self.placement = placement   # policy that placed this task (pack|
        # spread); under pack a fitting task has n_parts == 1 and its
        # collectives below never touch the hub
        # comm counters live in a part-local MetricsRegistry (chained to the
        # worker-lifetime registry whose snapshot rides every heartbeat)
        # rather than ad-hoc attributes; the attribute surface below —
        # ``comm.spills += n`` — is preserved by properties whose setter
        # feeds the delta through the registry, so payloads and the parent's
        # telemetry always agree without double bookkeeping
        self.metrics = registry if registry is not None \
            else _metrics.MetricsRegistry()
        self.checkpoint = None        # CheckpointContext bound by the worker
        # when the LAUNCH carried a checkpoint namespace (REPRO_CKPT_DIR)
        self.raw_frames = raw_frames  # raw-body peer frames enabled (knob
        # for A/B benchmarking against the pickled PEER_DATA path)
        self.ring = ring              # ring allgather for wide tasks
        self.shm = shm and _shmseg.HAVE_SHM   # same-host segment handoff
        self._hub = hub
        self._seq = 0
        self._coll_timeout = coll_timeout
        self._peer_net = peer_net
        self._peer_addrs = list(peer_addrs or [])
        self.p2p_threshold = p2p_threshold
        # the data plane is usable only when EVERY part advertised a data
        # port: a sender must know all destinations, and a sentinel in the
        # hub values obliges every receiver to await a peer frame
        self._peers_ok = (peer_net is not None
                          and len(self._peer_addrs) == n_parts
                          and all(a is not None for a in self._peer_addrs))
        # this part's advertised host: the same-host test for the shm tier
        # compares address-book entries, never re-resolves interfaces
        self._host = self._peer_addrs[part][1] if self._peers_ok else None

    # --- registry-backed comm counters (attribute surface preserved) -----
    @property
    def hub_calls(self) -> int:
        """Parent-hub round-trips actually paid."""
        return self.metrics.get("hub_calls")

    @hub_calls.setter
    def hub_calls(self, v: int):
        self.metrics.set_counter("hub_calls", v)

    @property
    def p2p_bytes(self) -> int:
        """Payload bytes this part SENT over peer channels (each transferred
        byte is counted exactly once, by its sender; sim/thread comms expose
        the same field as a constant 0)."""
        return self.metrics.get("p2p_bytes")

    @p2p_bytes.setter
    def p2p_bytes(self, v: int):
        self.metrics.set_counter("p2p_bytes", v)

    @property
    def p2p_fallbacks(self) -> int:
        """Above-threshold payloads that had to relay through the hub
        because a peer channel could not be used."""
        return self.metrics.get("p2p_fallbacks")

    @p2p_fallbacks.setter
    def p2p_fallbacks(self, v: int):
        self.metrics.set_counter("p2p_fallbacks", v)

    @property
    def spills(self) -> int:
        """Shuffle partitions a payload spilled to disk on this part
        (incremented by the payload via SpillBuffer; sim/thread comms expose
        the same field as a constant 0)."""
        return self.metrics.get("spills")

    @spills.setter
    def spills(self, v: int):
        self.metrics.set_counter("spills", v)

    @property
    def raw_coll_bytes(self) -> int:
        """Collective payload bytes this part sent with zero-copy raw
        framing (generic PEER_DATA_GEN frames plus raw-layout shm segments)
        — the bytes that never passed through pickle."""
        return self.metrics.get("raw_coll_bytes")

    @raw_coll_bytes.setter
    def raw_coll_bytes(self, v: int):
        self.metrics.set_counter("raw_coll_bytes", v)

    @property
    def shm_bytes(self) -> int:
        """Payload bytes this part handed to same-host peers through
        shared-memory segments (counted by the sender, like p2p_bytes)."""
        return self.metrics.get("shm_bytes")

    @shm_bytes.setter
    def shm_bytes(self, v: int):
        self.metrics.set_counter("shm_bytes", v)

    @property
    def ring_steps(self) -> int:
        """Ring-allgather forwards this part performed (each moves ONE
        part's block one hop; a wide gather costs P-1 per part)."""
        return self.metrics.get("ring_steps")

    @ring_steps.setter
    def ring_steps(self, v: int):
        self.metrics.set_counter("ring_steps", v)

    # --- Communicator-compatible surface (local ranks) -------------------
    @property
    def devices(self) -> tuple:
        return tuple(self.local_comm.devices)

    @property
    def torch_devices(self) -> list:
        """The torch device of each LOCAL rank, in local rank order."""
        return self.local_comm.torch_devices

    def device_of(self, rank: int):
        """The torch device of local rank ``rank`` of this part."""
        return self.local_comm.device_of(rank)

    @property
    def build_seconds(self) -> float:
        return self.local_comm.build_seconds

    @property
    def size(self) -> int:
        """Total ranks of the task across all workers."""
        return self.world_size

    @property
    def local_size(self) -> int:
        return len(self.global_ranks)

    @property
    def rank(self) -> int:
        """First global rank owned by this part."""
        return self.global_ranks[0]

    def sub(self, axis: str):
        return self.local_comm.sub(axis)

    # --- transport tiers: encode / ship / receive / decode ----------------
    def _encode(self, obj) -> _WirePayload:
        """Wire form of one collective payload: raw-split when raw framing
        is on and the payload has array leaves, else pickled."""
        if self.raw_frames:
            split = serialize.dumps_arrays(obj)
            if split is not None:
                skel, metas, bufs = split
                return _WirePayload(skel=skel, metas=metas, bufs=bufs)
        return _WirePayload(data=serialize.dumps(obj))

    def _hub_form(self, pl: _WirePayload, obj) -> bytes:
        """The payload as inline hub bytes (small payloads and per-payload
        fallback) — always plain pickle, whatever tier was attempted."""
        return pl.data if pl.data is not None else serialize.dumps(obj)

    def _ship(self, dest: int, pl: _WirePayload, seq: int,
              origin: Optional[int] = None) -> bool:
        """Ship one wire payload to part ``dest`` down the tier ladder:
        same-host shared memory -> raw peer frame -> pickled peer frame.
        ``origin`` keys the frame when forwarding another part's ring
        block.  False when no peer tier could deliver — the caller falls
        back to the hub (own payload) or to direct sends around the dead
        link (forwarded block)."""
        wid, host, port = self._peer_addrs[dest]
        head = dict(uid=self.uid, attempt=self.attempt, seq=seq,
                    part=self.part if origin is None else origin)
        raw = pl.data is None
        nbytes = pl.nbytes
        if (self.shm and self._host is not None and host == self._host
                and nbytes > self.p2p_threshold):
            name = _shmseg.segment_name(self._peer_net.token,
                                        self._peer_net.worker_id)
            ok = True
            try:
                _shmseg.write(name, pl.bufs if raw else [pl.data])
            except OSError:
                ok = False           # /dev/shm full/unusable: next tier
                _shmseg.unlink(name)
            if ok:
                if self._peer_net.send_kind(
                        wid, (host, port), protocol.PEER_DATA_SHM,
                        shm=name, nbytes=nbytes, skel=pl.skel,
                        arrs=pl.metas, **head):
                    self._peer_net.record_segment(self.uid, self.attempt,
                                                  name)
                    self.p2p_bytes += nbytes
                    self.shm_bytes += nbytes
                    if raw:
                        self.raw_coll_bytes += nbytes
                    return True
                _shmseg.unlink(name)   # header never left: reclaim now
        if raw:
            if self._peer_net.send_kind(wid, (host, port),
                                        protocol.PEER_DATA_GEN,
                                        bufs=pl.bufs, skel=pl.skel,
                                        arrs=pl.metas, **head):
                self.p2p_bytes += nbytes
                self.raw_coll_bytes += nbytes
                return True
            return False
        if self._peer_net.send_kind(wid, (host, port), protocol.PEER_DATA,
                                    payload=pl.data, **head):
            self.p2p_bytes += nbytes
            return True
        return False

    def _abort_reason(self) -> Optional[str]:
        return ("task cancelled" if self.cancelled.is_set()
                else self._hub.dead_error(self.uid, self.attempt))

    def _take_frame(self, seq: int, origin: int):
        with _spans.current_recorder().span("p2p_recv"):
            return self._peer_net.take(
                (self.uid, self.attempt, seq, origin), self._coll_timeout,
                abort=self._abort_reason)

    def _frame_payload(self, frame) -> _WirePayload:
        """One received peer frame back in wire-ready form, whichever tier
        carried it — ring forwarding needs the body bytes in hand, and a
        shm segment must be consumed (copied out + unlinked) exactly
        once."""
        if not isinstance(frame, dict):      # PEER_DATA: pickled bytes
            return _WirePayload(data=frame)
        if frame.get("shm"):
            body = self._consume_segment(frame)
        else:
            body = frame["payload"]
        if frame.get("skel") is not None:
            return _WirePayload(skel=frame["skel"], metas=frame["arrs"],
                                bufs=[body])
        return _WirePayload(data=body)

    def _consume_segment(self, frame) -> bytes:
        """Copy a shm frame's body out of its segment and unlink it —
        whoever received the header owns the cleanup."""
        try:
            return _shmseg.read(frame["shm"])
        except (FileNotFoundError, OSError) as e:
            # the sender aborted and reclaimed it; this attempt is dying
            raise CollectiveError(
                f"shm segment {frame['shm']} vanished before consume "
                f"({e})") from e
        finally:
            _shmseg.unlink(frame["shm"])

    def _decode(self, pl: _WirePayload):
        """A received wire payload back as the object (raw array leaves are
        zero-copy read-only views into the received body)."""
        if pl.data is not None:
            return serialize.loads(pl.data)
        body = (pl.bufs[0] if len(pl.bufs) == 1
                else b"".join(memoryview(b).cast("B") for b in pl.bufs))
        return serialize.loads_arrays(pl.skel, pl.metas, body)

    def _decode_own(self, pl: _WirePayload):
        """This part's own entry of a gathered result, with the same
        no-aliasing guarantee as remote entries: raw leaves are rebuilt as
        views into a fresh copy of the body, never the caller's arrays."""
        if pl.data is not None:
            return serialize.loads(pl.data)
        body = b"".join(memoryview(b).cast("B") for b in pl.bufs)
        return serialize.loads_arrays(pl.skel, pl.metas, body)

    # --- cross-process collectives (per-part granularity) -----------------
    def allgather(self, obj) -> list:
        """Gather one object per *part* (worker share), same list everywhere,
        ordered by part index.  Parts must call collectives in the same
        order — the usual SPMD contract.

        A single-part task (all ranks on this worker — what the pack policy
        arranges whenever the task fits one node) completes the collective
        locally: no hub round-trip, no parent traffic; array leaves are
        copied directly instead of round-tripping through pickle, with the
        same never-aliases-the-input guarantee.

        A spanning task ships large payloads worker-to-worker down the tier
        ladder (see the class docstring), direct to every peer for 2-3
        parts and around the ring for wide tasks; the hub round-trip
        remains as the per-collective control barrier and the automatic
        fallback carrier."""
        if self.n_parts == 1:
            if self.cancelled.is_set():
                raise CollectiveError("task cancelled")
            self._seq += 1
            return [serialize.copy_local(obj)]
        pl = self._encode(obj)
        if (self.ring and self._peers_ok
                and self.n_parts >= self.RING_MIN_PARTS):
            return self._allgather_ring(obj, pl)
        return self._allgather_direct(obj, pl)

    def _allgather_direct(self, obj, pl: _WirePayload) -> list:
        seq, self._seq = self._seq, self._seq + 1
        rec = _spans.current_recorder()
        hub_payload = None
        if self._peers_ok and pl.size > self.p2p_threshold:
            with rec.span("p2p_send"):
                sent = True
                for p in range(self.n_parts):
                    if p != self.part and not self._ship(p, pl, seq):
                        sent = False
                        break
            if sent:
                hub_payload = protocol.PEER_SENT
            else:
                # a peer copy may already be parked at some receivers; they
                # will prefer the hub value and purge the duplicate at task
                # end — correctness never depends on which copy is used
                self.p2p_fallbacks += 1
        if hub_payload is None:
            hub_payload = self._hub_form(pl, obj)
        self.hub_calls += 1
        with rec.span("p2p_recv"):
            values = self._hub.call(self.uid, self.attempt, seq, self.part,
                                    hub_payload, self._coll_timeout)
        out = []
        for j, v in enumerate(values):
            if v != protocol.PEER_SENT:
                out.append(serialize.loads(v))
            elif j == self.part:
                out.append(self._decode_own(pl))
            else:
                out.append(self._decode(self._frame_payload(
                    self._take_frame(seq, j))))
        return out

    def _allgather_ring(self, obj, pl: _WirePayload) -> list:
        """Wide allgather as a P-1 step ring: every part forwards exactly
        one block per step to its next neighbor, so each link carries O(B)
        per step instead of each part pushing O(P·B) direct copies.  The
        hub round runs FIRST as the control barrier: small payloads ride
        it inline, large ones announce PEER_SENT — so the set of ring
        blocks is agreed by every part before any block moves.  A failed
        forward degrades THAT BLOCK to direct sends for the parts
        downstream (one bad link never tears down the collective); a
        genuinely dead peer aborts the attempt through the parent's
        COLL_ERROR exactly as on the direct path."""
        seq, self._seq = self._seq, self._seq + 1
        rec = _spans.current_recorder()
        n, i = self.n_parts, self.part
        if pl.size > self.p2p_threshold:
            hub_payload = protocol.PEER_SENT
        else:
            hub_payload = self._hub_form(pl, obj)
        self.hub_calls += 1
        with rec.span("p2p_recv"):
            values = self._hub.call(self.uid, self.attempt, seq, self.part,
                                    hub_payload, self._coll_timeout)
        ring = {j for j, v in enumerate(values) if v == protocol.PEER_SENT}
        blocks = {i: pl}
        nxt = (i + 1) % n
        for step in range(n - 1):
            o_send = (i - step) % n
            o_recv = (i - 1 - step) % n
            if o_send in ring:
                with rec.span("p2p_send"):
                    if self._ship(nxt, blocks[o_send], seq, origin=o_send):
                        self.ring_steps += 1
                    else:
                        self._ring_rescue(o_send, blocks[o_send], seq)
            if o_recv in ring:
                blocks[o_recv] = self._frame_payload(
                    self._take_frame(seq, o_recv))
        out = []
        for j in range(n):
            if j == i:
                out.append(self._decode_own(pl))
            elif values[j] != protocol.PEER_SENT:
                out.append(serialize.loads(values[j]))
            else:
                out.append(self._decode(blocks[j]))
        return out

    def _ring_rescue(self, origin: int, pl: _WirePayload, seq: int):
        """The forward link is down: direct-ship ``origin``'s block to
        every part downstream of here that has not seen it yet (best
        effort — a part that gets nothing times out into the attempt-level
        retry).  Duplicates a recovered neighbor may also deliver are
        harmless: the mailbox keeps one copy per key and task-end purge
        reclaims strays."""
        self.p2p_fallbacks += 1
        p = (self.part + 1) % self.n_parts
        while p != origin:
            self._ship(p, pl, seq, origin=origin)
            p = (p + 1) % self.n_parts

    def all_to_all_arrays(self, chunks: list) -> list:
        """Personalized all-to-all of numpy column chunks — the shuffle
        bucket exchange.  ``chunks[j]`` (a dict name -> contiguous ndarray)
        is destined for part ``j``; returns ``n_parts`` dicts where entry
        ``i`` is what part ``i`` sent HERE.

        Transport: each destination's chunk ships as ONE ``PEER_DATA_RAW``
        frame — pickled dtype/shape header followed by the columns' raw
        bytes, no pickle round-trip for the body (the dominant cost of the
        pickled path at MB scale).  The control :meth:`allgather` below is
        the per-exchange barrier; a destination whose raw send failed (peer
        unreachable, raw framing disabled, peer plane down) falls back PER
        PAYLOAD to riding that control frame as a plain pickled chunk, so
        mixed outcomes cannot deadlock.  Received raw columns are read-only
        ``np.frombuffer`` views — copy before mutating in place."""
        import numpy as np
        if len(chunks) != self.n_parts:
            raise ValueError(f"all_to_all_arrays: {len(chunks)} chunks for "
                             f"{self.n_parts} parts")
        raw = "__raw__"              # control marker: "await the peer frame"
        use_raw = self._peers_ok and self.raw_frames
        # claim a private seq for the raw frames: both the sender's frame key
        # and the receiver's take() derive it from the SAME lockstep counter
        # the control allgather advances, so no extra coordination is needed
        raw_seq, control = self._seq, [None] * self.n_parts
        rec = _spans.current_recorder()
        for j in range(self.n_parts):
            if j == self.part:
                continue
            sent = False
            if use_raw:
                metas, bufs = _encode_cols(chunks[j])
                wid, host, port = self._peer_addrs[j]
                with rec.span("p2p_send"):
                    sent = self._peer_net.send_raw(
                        wid, (host, port), bufs, uid=self.uid,
                        attempt=self.attempt, seq=raw_seq, part=self.part,
                        cols=metas)
                if sent:
                    self.p2p_bytes += sum(b.nbytes for b in bufs)
            if sent:
                control[j] = raw
            else:
                if use_raw:
                    self.p2p_fallbacks += 1
                control[j] = chunks[j]   # pickled fallback on the barrier
        self._seq += 1                   # consume raw_seq on every part,
        # sends or not — the counters must stay lockstep across parts
        gathered = self.allgather(control)
        out = []
        for i in range(self.n_parts):
            if i == self.part:
                # same copy semantics as allgather's local short-circuit:
                # the returned chunk never aliases the caller's arrays
                out.append({k: np.array(v) for k, v in chunks[i].items()})
                continue
            ctrl = gathered[i][self.part]
            if isinstance(ctrl, str) and ctrl == raw:
                with rec.span("p2p_recv"):
                    d = self._peer_net.take(
                        (self.uid, self.attempt, raw_seq, i),
                        self._coll_timeout,
                        abort=lambda: ("task cancelled"
                                       if self.cancelled.is_set()
                                       else self._hub.dead_error(
                                           self.uid, self.attempt)))
                out.append(_decode_cols(d["cols"], d["payload"]))
            else:
                out.append(ctrl)
        return out

    def barrier(self):
        self.allgather(None)

    def bcast(self, obj, root: int = 0):
        """Broadcast ``obj`` from part ``root`` to every part: the root
        fans its payload out down the tier ladder while non-root parts
        contribute ZERO-BYTE tokens to the barrier frame — nobody pickles
        or ships placeholder values, and each receiver decodes only the
        root's entry instead of all P."""
        if self.n_parts == 1:
            if self.cancelled.is_set():
                raise CollectiveError("task cancelled")
            self._seq += 1
            return serialize.copy_local(obj)
        seq, self._seq = self._seq, self._seq + 1
        rec = _spans.current_recorder()
        pl = None
        if self.part == root:
            pl = self._encode(obj)
            hub_payload = None
            if self._peers_ok and pl.size > self.p2p_threshold:
                with rec.span("p2p_send"):
                    sent = True
                    for p in range(self.n_parts):
                        if p != root and not self._ship(p, pl, seq):
                            sent = False
                            break
                if sent:
                    hub_payload = protocol.PEER_SENT
                else:
                    self.p2p_fallbacks += 1
            if hub_payload is None:
                hub_payload = self._hub_form(pl, obj)
        else:
            hub_payload = b""        # control-only barrier contribution
        self.hub_calls += 1
        with rec.span("p2p_recv"):
            values = self._hub.call(self.uid, self.attempt, seq, self.part,
                                    hub_payload, self._coll_timeout)
        if self.part == root:
            return self._decode_own(pl)
        v = values[root]
        if v == protocol.PEER_SENT:
            return self._decode(self._frame_payload(
                self._take_frame(seq, root)))
        return serialize.loads(v)


class Worker:
    def __init__(self, addr: tuple, worker_id: str, n_devices: int,
                 heartbeat: float, token: str, p2p: bool = True,
                 device: Optional[str] = None):
        self.worker_id = worker_id
        self.n_devices = n_devices
        # the worker's K logical ranks, all on one torch device (resolved
        # here, before HELLO: a worker told to use the card on a box with
        # none fails at start-up instead of falling back to the CPU)
        self.device = _start_device(device)
        self.ranks = logical_devices(n_devices, self.device)
        self.heartbeat = heartbeat
        self.token = token
        sock = socket.create_connection(addr, timeout=30)
        # the connect timeout must NOT linger on the established channel: an
        # idle worker (no launches for 30s) would hit a recv timeout and die
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.chan = Channel(sock)
        self.hub = _Hub(self.chan)
        self.peer_net: Optional[_PeerNet] = None
        if p2p:
            self.peer_net = _PeerNet(worker_id, token)
            # advertise the interface the parent is reached through — the
            # one address peers on other hosts can route to as well
            self.peer_net.start(sock.getsockname()[0])
        self._tasks: dict = {}   # (uid, attempt) -> cancel Event, while the
        # part runs here; doubles as the is-this-attempt-alive check
        # worker-lifetime flight-recorder registry: every part's comm
        # registry chains into it (counters: hub_calls, p2p_bytes,
        # p2p_fallbacks, spills, spill_bytes) and its snapshot rides every
        # HEARTBEAT frame as the telemetry the parent surfaces as trace
        # events — liveness and observability share one frame
        self.metrics = _metrics.MetricsRegistry()
        self.metrics.gauge("queue_depth", lambda: len(self._tasks))
        self.metrics.gauge("rss_mb", _metrics.rss_mb)
        if self.peer_net is not None:
            self.metrics.gauge("peer_channels",
                               lambda: len(self.peer_net._out))

    # --- device inventory -------------------------------------------------
    def _local_devices(self, indices, build_comm: bool):
        if not build_comm:
            return tuple(f"{self.worker_id}:{i}" for i in indices)
        return tuple(self.ranks[i] for i in indices)

    # --- task parts -------------------------------------------------------
    def _run_part(self, d: dict, cancelled: threading.Event):
        uid, attempt, part = d["uid"], d["attempt"], d["part"]
        comm_s = 0.0
        comm = None
        rec = _spans.SpanRecorder()
        t_recv = d.pop("_recv_t", None)
        if t_recv is not None:
            rec.add("launch_recv", t_recv, time.perf_counter())
        ckpt = None
        if d.get("ckpt_dir"):
            # per-(lineage, attempt, part) checkpoint handle — a retried or
            # speculated attempt restores the previous attempt's durable
            # steps from the shared part scope (see train.checkpoint)
            ckpt = CheckpointContext(d["ckpt_dir"],
                                     attempt=d.get("ckpt_attempt") or "a0",
                                     part=part, n_parts=d["n_parts"])

        def stats() -> dict:
            return {"p2p_bytes": comm.p2p_bytes if comm else 0,
                    "hub_calls": comm.hub_calls if comm else 0,
                    "p2p_fallbacks": comm.p2p_fallbacks if comm else 0,
                    "spills": comm.spills if comm else 0,
                    "raw_coll_bytes": comm.raw_coll_bytes if comm else 0,
                    "shm_bytes": comm.shm_bytes if comm else 0,
                    "ring_steps": comm.ring_steps if comm else 0,
                    "resumed_from_step":
                        ckpt.resumed_from_step if ckpt else 0,
                    "spans": rec.export()}

        clean = False
        try:
            devs = self._local_devices(d["local_devices"], d["build_comm"])
            if d["build_comm"]:
                shape = d["mesh_shape"] if d["n_parts"] == 1 else None
                with rec.span("comm_build"):
                    local = build_communicator(
                        devs, d["mesh_axes"], shape,
                        uid=f"task{uid}.p{part}",
                        placement=d.get("placement", ""))
                comm_s = local.build_seconds
            else:
                local = StubComm(devices=devs,
                                 placement=d.get("placement", ""))
            comm = ProcTaskComm(uid=uid, world_size=d["world_size"],
                                global_ranks=d["global_ranks"], part=part,
                                n_parts=d["n_parts"], local_comm=local,
                                hub=self.hub, attempt=attempt,
                                cancelled=cancelled,
                                placement=d.get("placement", ""),
                                peer_net=self.peer_net,
                                peer_addrs=d.get("peer_addrs"),
                                p2p_threshold=d.get("p2p_threshold", 1024),
                                raw_frames=d.get("raw_frames", True),
                                ring=d.get("ring", True),
                                shm=d.get("shm", True),
                                registry=_metrics.MetricsRegistry(
                                    parent=self.metrics))
            comm.checkpoint = ckpt
            # the recorder is bound to THIS thread for the payload call, so
            # nested library code (comm collectives, shuffle SpillBuffer)
            # records spans without any parameter plumbing
            with _spans.bound(rec):
                with rec.span("deserialize"):
                    fn, args, kwargs = serialize.loads(d["payload"])
                with rec.span("compute"):
                    res = fn(comm, *args, **kwargs)
            self.chan.send(protocol.PART_DONE, uid=uid, attempt=attempt,
                           part=part, result=serialize.dumps(res),
                           error=None, comm_build_s=comm_s, **stats())
            clean = True
        except ConnectionClosed:
            pass                     # parent is gone; nothing to report to
        except Exception as e:  # noqa: BLE001 — report any payload error
            try:
                self.chan.send(protocol.PART_DONE, uid=uid, attempt=attempt,
                               part=part, result=None,
                               error=f"{type(e).__name__}: {e}",
                               comm_build_s=comm_s, **stats())
            except ConnectionClosed:
                pass
        finally:
            self._tasks.pop((uid, attempt), None)
            self.hub.forget(uid, attempt)
            if self.peer_net is not None:
                # parked peer frames of this attempt are unclaimable now; a
                # failed/cancelled attempt also reclaims the shm segments
                # this part sent — its receivers abort without consuming
                self.peer_net.purge(uid, attempt,
                                    failed=not clean or cancelled.is_set())

    def _log(self, msg: str):
        print(f"[worker {self.worker_id} pid={os.getpid()} "
              f"t={time.time():.3f}] {msg}", file=sys.stderr, flush=True)

    # --- liveness ---------------------------------------------------------
    def _heartbeat_loop(self):
        while True:
            time.sleep(self.heartbeat)
            try:
                # every beat carries the gauge/counter snapshot plus a fresh
                # perf_counter stamp so the parent can place the telemetry
                # event on its own clock via the HELLO offset
                self.chan.send(protocol.HEARTBEAT, worker=self.worker_id,
                               t=time.time(),
                               perf_t=time.perf_counter(),
                               telemetry=self.metrics.snapshot())
            except ConnectionClosed as e:
                self._log(f"exiting: heartbeat send failed ({e})")
                os._exit(1)          # parent died: no reason to live on

    # --- main loop --------------------------------------------------------
    def run(self):
        data_addr = self.peer_net.data_addr if self.peer_net else None
        # perf_t is stamped as late as possible before the send: the parent
        # computes this worker's clock offset from it at HELLO receipt
        self.chan.send(protocol.HELLO, worker=self.worker_id, pid=os.getpid(),
                       n_devices=self.n_devices, token=self.token,
                       platform=sys.platform,
                       device=str(self.device),
                       data_host=data_addr[0] if data_addr else None,
                       data_port=data_addr[1] if data_addr else None,
                       perf_t=time.perf_counter())
        threading.Thread(target=self._heartbeat_loop, daemon=True).start()
        while True:
            try:
                kind, d = self.chan.recv()
            except ConnectionClosed as e:
                self._log(f"exiting: parent channel closed ({e})")
                os._exit(1)
            if kind == protocol.LAUNCH:
                # stamp receipt so the part records the launch_recv span
                # (queueing delay between frame arrival and thread pickup)
                d["_recv_t"] = time.perf_counter()
                # register the cancel flag BEFORE the part thread exists so
                # a CANCEL racing the thread start is never lost (frames on
                # one channel are ordered: LAUNCH always precedes CANCEL)
                cancelled = threading.Event()
                self._tasks[(d["uid"], d["attempt"])] = cancelled
                threading.Thread(target=self._run_part, args=(d, cancelled),
                                 daemon=True).start()
            elif kind == protocol.COLL_RESULT:
                self.hub.deliver(d["uid"], d["attempt"], d["seq"],
                                 d["values"])
            elif kind == protocol.COLL_ERROR:
                self.hub.fail(d["uid"], d["attempt"], d.get("seq"),
                              d["error"])
            elif kind == protocol.CANCEL:
                cancelled = self._tasks.get((d["uid"], d["attempt"]))
                if cancelled is not None:    # part still running here
                    cancelled.set()
                    self.hub.fail(d["uid"], d["attempt"], None,
                                  "task cancelled")
            elif kind == protocol.PEERS_UPDATE:
                # elastic membership change: evict cached channels to the
                # departed peers NOW — not lazily on the next failed send
                # (which would cost a fallback).  Live addresses stay
                # per-task: every spanning LAUNCH ships its own book.
                if self.peer_net is not None:
                    for wid in d.get("removed", ()):
                        self.peer_net.evict(wid)
            elif kind == protocol.SHUTDOWN:
                self._log("exiting: shutdown requested")
                os._exit(0)


def _start_device(device: Optional[str]):
    """The torch device of the worker's ranks.  On a card the CUDA context
    starts here, synchronised, before the worker registers: its start-up
    can take longer than the liveness timeout, and the parent only times
    heartbeats from HELLO on."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    return dev


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--addr", required=True, help="host:port of the pilot")
    p.add_argument("--worker", required=True)
    p.add_argument("--n-devices", type=int, required=True)
    p.add_argument("--device", default=None,
                   help="torch device of the worker's ranks (default: the "
                        "current CUDA device; never the CPU on its own)")
    p.add_argument("--heartbeat", type=float, default=0.5)
    p.add_argument("--token", default="")
    p.add_argument("--p2p", type=int, default=1,
                   help="1: open a peer-data port (worker-to-worker "
                        "collective payloads); 0: hub relay only")
    a = p.parse_args(argv)
    host, port = a.addr.rsplit(":", 1)
    Worker((host, int(port)), a.worker, a.n_devices, a.heartbeat,
           a.token, p2p=bool(a.p2p), device=a.device).run()


if __name__ == "__main__":
    main()
