"""Length-prefixed frame protocol between the pilot (parent) and its worker
processes.

A frame is ``>I`` big-endian byte length followed by a stdlib-pickled
``(kind, data)`` tuple where ``data`` is a plain dict of control fields.
User payloads (functions, results) travel inside frames as opaque ``bytes``
produced by ``serialize.dumps`` — the framing layer never unpickles them.

Message kinds
=============
Every task-scoped frame carries (uid, attempt): the scheduler reuses a
task's uid across retries, and the attempt id keeps stale frames from a
failed attempt out of its successor.

worker -> parent:
  HELLO      {worker, pid, n_devices, platform, device,
              data_host, data_port, perf_t}            registration (device:
              the torch device of the worker's ranks); the
              data address is the worker's peer-data listener (None when
              the peer plane is disabled) — the parent's address book.
              perf_t is the worker's perf_counter stamped at send time:
              the parent derives this worker's clock offset from it, the
              alignment every shipped span/telemetry timestamp rides on
  HEARTBEAT  {worker, t, perf_t, telemetry}            liveness + the
              worker's gauge/counter snapshot (queue depth, RSS, spill
              bytes, peer channels, p2p_fallbacks) — the parent surfaces
              it as a ``telemetry`` trace event at perf_t + clock offset
  PART_DONE  {uid, attempt, part, result: bytes|None, error: str|None,
              comm_build_s, p2p_bytes, hub_calls,
              p2p_fallbacks, spills,
              spans: [(kind, t0, t1, parent, attrs), ...]}
                                                       one part finished;
              spans are the part's flight-recorder sections in the
              worker's clock (parent: the index of the span each was
              opened in), aligned and merged into the trace by the
              parent
  COLL       {uid, attempt, seq, part, payload: bytes} collective contribution

parent -> worker:
  LAUNCH     {uid, attempt, name, part, n_parts, local_devices: [int],
              global_ranks: [int], world_size, payload: bytes,
              mesh_axes, mesh_shape, build_comm,
              peer_addrs: [(worker, host, port)|None],
              p2p_threshold, raw_frames}               run one task part;
              peer_addrs is the full address book of the task's parts so
              large collective payloads can move worker-to-worker
  COLL_RESULT {uid, attempt, seq, values: [bytes]}     gathered contributions
  COLL_ERROR {uid, attempt, seq|None, error}           participant died
  CANCEL     {uid, attempt}                            cooperative abort
  PEERS_UPDATE {workers: {worker: (host, port)|None},
              removed: [worker]}                       refreshed peer address
              book after an elastic grow/retire/loss; a worker closes and
              evicts its cached peer channel to every ``removed`` id
              immediately instead of discovering the dead channel per
              payload (the hub-fallback path)
  SHUTDOWN   {}                                        clean exit

worker -> worker (peer data plane, same framing on the data port):
  PEER_HELLO {worker, token}                           authenticate channel
  PEER_DATA  {uid, attempt, seq, part, payload: bytes} one part's collective
              payload, shipped directly to a peer — the hub sees only the
              PEER_SENT placeholder for it
  PEER_DATA_RAW {uid, attempt, seq, part, nbytes,
              cols: [(name, dtype, shape), ...]}       raw-buffer framing:
              the pickled header above is followed by ``nbytes`` of raw
              array bytes ON THE SAME STREAM (the columns' contiguous
              buffers, concatenated in ``cols`` order).  The payload never
              passes through pickle on either side — the sender writes the
              arrays' memoryviews straight to the socket and the receiver
              reconstructs zero-copy views with ``np.frombuffer`` — which
              is what makes MB-scale shuffle buckets cheap to ship.
  PEER_DATA_GEN {uid, attempt, seq, part, nbytes,
              skel: bytes, arrs: [(dtype, shape), ...]} generic raw-buffer
              framing for ANY collective payload (allgather/bcast bodies,
              not just shuffle column dicts): ``skel`` is the pickled
              container skeleton with array leaves replaced by indexed
              placeholders (``serialize.dumps_arrays``), ``arrs`` the
              leaves' dtype/shape metadata, and ``nbytes`` of raw leaf
              bytes follow the header on the stream exactly like
              PEER_DATA_RAW.
  PEER_DATA_SHM {uid, attempt, seq, part, nbytes, shm,
              skel: bytes|None, arrs: list|None}        same-host handoff:
              the body bytes live in the named tmpfs segment file ``shm``
              (see ``executors.shm``) — only this header travels on the
              socket.  ``skel``/``arrs`` carry the generic raw layout
              (``skel is None`` means the segment holds one pickled
              payload).  The RECEIVER unlinks the segment after copying
              it out; unconsumed segments are unlinked by the sender's
              purge or swept by the parent (worker death).
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading

HELLO = "hello"
HEARTBEAT = "heartbeat"
PART_DONE = "part_done"
COLL = "coll"
LAUNCH = "launch"
COLL_RESULT = "coll_result"
COLL_ERROR = "coll_error"
CANCEL = "cancel"
PEERS_UPDATE = "peers_update"
SHUTDOWN = "shutdown"
PEER_HELLO = "peer_hello"
PEER_DATA = "peer_data"
PEER_DATA_RAW = "peer_data_raw"
PEER_DATA_GEN = "peer_data_gen"
PEER_DATA_SHM = "peer_data_shm"

#: frame kinds whose pickled header is followed by ``nbytes`` of raw body
#: bytes on the same stream (read by ``Channel.recv`` into ``payload``).
#: PEER_DATA_SHM is deliberately NOT here: its body never touches the
#: socket — it lives in the named shared-memory segment.
RAW_BODY_KINDS = frozenset({PEER_DATA_RAW, PEER_DATA_GEN})

#: Placeholder a part sends the hub instead of its payload when the payload
#: already went worker-to-worker over the peer data plane.  Real payloads are
#: ``serialize.dumps`` output — a pickle stream, which always opens with the
#: b"\x80" PROTO opcode — so a value starting with b"\x00" can never collide.
PEER_SENT = b"\x00p2p\x00"

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 31   # 2 GiB sanity cap


class ConnectionClosed(Exception):
    """Peer went away (EOF or reset) — the liveness signal for SIGKILL."""


class Channel:
    """One framed, thread-safe duplex connection.

    Sends may come from several threads (scheduler launch, hub replies,
    heartbeat) and are serialized by a lock; receives are single-threaded
    (each side owns one reader loop).  ``on_traffic`` (if set) fires per
    received chunk — heartbeats queue BEHIND a large in-flight frame on the
    same TCP stream, so byte progress itself must count as liveness."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()
        self.on_traffic = None

    def send(self, kind: str, **data):
        frame = pickle.dumps((kind, data), protocol=pickle.HIGHEST_PROTOCOL)
        with self._send_lock:
            try:
                self.sock.sendall(_LEN.pack(len(frame)) + frame)
            except OSError as e:
                raise ConnectionClosed(str(e)) from e

    def send_raw(self, kind: str, bufs, **data):
        """Send a raw-body frame: the pickled ``(kind, data)`` header (with
        ``nbytes`` filled in) followed by every buffer in ``bufs`` written
        straight to the socket — no pickle round-trip for the body.  The
        buffers must stay alive/unmutated for the duration of the call;
        ``kind`` must be in :data:`RAW_BODY_KINDS` so the receiver knows to
        read the body."""
        views = [memoryview(b).cast("B") for b in bufs]
        data["nbytes"] = sum(v.nbytes for v in views)
        frame = pickle.dumps((kind, data), protocol=pickle.HIGHEST_PROTOCOL)
        with self._send_lock:
            try:
                self.sock.sendall(_LEN.pack(len(frame)) + frame)
                for v in views:
                    self.sock.sendall(v)
            except OSError as e:
                raise ConnectionClosed(str(e)) from e

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            try:
                chunk = self.sock.recv(min(n, 1 << 20))
            except OSError as e:
                raise ConnectionClosed(str(e)) from e
            if not chunk:
                raise ConnectionClosed("EOF")
            if self.on_traffic is not None:
                self.on_traffic()
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def recv(self):
        """Blocking read of the next ``(kind, data)`` frame.  A raw-body
        frame's trailing bytes are read off the stream here and attached as
        ``data["payload"]`` — the framing stays self-delimiting either way."""
        (n,) = _LEN.unpack(self._recv_exact(_LEN.size))
        if n > MAX_FRAME:
            raise ConnectionClosed(f"oversized frame ({n} bytes)")
        kind, data = pickle.loads(self._recv_exact(n))
        if kind in RAW_BODY_KINDS:
            nbytes = data.get("nbytes", 0)
            if nbytes > MAX_FRAME:
                raise ConnectionClosed(f"oversized raw body ({nbytes} bytes)")
            data["payload"] = self._recv_exact(nbytes)
        return kind, data

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
