"""The port's multi-process pilot (``ProcessExecutor``, its worker, the wire
protocol and the shared-memory tier) against the JAX package's.

Wire-layer units run in-process; the smoke run starts 2 port workers and 2
JAX workers and holds the port's results and trace skeleton to the JAX
executor's for the same task descriptions.  Every other subprocess test
(failure injection, elastic grow and retire, shm residue) is marked
``integration``, as the reference's are.  Workers run on the CPU
(``device="cpu"``); without it the executor needs a card.
"""
import signal
import socket
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.executors import protocol as jax_protocol
from repro.core.executors.worker import _PeerNet as JaxPeerNet
from repro_torch.core.executors import protocol, serialize
from repro_torch.core.executors import shm as shmseg
from repro_torch.core.executors.protocol import Channel, ConnectionClosed
from repro_torch.core.executors.worker import CollectiveError, _PeerNet

if serialize.HAVE_CLOUDPICKLE:
    import cloudpickle

    # ship this module's payload functions by value: a worker process has no
    # way to import the test module
    cloudpickle.register_pickle_by_value(sys.modules[__name__])

needs_cloudpickle = pytest.mark.skipif(
    not serialize.HAVE_CLOUDPICKLE,
    reason="cloudpickle needed to ship test-local payload functions")

needs_dev_shm = pytest.mark.skipif(
    not Path("/dev/shm").is_dir(),
    reason="/dev/shm segment checks need a POSIX shm mount")

CPU = "cpu"


# ---------------------------------------------------------------------------
# wire protocol (no subprocesses)
# ---------------------------------------------------------------------------
def test_protocol_frame_kinds_and_cap_match_reference():
    """The port speaks the reference's wire protocol: same frame kinds, raw
    body kinds, hub placeholder and frame cap."""
    names = [n for n in dir(jax_protocol) if n.isupper() and n[0] != "_"]
    assert names == [n for n in dir(protocol) if n.isupper() and n[0] != "_"]
    for n in names:
        assert getattr(protocol, n) == getattr(jax_protocol, n), n
    assert protocol._LEN.format == jax_protocol._LEN.format


def test_channel_roundtrip_and_eof():
    a, b = socket.socketpair()
    ca, cb = Channel(a), Channel(b)
    big = b"x" * (3 << 20)
    # a frame larger than the socket buffer: send from a thread so the
    # reader drains concurrently (as the real duplex channel does)
    sender = threading.Thread(target=ca.send, args=("launch",),
                              kwargs={"uid": 7, "payload": big})
    sender.start()
    kind, d = cb.recv()
    sender.join(timeout=30)
    assert not sender.is_alive()
    assert kind == "launch" and d["uid"] == 7 and d["payload"] == big
    cb.send("part_done", uid=7, part=0)
    assert ca.recv()[0] == "part_done"
    cb.close()
    with pytest.raises(ConnectionClosed):
        ca.recv()


def test_channel_send_is_thread_safe():
    a, b = socket.socketpair()
    ca, cb = Channel(a), Channel(b)
    n_threads, n_frames = 4, 50
    payload = b"y" * 10_000

    def sender(tid):
        for i in range(n_frames):
            ca.send("coll", tid=tid, i=i, payload=payload)

    threads = [threading.Thread(target=sender, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    got = [cb.recv() for _ in range(n_threads * n_frames)]
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    # interleaved multi-threaded sends must never corrupt framing
    assert all(kind == "coll" and d["payload"] == payload for kind, d in got)
    assert sorted((d["tid"], d["i"]) for _, d in got) == [
        (t, i) for t in range(n_threads) for i in range(n_frames)]


def test_channel_rejects_oversized_frame_header():
    a, b = socket.socketpair()
    a.sendall((protocol.MAX_FRAME + 1).to_bytes(4, "big"))
    with pytest.raises(ConnectionClosed, match="oversized"):
        Channel(b).recv()


def test_serialize_roundtrip():
    fn, args, kwargs = (sorted, ([3, 1, 2],), {"reverse": True})
    f2, a2, k2 = serialize.loads(serialize.dumps((fn, args, kwargs)))
    assert f2(*a2, **k2) == [3, 2, 1]
    if serialize.HAVE_CLOUDPICKLE:
        add = serialize.loads(serialize.dumps(lambda x: x + 1))
        assert add(41) == 42


def test_serialize_without_cloudpickle_rejects_main_payloads(monkeypatch):
    monkeypatch.setattr(serialize, "HAVE_CLOUDPICKLE", False)

    def fake_main_fn():
        return 1

    fake_main_fn.__module__ = "__main__"
    with pytest.raises(TypeError, match="cloudpickle"):
        serialize.dumps((fake_main_fn, (), {}))
    assert serialize.loads(serialize.dumps((sorted, ([2, 1],), {})))


def test_serialize_keeps_bfloat16_tensors_as_pickled_leaves():
    """numpy has no bfloat16: such a tensor rides in the pickled skeleton
    and comes back a tensor with its bits, beside raw-shipped leaves."""
    x = torch.randn(64, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    skel, metas, bufs = serialize.dumps_arrays({"x": x,
                                                "y": torch.arange(5)})
    assert len(bufs) == 1 and metas == [(np.dtype(np.int64).str, (5,))]
    back = serialize.loads_arrays(skel, metas, bufs[0].tobytes())
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)
    assert back["y"].tolist() == list(range(5))
    assert torch.equal(serialize.copy_local({"x": x})["x"], x)


def test_proc_device_is_stable_rm_handle():
    devs = [T.ProcDevice("w0", 0), T.ProcDevice("w0", 1),
            T.ProcDevice("w1", 0)]
    rm = T.ResourceManager(devs)
    got = rm.allocate(2)
    assert got == (devs[0], devs[1])
    rm.release(got)
    rm.fail_devices([devs[2]])
    assert rm.total == 2 and devs[2] not in rm
    # the same handle, repr and topology as the reference's
    assert [repr(d) for d in devs] == [repr(J.ProcDevice(*d)) for d in devs]
    ex = T.ProcessExecutor(device=CPU)
    assert ex.topology(devs).nodes == {"w0": tuple(devs[:2]),
                                       "w1": (devs[2],)}


# ---------------------------------------------------------------------------
# peer data plane (no subprocesses)
# ---------------------------------------------------------------------------
def _nets(cls_a=_PeerNet, cls_b=_PeerNet):
    a, b = cls_a("wa", token="t"), cls_b("wb", token="t")
    a.start("127.0.0.1")
    b.start("127.0.0.1")
    return a, b


def test_peer_sent_sentinel_cannot_collide_with_payloads():
    for obj in (None, 0, b"", "x", [1, 2], {"a": b"\x00p2p\x00"},
                protocol.PEER_SENT, torch.zeros(2)):
        assert serialize.dumps(obj)[:1] == b"\x80"
    assert protocol.PEER_SENT[:1] == b"\x00"


def test_peer_net_ships_frames_between_two_nets():
    a, b = _nets()
    blob = b"z" * (2 << 20)
    assert a.send("wb", b.data_addr, uid=1, attempt=0, seq=0, part=0,
                  payload=blob)
    assert b.take((1, 0, 0, 0), timeout=10) == blob
    assert b.send("wa", a.data_addr, uid=1, attempt=0, seq=0, part=1,
                  payload=b"r1")
    assert b.send("wa", a.data_addr, uid=1, attempt=0, seq=1, part=1,
                  payload=b"r2")
    assert a.take((1, 0, 0, 1), timeout=10) == b"r1"
    assert a.take((1, 0, 1, 1), timeout=10) == b"r2"


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_peer_nets_of_both_packages_interoperate(direction):
    """Same framing on the wire: a frame sent by one package's peer net is
    taken by the other's, pickled and raw alike."""
    a, b = _nets(_PeerNet, JaxPeerNet) if direction == "port_to_jax" else \
        _nets(JaxPeerNet, _PeerNet)
    assert a.send("wb", b.data_addr, uid=3, attempt=0, seq=0, part=0,
                  payload=b"hello")
    assert b.take((3, 0, 0, 0), timeout=10) == b"hello"
    col = np.arange(1000, dtype=np.int64)
    assert a.send_raw("wb", b.data_addr, [col], uid=3, attempt=0, seq=1,
                      part=0, cols=[("k", col.dtype.str, col.shape)])
    frame = b.take((3, 0, 1, 0), timeout=10)
    assert np.frombuffer(frame["payload"], np.int64).tolist() == col.tolist()


def test_peer_net_rejects_wrong_token():
    srv = _PeerNet("srv", token="good")
    srv.start("127.0.0.1")
    rogue = _PeerNet("rogue", token="BAD")
    rogue.send("srv", srv.data_addr, uid=9, attempt=0, seq=0, part=0,
               payload=b"evil")
    with pytest.raises(CollectiveError):
        srv.take((9, 0, 0, 0), timeout=0.5)


def test_peer_net_send_to_dead_port_fails_fast_not_hangs():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    dead_addr = sock.getsockname()
    sock.close()
    net = _PeerNet("w", token="t")
    t0 = time.monotonic()
    assert net.send("gone", dead_addr, uid=1, attempt=0, seq=0, part=0,
                    payload=b"x") is False
    assert time.monotonic() - t0 < 5.0


def test_peer_net_take_unblocked_by_abort():
    net = _PeerNet("w", token="t")
    flag = threading.Event()
    threading.Timer(0.2, flag.set).start()
    t0 = time.monotonic()
    with pytest.raises(CollectiveError, match="torn down"):
        net.take((1, 0, 0, 0), timeout=60,
                 abort=lambda: "torn down" if flag.is_set() else None)
    assert time.monotonic() - t0 < 5.0


def test_peer_net_purge_drops_stale_attempt_only():
    net = _PeerNet("w", token="t")
    net.put((7, 0, 0, 1), b"stale")
    net.put((7, 1, 0, 1), b"fresh")
    net.purge(7, 0)
    assert net.take((7, 1, 0, 1), timeout=1) == b"fresh"
    with pytest.raises(CollectiveError):
        net.take((7, 0, 0, 1), timeout=0.2)


def test_peer_net_frame_arriving_after_purge_is_dropped():
    net = _PeerNet("w", token="t")
    net.purge(7, 0)
    net.put((7, 0, 1, 1), b"late")
    assert not net._mail
    with pytest.raises(CollectiveError):
        net.take((7, 0, 1, 1), timeout=0.2)


def test_peer_net_evict_closes_cached_channel_and_reconnects():
    a, b = _nets()
    assert a.send("wb", b.data_addr, uid=1, attempt=0, seq=0, part=0,
                  payload=b"one")
    assert "wb" in a._out
    a.evict("wb")
    assert "wb" not in a._out
    assert a.send("wb", b.data_addr, uid=1, attempt=0, seq=1, part=0,
                  payload=b"two")
    assert b.take((1, 0, 0, 0), timeout=10) == b"one"
    assert b.take((1, 0, 1, 0), timeout=10) == b"two"
    a.evict("stranger")


# ---------------------------------------------------------------------------
# transport tiers: generic raw frames and shared-memory segments
# ---------------------------------------------------------------------------
def _tensor_payload():
    return {"t": torch.arange(1 << 14, dtype=torch.float32).reshape(128, -1),
            "m": np.arange(1 << 12, dtype=np.int32), "meta": ["x", 7]}


def _check_tensor_payload(back):
    want = _tensor_payload()
    assert back["meta"] == ["x", 7]
    assert back["t"].dtype == np.float32 and back["t"].shape == (128, 128)
    assert back["t"].tobytes() == want["t"].numpy().tobytes()
    assert back["m"].tobytes() == want["m"].tobytes()


def test_peer_net_ships_generic_raw_frames_of_tensors():
    """A payload holding torch tensors goes out as raw array bytes
    (``serialize._as_array`` stages a tensor to host memory) and comes back
    as numpy views, bit for bit."""
    a, b = _nets()
    skel, metas, bufs = serialize.dumps_arrays(_tensor_payload())
    assert a.send_kind("wb", b.data_addr, protocol.PEER_DATA_GEN, bufs=bufs,
                       skel=skel, arrs=metas, uid=1, attempt=0, seq=0, part=0)
    frame = b.take((1, 0, 0, 0), timeout=10)
    assert frame["nbytes"] == sum(x.nbytes for x in bufs)
    _check_tensor_payload(serialize.loads_arrays(frame["skel"], frame["arrs"],
                                                 frame["payload"]))


@needs_dev_shm
def test_peer_net_shm_frame_of_tensors_handoff_and_consume():
    a, b = _nets()
    skel, metas, bufs = serialize.dumps_arrays(_tensor_payload())
    name = shmseg.segment_name("t", "wa")
    nbytes = shmseg.write(name, bufs)
    assert a.send_kind("wb", b.data_addr, protocol.PEER_DATA_SHM, shm=name,
                       nbytes=nbytes, skel=skel, arrs=metas,
                       uid=2, attempt=0, seq=0, part=0)
    frame = b.take((2, 0, 0, 0), timeout=10)
    # consumed eagerly: the body is in the frame, the segment is gone
    assert "shm" not in frame and not (Path("/dev/shm") / name).exists()
    _check_tensor_payload(serialize.loads_arrays(frame["skel"], frame["arrs"],
                                                 frame["payload"]))


@needs_dev_shm
def test_shm_segment_write_read_unlink_sweep():
    name = shmseg.segment_name("tok12345", "w0")
    assert name.startswith("repro_tok12345_w0_")
    assert shmseg.write(name, [b"ab", b"cd"]) == 4
    assert shmseg.read(name) == b"abcd"
    assert shmseg.unlink(name) is True
    assert shmseg.unlink(name) is False
    n1 = shmseg.segment_name("tok12345", "w1")
    n2 = shmseg.segment_name("OTHERtok", "w1")
    shmseg.write(n1, [b"x"])
    shmseg.write(n2, [b"x"])
    assert shmseg.sweep("repro_tok12345_") == 1
    assert not (Path("/dev/shm") / n1).exists()
    assert (Path("/dev/shm") / n2).exists()
    shmseg.unlink(n2)


@needs_dev_shm
def test_purge_unlinks_parked_shm_frames():
    net = _PeerNet("w", token="t")
    name = shmseg.segment_name("t", "w")
    shmseg.write(name, [b"\x00" * 32])
    net.put((5, 0, 0, 1), {"shm": name, "nbytes": 32})
    net.purge(5, 0)
    assert not (Path("/dev/shm") / name).exists()
    late = shmseg.segment_name("t", "w")
    shmseg.write(late, [b"\x00" * 32])
    net.put((5, 0, 1, 1), {"shm": late, "nbytes": 32})
    assert not net._mail
    assert not (Path("/dev/shm") / late).exists()


@needs_dev_shm
def test_purge_failed_reclaims_sent_segments():
    net = _PeerNet("w", token="t")
    kept = shmseg.segment_name("t", "w")
    gone = shmseg.segment_name("t", "w")
    shmseg.write(kept, [b"\x00" * 16])
    shmseg.write(gone, [b"\x00" * 16])
    net.record_segment(1, 0, kept)
    net.record_segment(2, 0, gone)
    net.purge(1, 0, failed=False)
    net.purge(2, 0, failed=True)
    assert (Path("/dev/shm") / kept).exists()
    assert not (Path("/dev/shm") / gone).exists()
    shmseg.unlink(kept)


# ---------------------------------------------------------------------------
# device: the card unless the caller names another, never a silent CPU
# ---------------------------------------------------------------------------
def test_process_executor_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = T.ProcessExecutor(n_workers=1, devices_per_worker=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.start()
    assert not ex.workers            # refused before spawning anything


def test_worker_asked_for_the_card_without_one_fails_at_hello():
    """A worker told to use a card on a box with none exits before its
    HELLO; the executor raises with the worker's log tail."""
    if torch.cuda.is_available():
        pytest.skip("needs a box without a CUDA device")
    ex = T.ProcessExecutor(n_workers=1, devices_per_worker=1,
                           device="cuda:0", start_timeout=60)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        ex.start()
    assert all(w.proc.poll() is not None for w in ex.workers.values())


# ---------------------------------------------------------------------------
# payloads shipped to workers (module-level, pickled by value)
# ---------------------------------------------------------------------------
def _echo(comm, tag="t"):
    return (tag, comm.size, comm.local_size, tuple(map(str, comm.devices)))


def _span_gather(comm):
    parts = comm.allgather(comm.global_ranks)
    root = comm.bcast(("from-part0", comm.rank))
    comm.barrier()
    return {"parts": parts, "root": root, "world": comm.size}


def _sleepy(comm, dur=0.8):
    time.sleep(dur)
    return str(comm.devices[0])


def _flaky_on_w0(comm):
    dev = str(comm.devices[0])
    if dev.startswith("w0"):
        raise RuntimeError(f"bad device {dev}")
    return dev


def _devs(comm):
    return tuple(map(str, comm.devices))


def _slow_span(comm, dur=0.5):
    time.sleep(dur)
    parts = comm.allgather(comm.part)
    return {"parts": parts, "devices": tuple(map(str, comm.devices)),
            "fallbacks": comm.p2p_fallbacks}


_ROWS = 32 << 10


def _array_gather(comm, n_coll=2, rows=_ROWS):
    payload = {"m": np.full((rows,), float(comm.part), dtype=np.float64),
               "tag": ("part", comm.part)}
    for _ in range(n_coll):
        vals = comm.allgather(payload)
        assert len(vals) == comm.n_parts
        for j, v in enumerate(vals):
            assert v["tag"] == ("part", j)
            assert (v["m"] == float(j)).all()
    comm.barrier()
    return {"p2p_bytes": comm.p2p_bytes, "raw": comm.raw_coll_bytes,
            "shm": comm.shm_bytes, "fallbacks": comm.p2p_fallbacks}


def _slow_gather(comm, n_coll=60, rows=_ROWS):
    for _ in range(n_coll):
        vals = comm.allgather(np.full((rows,), float(comm.part)))
        assert (vals[-1] == float(comm.n_parts - 1)).all()
        time.sleep(0.02)
    return {"shm": comm.shm_bytes, "fallbacks": comm.p2p_fallbacks}


def _local_sum(comm):
    """A real port communicator per part: its ranks' devices and sizes,
    summed across workers through the cross-process allgather."""
    lc = comm.local_comm
    assert [str(d) for d in comm.torch_devices] == ["cpu"] * lc.size
    assert comm.device_of(0) == torch.device("cpu")
    return sum(comm.allgather(lc.size))


# ---------------------------------------------------------------------------
# end to end, tier-1: against the JAX package's ProcessExecutor
# ---------------------------------------------------------------------------
SMOKE_TASKS = (("b", 2, _echo, {"tag": "b"}), ("a", 1, _echo, {"tag": "a"}),
               ("span", 4, _span_gather, {}))


def _smoke(pkg, **kw):
    with pkg.ProcessExecutor(n_workers=2, devices_per_worker=2,
                             build_comm=False, heartbeat_interval=0.2,
                             **kw) as ex:
        assert ex.devices() == tuple(
            pkg.ProcDevice(f"w{w}", i) for w in range(2) for i in range(2))
        sess = pkg.SchedulerSession(ex, ex.resource_manager(), tick=0.02)
        rep = sess.run([pkg.TaskDescription(name=n, ranks=r, fn=fn,
                                            kwargs=kwargs,
                                            tags={"pipeline": "p"})
                        for n, r, fn, kwargs in SMOKE_TASKS], timeout=120)
    assert all(t.state == pkg.TaskState.DONE for t in rep.tasks)
    tasks = {t.desc.name: t for t in rep.tasks}
    kinds = {n: [e.kind for e in rep.trace if e.task == n] for n in tasks}
    devices = {n: sorted(map(str, t.devices)) for n, t in tasks.items()}
    res = {n: t.result for n, t in tasks.items()}
    # which global ranks a part holds follows the order in which earlier
    # tasks freed their devices, a race: compare the ranks and part sizes
    res["span"] = dict(res["span"], parts=(
        sorted(r for p in res["span"]["parts"] for r in p),
        sorted(len(p) for p in res["span"]["parts"])))
    return res, kinds, devices


@needs_cloudpickle
def test_process_executor_smoke_spanning_task_matches_jax():
    """2 workers x 2 ranks: single-worker tasks plus one 4-rank task whose
    parts allgather and bcast across both worker processes.  The results,
    each task's event kinds and its ``w{i}:{j}`` devices equal the JAX
    ProcessExecutor's for the same task descriptions."""
    res, kinds, devices = _smoke(T, device=CPU)
    assert res["a"][1:3] == (1, 1)
    assert res["b"][1:3] == (2, 2)           # one worker owns both ranks
    span = res["span"]
    assert span["world"] == 4
    assert span["parts"] == ([0, 1, 2, 3], [2, 2])   # one part per worker
    assert span["root"][0] == "from-part0"
    assert kinds["span"] == ["submit", "dispatch", "done"]
    assert (res, kinds, devices) == _smoke(J)


def _ckpt_save(comm):
    comm.checkpoint.save(4, {"x": np.ones(2)})
    return type(comm.checkpoint).__name__, comm.checkpoint.attempt


@needs_cloudpickle
def test_checkpoint_root_fails_part_with_not_implemented(tmp_path):
    """Checkpointing is ported now: a worker binds a CheckpointContext for
    the part, whose save lands under ``t<uid>/p0-of-1/a0``."""
    from repro_torch.train.checkpoint import latest_step
    with T.ProcessExecutor(n_workers=1, devices_per_worker=1,
                           device=CPU) as ex:
        sess = T.SchedulerSession(ex, ex.resource_manager(), tick=0.02,
                                  ckpt_root=str(tmp_path))
        rep = sess.run([T.TaskDescription(name="t", ranks=1, fn=_ckpt_save,
                                          max_retries=0)], timeout=60)
    task = rep.tasks[0]
    assert task.state == T.TaskState.DONE, task.error
    assert task.result == ("CheckpointContext", "a0")
    assert latest_step(tmp_path / f"t{task.uid}" / "p0-of-1" / "a0") == 4


# ---------------------------------------------------------------------------
# end to end, integration: failure injection, elasticity, shm residue
# ---------------------------------------------------------------------------
def _exec(**kw):
    kw.setdefault("devices_per_worker", 1)
    kw.setdefault("build_comm", False)
    kw.setdefault("heartbeat_interval", 0.2)
    kw.setdefault("tick", 0.02)
    return T.ProcessExecutor(device=CPU, **kw)


def _residue(ex) -> list:
    root = Path("/dev/shm")
    if not root.is_dir() or not ex._token:
        return []
    return sorted(p.name for p in root.glob(f"repro_{ex._token[:8]}_*"))


def _wait_no_residue(ex, timeout=6.0):
    deadline = time.monotonic() + timeout
    left = _residue(ex)
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = _residue(ex)
    return left


@needs_cloudpickle
@pytest.mark.integration
def test_worker_sigkill_fails_devices_and_retries_on_survivors():
    with _exec(n_workers=2, devices_per_worker=2) as ex:
        rm = ex.resource_manager()
        sess = T.SchedulerSession(ex, rm, tick=0.02)
        sess.submit([T.TaskDescription(name=f"t{i}", ranks=1, fn=_sleepy,
                                       max_retries=2, tags={"pipeline": "p"})
                     for i in range(6)])
        time.sleep(0.3)
        ex.kill_worker("w0", signal.SIGKILL)
        rep = sess.drain(timeout=120).close()
        assert all(t.state == T.TaskState.DONE for t in rep.tasks)
        fails = rep.events("device_failure")
        assert len(fails) == 1 and fails[0].value == 2.0
        assert len(rep.events("retry")) >= 1
        assert rm.total == 2
        retried = [t for t in rep.tasks if t.retries]
        assert retried and all(
            d.worker == "w0" for t in retried for d in t.excluded_devices)
        assert all(t.result.startswith("w1") for t in retried)


@needs_cloudpickle
@pytest.mark.integration
def test_hung_worker_detected_by_heartbeat_timeout():
    with _exec(n_workers=2, heartbeat_interval=0.15,
               heartbeat_timeout=0.8) as ex:
        rm = ex.resource_manager()
        sess = T.SchedulerSession(ex, rm, tick=0.02)
        sess.submit([T.TaskDescription(name=f"t{i}", ranks=1, fn=_sleepy,
                                       args=(0.5,), max_retries=2,
                                       tags={"pipeline": "p"})
                     for i in range(3)])
        time.sleep(0.2)
        ex.workers["w0"].proc.send_signal(signal.SIGSTOP)
        rep = sess.drain(timeout=120).close()
        assert all(t.state == T.TaskState.DONE for t in rep.tasks)
        assert len(rep.events("device_failure")) == 1
        assert rm.total == 1


@needs_cloudpickle
@pytest.mark.integration
def test_retry_with_exclusion_on_payload_error_via_livescheduler():
    with _exec(n_workers=2) as ex:
        sched = T.LiveScheduler(ex.resource_manager(), executor=ex)
        rep = sched.run([T.TaskDescription(name="f", ranks=1,
                                           fn=_flaky_on_w0, max_retries=2,
                                           tags={"pipeline": "p"})],
                        timeout=120)
        task = rep.tasks[0]
        assert task.state == T.TaskState.DONE
        assert task.result.startswith("w1")
        assert T.ProcDevice("w0", 0) in task.excluded_devices
        assert rep.n_retries == 1


@needs_cloudpickle
@pytest.mark.integration
def test_real_communicator_per_worker_and_cross_process_sum():
    """build_comm=True: each part gets a port Communicator over its
    worker's own CPU ranks, and the spanning task sums across workers."""
    with _exec(n_workers=2, devices_per_worker=2, build_comm=True) as ex:
        sess = T.SchedulerSession(ex, ex.resource_manager(), tick=0.02)
        rep = sess.run([T.TaskDescription(name="local", ranks=2,
                                          fn=_local_sum,
                                          tags={"pipeline": "p"}),
                        T.TaskDescription(name="global", ranks=4,
                                          fn=_local_sum,
                                          tags={"pipeline": "p"})],
                       timeout=120)
        by = {t.desc.name: t for t in rep.tasks}
        assert by["local"].result == 2 and by["global"].result == 4
        assert len(rep.events("comm_build")) == 2


@needs_cloudpickle
@pytest.mark.integration
def test_add_worker_unblocks_pending_within_one_step():
    with _exec(n_workers=1) as ex:
        rm = ex.resource_manager()
        sess = T.SchedulerSession(ex, rm, tick=0.02)
        sess.submit([T.TaskDescription(name="wide", ranks=2, fn=_devs,
                                       tags={"pipeline": "p"})])
        assert not sess.running
        assert ex.add_worker(devices_per_worker=1) == "w1"
        rep = sess.drain(timeout=120).close()
        assert rep.tasks[0].state == T.TaskState.DONE
        assert [(e.kind, e.task) for e in rep.trace
                if e.kind != "telemetry"] == \
            [("submit", "wide"), ("grow", ""), ("dispatch", "wide"),
             ("done", "wide")]
        assert rm.total == 2 and T.ProcDevice("w1", 0) in rm
        assert ex.topology(ex.devices()).n_nodes == 2
        assert [w.device for w in ex.workers.values()] == [CPU, CPU]


@needs_cloudpickle
@pytest.mark.integration
def test_retire_worker_drains_without_losing_results():
    with _exec(n_workers=2) as ex:
        rm = ex.resource_manager()
        sess = T.SchedulerSession(ex, rm, tick=0.02)
        sess.submit([T.TaskDescription(name="span", ranks=2, fn=_slow_span,
                                       tags={"pipeline": "p"})])
        t0 = time.monotonic()
        ex.retire_worker("w1")
        assert time.monotonic() - t0 >= 0.3
        rep = sess.drain(timeout=120).close()
        task = rep.tasks[0]
        assert task.state == T.TaskState.DONE
        assert task.result["parts"] == [0, 1] and task.retries == 0
        assert len(rep.events("retire")) == 1
        assert not rep.events("device_failure") and not rep.events("fail")
        assert rm.total == 1


@needs_cloudpickle
@pytest.mark.integration
def test_immediate_retire_retries_spanning_task_on_survivors():
    with _exec(n_workers=3) as ex:
        rm = ex.resource_manager()
        sess = T.SchedulerSession(ex, rm, tick=0.02)
        sess.submit([T.TaskDescription(name="span", ranks=2, fn=_slow_span,
                                       kwargs={"dur": 1.0}, max_retries=2,
                                       tags={"pipeline": "p"})])
        ex.retire_worker("w1", immediate=True)
        rep = sess.drain(timeout=120).close()
        task = rep.tasks[0]
        assert task.state == T.TaskState.DONE
        assert task.retries >= 1
        assert {d.worker for d in task.devices} == {"w0", "w2"}
        assert task.result["parts"] == [0, 1]
        assert task.result["fallbacks"] == 0
        assert rep.events("retire") and not rep.events("device_failure")
        assert rm.total == 2


@needs_cloudpickle
@needs_dev_shm
@pytest.mark.integration
def test_shm_tier_carries_same_host_payloads_and_leaves_no_residue(
        monkeypatch):
    monkeypatch.setenv("REPRO_SHM", "1")
    with _exec(n_workers=2) as ex:
        assert ex.shm is True
        sess = T.SchedulerSession(ex, ex.resource_manager(), tick=0.02)
        rep = sess.run([T.TaskDescription(name="g", ranks=2,
                                          fn=_array_gather,
                                          kwargs={"n_coll": 3},
                                          tags={"pipeline": "p"})],
                       timeout=120)
        task = rep.tasks[0]
        assert task.state == T.TaskState.DONE, task.error
        assert task.result["shm"] >= 3 * _ROWS * 8
        assert task.result["fallbacks"] == 0
        assert task.shm_bytes == ex.shm_bytes == 2 * task.result["shm"]
        assert _wait_no_residue(ex) == []
    assert _residue(ex) == []


@needs_cloudpickle
@needs_dev_shm
@pytest.mark.integration
def test_sigkill_mid_shm_handoff_recovers_and_reclaims_segments(monkeypatch):
    monkeypatch.setenv("REPRO_SHM", "1")
    with _exec(n_workers=3) as ex:
        rm = ex.resource_manager()
        sess = T.SchedulerSession(ex, rm, tick=0.02)
        sess.submit([T.TaskDescription(name="victim", ranks=2,
                                       fn=_slow_gather, max_retries=2,
                                       tags={"pipeline": "p"})])
        time.sleep(0.5)
        victim = sorted({d.worker for d in
                         next(iter(ex._running.values())).task.devices})[0]
        ex.kill_worker(victim, signal.SIGKILL)
        rep = sess.drain(timeout=120).close()
        task = rep.tasks[0]
        assert task.state == T.TaskState.DONE, task.error
        assert task.retries >= 1
        assert any(d.worker == victim for d in task.excluded_devices)
        assert task.result["shm"] > 0
        assert _wait_no_residue(ex) == []
    assert _residue(ex) == []
    assert all(w.proc.poll() is not None for w in ex.workers.values())
