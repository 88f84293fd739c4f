"""The port's Perfetto export against the JAX package's: twins of the
perfetto tests of ``tests/test_flight_recorder.py``, and both exporters on
the same recorded traces giving the same document."""
import json

import pytest

from repro.obs import export_perfetto as jax_export_perfetto
from repro.obs import load_trace as jax_load_trace

from repro_torch.core import (ResourceManager, SchedulerSession, SimOptions,
                              TaskDescription, ThreadExecutor,
                              VirtualClockExecutor)
from repro_torch.obs import align, export_perfetto, load_trace


def _sim_session(trace_path=None, n_devices=4):
    return SchedulerSession(
        VirtualClockExecutor(SimOptions(noise=0.0,
                                        overhead_model=lambda r: 0.0)),
        ResourceManager(list(range(n_devices))), trace_path=trace_path)


def _sim_descs(n=6):
    return [TaskDescription(name=f"t{i}", ranks=1 + i % 2, fn=None,
                            duration_model=lambda r: 0.2,
                            tags={"pipeline": "p"})
            for i in range(n)]


def _fake_spans():
    return (align([("launch_recv", 0.00, 0.01), ("deserialize", 0.01, 0.02),
                   ("compute", 0.02, 0.30), ("p2p_recv", 0.05, 0.12)],
                  0.0, worker="w0", part=0, uid=0, task="t0")
            + align([("compute", 0.02, 0.25), ("spill_write", 0.10, 0.15)],
                    0.0, worker="w1", part=1, uid=0, task="t0"))


def _recorded(tmp_path):
    _sim_session(str(tmp_path / "p.jsonl")).run(_sim_descs(4))
    rec = load_trace(str(tmp_path / "p.jsonl"))
    rec.spans.extend(_fake_spans())
    rec.telemetry.append({"worker": "w0", "t": 0.1, "queue_depth": 2,
                          "rss_mb": 17.5, "label": "not-a-number"})
    return rec


def test_perfetto_export_shape(tmp_path):
    rec = _recorded(tmp_path)
    out = tmp_path / "p.trace.json"
    doc = export_perfetto(rec, str(out))
    assert json.loads(out.read_text()) == doc
    ev = doc["traceEvents"]
    procs = {e["args"]["name"] for e in ev if e["ph"] == "M"}
    assert {"scheduler", "worker w0", "worker w1"} <= procs
    tasks = [e for e in ev if e["ph"] == "X" and e["cat"] == "task"]
    assert len(tasks) == 4 and all(e["dur"] > 0 for e in tasks)
    spans = [e for e in ev if e["ph"] == "X" and e["cat"] == "span"]
    assert {e["name"] for e in spans} == {"launch_recv", "deserialize",
                                          "compute", "p2p_recv",
                                          "spill_write"}
    counters = {e["name"] for e in ev if e["ph"] == "C"}
    assert counters == {"queue_depth", "rss_mb"}   # strings are skipped
    assert all(e["ts"] >= 0 for e in ev if "ts" in e)


def test_perfetto_cli_default_output(tmp_path, capsys):
    from repro_torch.obs.perfetto import main
    path = tmp_path / "run.jsonl"
    _sim_session(str(path)).run(_sim_descs(2))
    main([str(path)])
    out = tmp_path / "run.trace.json"
    assert out.exists()
    assert "traceEvents" in json.loads(out.read_text())
    assert str(out) in capsys.readouterr().out


@pytest.mark.parametrize("with_spans", [False, True])
def test_perfetto_documents_equal_the_jax_exporters(tmp_path, with_spans):
    """One recorded trace (the port's scheduler, virtual clock), read by
    each package's loader and exported by each package's exporter."""
    path = tmp_path / "p.jsonl"
    _sim_session(str(path)).run(_sim_descs(5))
    port, ref = load_trace(str(path)), jax_load_trace(str(path))
    if with_spans:
        for rec in (port, ref):
            rec.spans.extend(_fake_spans())
            rec.telemetry.append({"worker": "w1", "t": 0.2,
                                  "queue_depth": 1, "p2p_fallbacks": 0})
    assert export_perfetto(port) == jax_export_perfetto(ref)


def test_perfetto_exports_a_live_thread_session(tmp_path):
    """A live session on the thread executor: the report itself exports,
    with one scheduler slice per task."""
    path = tmp_path / "live.jsonl"
    sess = SchedulerSession(ThreadExecutor(build_comm=False, tick=0.01),
                            ResourceManager(["d0", "d1"]), tick=0.01,
                            trace_path=str(path))
    rep = sess.run([TaskDescription(name=f"t{i}", ranks=1, fn=lambda c: 1,
                                    tags={"pipeline": "p"})
                    for i in range(3)], timeout=60)
    for doc in (export_perfetto(rep), export_perfetto(load_trace(str(path)))):
        tasks = [e for e in doc["traceEvents"]
                 if e["ph"] == "X" and e["cat"] == "task"]
        assert len(tasks) == 3
