"""The port's flight recorder inside the program: the recorder's parents,
attributes and clock offset, the thread executor's task spans, the
dataframe operators' stage spans and the serving engine's issue and
readback spans, on the CPU.  Recording must never change a result."""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import (ResourceManager, SchedulerSession,
                              TaskDescription, TaskState, ThreadExecutor,
                              build_communicator, logical_devices)
from repro_torch.dataframe import ops_dist as D
from repro_torch.models import registry
from repro_torch.obs import (NullRecorder, SpanRecorder, align, bound,
                             current_recorder, export_perfetto, load_trace,
                             wall_offset_ns)
from repro_torch.obs.spans import SPAN_KINDS
from repro_torch.serve import ContinuousEngine, Request


def _session(path=None, build_comm=False, devices=("d0",)):
    devs = logical_devices(len(devices), "cpu") if build_comm else devices
    return SchedulerSession(ThreadExecutor(build_comm=build_comm, tick=0.01),
                            ResourceManager(list(devs)), tick=0.01,
                            trace_path=path)


def _nested(comm):
    rec = current_recorder()
    with rec.span("outer", step=1):
        with rec.span("inner"):
            pass
    return 7


# -- the recorder --------------------------------------------------------------
def test_recorder_keeps_parents_and_attributes_in_start_order():
    rec = SpanRecorder()
    with rec.span("a", n=3):
        with rec.span("b"):
            rec.add("c", 1.0, 2.0)
        with rec.span("d", x="y"):
            pass
    rec.add("e", 3.0, 4.0)
    out = rec.export()
    assert [s[0] for s in out] == ["a", "b", "c", "d", "e"]
    assert [s[3] for s in out] == [None, 0, 1, 0, None]
    assert [s[4] for s in out] == [{"n": 3}, {}, {}, {"x": "y"}, {}]
    a, b, _, d, _ = out
    assert a[1] <= b[1] <= b[2] <= d[1] <= d[2] <= a[2]


def test_export_cuts_a_span_still_open():
    rec = SpanRecorder()
    with rec.span("open"):
        (s,) = rec.export()
        assert s[2] is not None and s[2] >= s[1]
    assert rec.spans[0][2] >= s[2]


@pytest.mark.parametrize("raw,parent,attrs", [
    (("compute", 1.0, 2.0), None, {}),
    (("compute", 1.0, 2.0, 3, {"bytes": 8}), 3, {"bytes": 8}),
])
def test_align_takes_old_and_new_tuples(raw, parent, attrs):
    (s,) = align([raw], 0.5, worker="w0", part=1, uid=4, task="t")
    assert s == {"kind": "compute", "t0": 1.5, "t1": 2.5, "parent": parent,
                 "attrs": attrs, "worker": "w0", "part": 1, "uid": 4,
                 "task": "t"}


def test_wall_offset_maps_perf_counter_onto_time_ns():
    t = time.perf_counter()
    wall = time.time_ns()
    assert abs(round(t * 1e9) + wall_offset_ns() - wall) < 1_000_000


def test_nothing_is_recorded_outside_a_bound_recorder():
    rec = current_recorder()
    assert isinstance(rec, NullRecorder)
    assert rec.span("a") is rec.span("b", x=1)      # one shared context
    with rec.span("a"):
        rec.add("b", 0.0, 1.0)
    assert rec.export() == [] and rec.spans == []
    mine = SpanRecorder()
    with bound(mine):
        assert current_recorder() is mine
    assert isinstance(current_recorder(), NullRecorder)


# -- the thread executor ---------------------------------------------------
def test_thread_executor_task_carries_its_spans(tmp_path):
    path = tmp_path / "run.jsonl"
    sess = _session(str(path))
    rep = sess.run([TaskDescription(name="t", ranks=1, fn=_nested,
                                    tags={"pipeline": "p"})], timeout=60)
    (task,) = rep.tasks
    assert task.state is TaskState.DONE and task.result == 7
    kinds = [s["kind"] for s in task.spans]
    assert kinds == ["launch", "compute", "outer", "inner"]
    launch, compute, outer, inner = task.spans
    assert [launch["parent"], compute["parent"]] == [None, None]
    assert outer["parent"] == kinds.index("compute")
    assert inner["parent"] == kinds.index("outer")
    assert outer["attrs"] == {"step": 1}
    for s in task.spans:
        assert (s["worker"], s["part"], s["uid"], s["task"]) == \
            ("thread", 0, task.uid, "t")
        assert s["t0"] <= s["t1"]
    assert launch["t1"] <= compute["t0"] <= outer["t0"]
    assert inner["t1"] <= outer["t1"] <= compute["t1"]
    # the session keeps the very same dicts, and streams them to JSONL
    assert all(a is b for a, b in zip(rep.spans, task.spans, strict=True))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    meta = next(x for x in lines if x["type"] == "meta")
    assert isinstance(meta["wall_offset_ns"], int)
    written = [{k: v for k, v in x.items() if k != "type"}
               for x in lines if x["type"] == "span"]
    assert written == task.spans
    assert load_trace(str(path)).spans == task.spans


def test_thread_executor_records_the_communicator_build():
    rep = _session(build_comm=True, devices=("a", "b")).run(
        [TaskDescription(name="t", ranks=2, fn=lambda c: c.size)],
        timeout=60)
    (task,) = rep.tasks
    assert task.result == 2
    assert [s["kind"] for s in task.spans] == ["launch", "comm_build",
                                              "compute"]
    assert {s["kind"] for s in task.spans} <= set(SPAN_KINDS)
    assert all(s["parent"] is None for s in task.spans)


def test_a_failed_task_ships_its_spans():
    def boom(comm):
        with current_recorder().span("before"):
            pass
        raise ValueError("no")

    rep = _session().run([TaskDescription(name="f", ranks=1, fn=boom,
                                          max_retries=0)], timeout=60)
    (task,) = rep.tasks
    assert task.state is TaskState.FAILED
    assert [s["kind"] for s in task.spans] == ["launch", "compute", "before"]
    assert rep.spans == task.spans


def test_perfetto_shows_a_worker_row_of_thread_spans():
    rep = _session(devices=("d0", "d1")).run(
        [TaskDescription(name=f"t{i}", ranks=1, fn=_nested)
         for i in range(3)], timeout=60)
    ev = export_perfetto(rep)["traceEvents"]
    procs = {e["pid"]: e["args"]["name"] for e in ev if e["ph"] == "M"}
    spans = [e for e in ev if e["ph"] == "X" and e["cat"] == "span"]
    assert {procs[e["pid"]] for e in spans} == {"worker thread"}
    assert sorted(e["name"] for e in spans) == sorted(
        ["launch", "compute", "outer", "inner"] * 3)
    outer = [e for e in spans if e["name"] == "outer"]
    assert all(e["args"]["parent"] == 1 and e["args"]["step"] == 1
               for e in outer)
    assert all("parent" not in e["args"] for e in spans
               if e["name"] in ("launch", "compute"))


# -- the dataframe operators -----------------------------------------------
def _tables(comm, n=600):
    rng = np.random.default_rng(3)
    a = {"k": rng.integers(0, 150, n).astype(np.int32),
         "v": rng.normal(size=n).astype(np.float32)}
    b = {"k": rng.integers(0, 150, n).astype(np.int32),
         "w": rng.normal(size=n).astype(np.float32)}
    return D.shard_table(comm, a, 200), D.shard_table(comm, b, 200)


def _op(name, comm):
    return {"join": lambda a, b: D.make_dist_join(comm, "k",
                                                  out_factor=8.0)(a, b),
            "sort": lambda a, b: D.make_dist_sort(comm, "k")(a),
            "groupby": lambda a, b: D.make_dist_groupby_sum(
                comm, "k", ["v"])(a)}[name]


SHUFFLE = ["df.pack", "df.exchange", "df.compact"]
STAGES = {
    "join": ["df.target"] + SHUFFLE + ["df.target"] + SHUFFLE
    + ["df.join_inner", "df.exchange"],
    "sort": ["df.local_sort", "df.target"] + SHUFFLE + ["df.local_sort"],
    "groupby": ["df.target"] + SHUFFLE,
}


@pytest.mark.parametrize("op", ["join", "sort", "groupby"])
def test_dist_ops_record_their_stages(op):
    P, cap, slack = 4, 200, 2.0
    comm = build_communicator(logical_devices(P, "cpu"))
    a, b = _tables(comm)
    plain, plain_ovf = _op(op, comm)(a, b)
    rec = SpanRecorder()
    with bound(rec), rec.span("op"):
        out, ovf = _op(op, comm)(a, b)
    got = align(rec.export(), 0.0)
    assert [s["kind"] for s in got] == ["op"] + STAGES[op]
    assert all(s["parent"] == 0 for s in got[1:])
    assert {s["kind"] for s in got[1:]} <= set(SPAN_KINDS)
    assert all(x["t1"] <= y["t0"] for x, y in zip(got[1:], got[2:]))
    # the bytes each exchange's input buffers hold, from the shapes: P
    # ranks' (P, send_cap) blocks of every column, their (P, 1) int32
    # counts and one int32 overflow flag each; the join's last exchange is
    # its overflow flags alone
    send_cap = int(cap * slack) // P + 8
    row = 4 + 4                                  # int32 key, float32 value
    shuffle = P * P * send_cap * row + P * P * 4 + P * 4
    want = [shuffle] * (2 if op == "join" else 1)
    want += [P * 4] if op == "join" else []
    assert [s["attrs"]["bytes"] for s in got
            if s["kind"] == "df.exchange"] == want
    assert bool(ovf) == bool(plain_ovf) is False
    for x, y in zip(plain.shards, out.shards, strict=True):
        assert torch.equal(x.nrows, y.nrows)
        for k in x.columns:
            assert torch.equal(x.columns[k], y.columns[k]), k


# -- the serving engine ----------------------------------------------------
@pytest.fixture(scope="module")
def tiny_lm():
    cfg = dataclasses.replace(reduced(get_config("qwen3-8b")), n_layers=2)
    gen = torch.Generator().manual_seed(0)
    return cfg, registry.get_model(cfg).init(gen, cfg)


def _serve(cfg, model, rec=None):
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m, uid=10 + i)
            for i, (n, m) in enumerate([(3, 4), (5, 2), (2, 5), (4, 1)])]
    eng = ContinuousEngine(cfg, model, max_batch=2, max_seq=32)
    waits = []
    insert = eng.insert

    def spy(adm):
        before = eng.metrics.get("serve_admit_wait_us")
        slot = insert(adm)
        waits.append(eng.metrics.get("serve_admit_wait_us") - before)
        return slot

    eng.insert = spy
    if rec is None:
        return eng.run(reqs), waits, eng
    with bound(rec):
        return eng.run(reqs), waits, eng


def test_engine_records_issue_and_readback(tiny_lm):
    cfg, model = tiny_lm
    plain, _, _ = _serve(cfg, model)
    rec = SpanRecorder()
    out, waits, eng = _serve(cfg, model, rec)
    assert out.keys() == plain.keys()
    for uid in plain:
        np.testing.assert_array_equal(out[uid], plain[uid])
    spans = align(rec.export(), 0.0)
    pre = [s for s in spans if s["kind"].startswith("prefill")]
    assert [s["kind"] for s in pre] == ["prefill_issue", "prefill_sync"] * 4
    assert [s["attrs"]["req"] for s in pre] == [10, 10, 11, 11, 12, 12,
                                                13, 13]
    dec = [s for s in spans if s["kind"].startswith("decode")]
    assert dec and len(dec) == 2 * eng.metrics.get("serve_decode_steps")
    for issue, sync in zip(dec[::2], dec[1::2], strict=True):
        assert (issue["kind"], sync["kind"]) == ("decode_issue",
                                                 "decode_sync")
        assert issue["parent"] is None and sync["parent"] is None
        assert issue["t1"] <= sync["t0"]
        assert issue["attrs"] == sync["attrs"]
        assert 1 <= issue["attrs"]["slots"] <= 2
    assert {s["kind"] for s in spans} <= set(SPAN_KINDS)
    assert len(waits) == 4 and all(w >= 0 for w in waits)
    assert eng.metrics.get("serve_admitted") == 4
