"""The readers of the program's own spans and counters, each on a hand-built
context: tasks that carry spans, telemetry TraceEvents, and a device window
with known intervals.  Each gives its exact value, and None where it finds
nothing to read (a program whose tasks carry no spans, as before the
recorder ran in the thread executor)."""
import types

import pytest

from yardstick.cell import Cell
from yardstick.devtrace import DeviceWindow

NS = 1_000_000_000


def _reader(name):
    cell = "falcon-mamba-7b.rag_sat" if name.endswith(".sat") \
        else "cylon35m.sort"
    return Cell(cell).reader(name)


def _span(kind, t0, t1, uid):
    return {"kind": kind, "t0": t0, "t1": t1, "parent": None, "attrs": {},
            "worker": "thread", "part": 0, "uid": uid, "task": ""}


def _task(name, uid, start, end, spans, state="DONE"):
    return types.SimpleNamespace(
        desc=types.SimpleNamespace(name=name), uid=uid, start_time=start,
        end_time=end, state=types.SimpleNamespace(name=state),
        spans=[_span(k, a, b, uid) for k, a, b in spans])


def _window(kernels, lo, hi):
    w = DeviceWindow(0.0, hi - lo)
    w.t0_ns, w.t1_ns = int(lo * NS), int(hi * NS)
    w.kernels = [("k", int(s * NS), int(e * NS)) for s, e in kernels]
    return w


@pytest.fixture
def offset_zero(monkeypatch):
    import repro_torch.obs.spans as spans
    monkeypatch.setattr(spans, "wall_offset_ns", lambda: 0)


def _df_ctx(with_window=True):
    tasks = [
        _task("dist_sort#-1", 0, 99.0, 99.5, [("compute", 99.0, 99.5)]),
        _task("dist_sort#0", 1, 100.875, 101.5,
              [("launch", 100.875, 101.0), ("compute", 101.0, 101.5),
               ("df.pack", 101.25, 101.5)]),
        _task("dist_sort#1", 2, 101.5, 102.0,
              [("compute", 101.625, 102.0), ("df.exchange", 101.75, 101.875)]),
        _task("dist_sort#2", 3, 102.0, 103.0,
              [("compute", 102.375, 103.0), ("df.local_sort", 102.5, 102.75)]),
        _task("dist_sort#3", 4, 102.5, 104.0, [("compute", 103.0, 104.0)],
              state="FAILED"),
    ]
    ctx = {"t0": 100.0, "t_end": 200.0, "tasks": tasks}
    if with_window:
        # idle: [101.25, 101.375], [101.5, 102.0], [102.25, 103.0]: 1.375 s
        ctx["device_window"] = _window(
            [(101.0, 101.25), (101.375, 101.5), (102.0, 102.25)], 101.0,
            103.0)
    return ctx


def test_handoff_between_consecutive_compute_spans():
    # (101.625 - 101.5) and (102.375 - 102.0): 0.125 and 0.375 s
    assert _reader("handoff_ms.df")(_df_ctx(False)) == 250.0


def test_idle_between_tasks_and_in_stages(offset_zero):
    ctx = _df_ctx()
    # idle with no compute span open: [101.5, 101.625], [102.25, 102.375]
    assert _reader("idle_between_tasks_pct.df")(ctx) == 12.5
    # idle under a stage: 0.125 (pack) + 0.125 (exchange) + 0.25 (sort)
    assert _reader("idle_in_stages_pct.df")(ctx) == 25.0
    assert _reader("idle_pct.df")(ctx) == 68.75


def test_idle_readers_put_spans_on_the_device_clock(monkeypatch):
    import repro_torch.obs.spans as spans
    monkeypatch.setattr(spans, "wall_offset_ns", lambda: 5 * NS)
    ctx = _df_ctx()
    w = ctx["device_window"]
    w.t0_ns += 5 * NS
    w.t1_ns += 5 * NS
    w.kernels = [(n, s + 5 * NS, e + 5 * NS) for n, s, e in w.kernels]
    assert _reader("idle_between_tasks_pct.df")(ctx) == 12.5
    assert _reader("idle_in_stages_pct.df")(ctx) == 25.0


def _sat_ctx():
    tasks = [
        _task("serve-decode#1", 1, 100.0, 102.0,
              [("launch", 100.0, 100.125), ("compute", 100.125, 102.0),
               ("decode_issue", 100.25, 100.5), ("decode_sync", 100.5, 100.625),
               ("decode_issue", 100.75, 101.25),
               ("decode_sync", 101.25, 101.625)]),
        _task("serve-prefill#2", 2, 100.0, 103.0,
              [("compute", 100.0, 103.0),
               ("prefill_issue", 100.0, 100.5), ("prefill_sync", 100.5, 101.0),
               ("prefill_issue", 101.0, 102.0), ("prefill_sync", 102.0, 103.0)]),
        _task("serve-decode#0", 0, 98.0, 99.0,
              [("decode_issue", 98.0, 99.0)]),
    ]

    def tel(t, worker="serve-driver", **counters):
        return types.SimpleNamespace(kind="telemetry", t=t,
                                     data={"worker": worker, "t": t,
                                           **counters})

    trace = [
        tel(99.0, serve_admitted=1, serve_admit_wait_us=5_000),
        tel(101.0, serve_admitted=4, serve_admit_wait_us=10_000),
        types.SimpleNamespace(kind="dispatch", t=120.0, data={}),
        tel(130.0, worker="w0", serve_admitted=99),
        tel(150.0, serve_admitted=8, serve_admit_wait_us=30_000),
        tel(199.0, serve_admitted=12, serve_admit_wait_us=50_000),
        tel(201.0, serve_admitted=20, serve_admit_wait_us=90_000),
    ]
    return {"t0": 100.0, "t_end": 200.0, "tasks": tasks, "trace": trace}


@pytest.mark.parametrize("name,want", [
    ("decode_issue_ms.sat", 375.0),      # 0.25 and 0.5 s
    ("decode_sync_ms.sat", 250.0),       # 0.125 and 0.375 s
    ("prefill_issue_ms.sat", 750.0),     # 0.5 and 1.0 s
    ("admit_wait_ms.sat", 5.0),          # 40 000 us over 8 admissions
])
def test_serving_readers(name, want):
    assert _reader(name)(_sat_ctx()) == want


NEW = ["handoff_ms.df", "idle_between_tasks_pct.df", "idle_in_stages_pct.df",
       "decode_issue_ms.sat", "decode_sync_ms.sat", "prefill_issue_ms.sat",
       "admit_wait_ms.sat"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name, offset_zero):
    ctx = _sat_ctx() if name.endswith(".sat") else _df_ctx()
    for t in ctx["tasks"]:
        del t.spans                     # tasks of a program without spans
    for e in ctx["trace"] if "trace" in ctx else ():
        e.data.pop("serve_admit_wait_us", None)
    assert _reader(name)(ctx) is None
    ctx["tasks"] = []
    ctx["trace"] = []
    assert _reader(name)(ctx) is None


@pytest.mark.parametrize("name", ["idle_between_tasks_pct.df",
                                  "idle_in_stages_pct.df"])
def test_idle_readers_need_the_window_and_the_offset(name, monkeypatch):
    assert _reader(name)(_df_ctx(with_window=False)) is None
    import repro_torch.obs.spans as spans
    monkeypatch.delattr(spans, "wall_offset_ns")   # a program without it
    assert _reader(name)(_df_ctx()) is None


@pytest.mark.parametrize("workload,want", [
    ("cylon35m.sort", {"handoff_ms.df"}),
    ("falcon-mamba-7b.rag_sat", {"decode_issue_ms.sat", "decode_sync_ms.sat",
                                 "prefill_issue_ms.sat",
                                 "admit_wait_ms.sat"}),
])
def test_a_traced_run_reads_the_program(workload, want):
    """A traced run of the program at the CPU's size: the readers that need
    no device trace find the program's spans and counter."""
    import time

    from conftest import tiny
    from yardstick import runner
    out = runner.run_cell(workload, 2 ** 33 + 11, 3.0, True,
                          time.perf_counter(), device="cpu",
                          overrides=tiny(workload))
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert want <= set(got) and all(got[k] >= 0 for k in want)
