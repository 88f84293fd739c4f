"""The reader of the serving engine's decode-graph counter,
``decode_graph_pct.sat``, on hand-built telemetry of ``ServeDriver``: the
window's share of decode rounds that replayed the captured step, and None
where the engine has no such counter or ran no round."""
import types

import pytest

from yardstick.cell import Cell


def _reader():
    return Cell("falcon-mamba-7b.rag_sat").reader("decode_graph_pct.sat")


def _graph_ctx(counters):
    """Telemetry of ServeDriver at the window's edges and inside it, each
    snapshot's counters given as (decode steps, graph replays), or as
    decode steps alone where the engine has no replay counter."""
    def tel(t, c):
        data = {"worker": "serve-driver", "t": t, "serve_decode_steps": c[0]}
        if len(c) > 1:
            data["serve_decode_graph_replays"] = c[1]
        return types.SimpleNamespace(kind="telemetry", t=t, data=data)

    trace = [tel(t, c) for t, c in zip((99.0, 101.0, 150.0, 199.0, 201.0),
                                       counters, strict=True)]
    trace.insert(2, types.SimpleNamespace(
        kind="telemetry", t=120.0,
        data={"worker": "w0", "serve_decode_steps": 10 ** 6,
              "serve_decode_graph_replays": 0}))
    return {"t0": 100.0, "t_end": 200.0, "tasks": [], "trace": trace}


@pytest.mark.parametrize("counters,want", [
    # every round of the window replayed: 40 of 40
    ([(1, 1), (8, 8), (20, 20), (48, 48), (60, 60)], 100.0),
    # 10 of the window's 40 rounds replayed
    ([(0, 0), (8, 2), (20, 5), (48, 12), (60, 99)], 25.0),
    # a counter that first shows inside the window counts from 0
    ([(0,), (8,), (20, 4), (48, 20), (60, 30)], 50.0),
    # an engine without the counter (an eager family, or the parent)
    ([(0,), (8,), (20,), (48,), (60,)], None),
    # no round in the window
    ([(5, 5), (8, 8), (8, 8), (8, 8), (9, 9)], None),
])
def test_decode_graph_share(counters, want):
    assert _reader()(_graph_ctx(counters)) == want


def test_no_telemetry_gives_none():
    assert _reader()({"t0": 0.0, "t_end": 1.0, "tasks": [], "trace": []}) \
        is None
