"""The controls: the reference put in the program's place one precision
below what the configuration states must fail the comparison.  On the CPU at
a tiny size the serving control must read well above the program; at the
cell's size on the card (``cuda``) above the configuration's limit."""
import json

import pytest
import torch

from conftest import BENCH, tiny

from yardstick.cell import Cell
from yardstick.runner import NoTrace


def _served(workload, device, overrides, seconds):
    cell = Cell(workload)
    drv = cell.driver().Driver(cell, 31, device, overrides)
    drv.setup()
    drv.run(seconds, NoTrace())
    drv.release()
    uids = drv.sample()
    prompts = [drv.req[u]["prompt"] for u in uids]
    served = [drv.results[u] for u in uids]
    prog = max(float(g.max()) for g in drv.ref.served_gaps(
        drv.weights, drv.cfg, prompts, served))
    ctrl = max(float(g.max()) for g in drv.ref.served_gaps(
        drv.weights, drv.cfg, prompts, served, quant="fp8"))
    return prog, ctrl, drv.cfg["check"]["logit_gap_limit"]


def test_serving_control_departs_from_the_reference_on_the_cpu():
    """At a tiny size the float8 control already puts other tokens first
    than the float32 reference at some positions of fixed prompts."""
    cell = Cell("falcon-mamba-7b.rag_sat")
    ref = cell.reference()
    cfg = dict(cell.config, **tiny("falcon-mamba-7b.rag_sat")["config"])
    w = ref.make_weights(cfg, 3, torch.device("cpu"))
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg["vocab_size"], (64,), generator=g)
               for _ in range(16)]
    served = [torch.randint(0, cfg["vocab_size"], (12,), generator=g)
              for _ in range(16)]
    ctrl = ref.served_gaps(w, cfg, prompts, served, quant="fp8")
    assert max(float(c.max()) for c in ctrl) > 0
    assert all(float(c.min()) >= 0 for c in ctrl)


@pytest.mark.cuda
def test_serving_control_fails_the_limit_at_the_cells_size(cuda_device):
    prog, ctrl, limit = _served("falcon-mamba-7b.rag_sat", cuda_device, {},
                                10.0)
    assert prog <= limit < ctrl


@pytest.mark.parametrize("op", ["join", "sort"])
def test_dataframe_control_fails_the_exact_comparison(op):
    cell = Cell(f"cylon35m.{op}")
    ref = cell.reference()
    cfg = dict(json.loads((BENCH / "configs/cylon35m.json").read_text()),
               **tiny("cylon35m")["config"])
    g = torch.Generator().manual_seed(5)
    k = torch.randint(0, cfg["key_range"], (cfg["rows"],), generator=g,
                      dtype=torch.int32)
    v = torch.randn(cfg["rows"], generator=g)
    w = torch.randn(cfg["rows"], generator=g)
    want = ref.join(k, v, k.flip(0), w, cfg["key_range"]) if op == "join" \
        else ref.sort(k, v)[1]
    assert ref.rows_wrong(want, want) == 0
    assert ref.rows_wrong(ref.control(want), want) > 0.9 * len(want[0])


def test_the_exact_comparison_sees_one_row():
    ref = Cell("cylon35m.join").reference()
    k = torch.arange(10, dtype=torch.int32)
    v = torch.arange(10, dtype=torch.float32)
    rows = ref.canonical([k, v])
    other = [rows[0].clone(), rows[1].clone()]
    other[1][3] = torch.tensor(-0.0) if other[1][3] == 0 else \
        other[1][3].nextafter(torch.tensor(1e9))
    assert ref.rows_wrong(rows, other) == 1
    assert ref.rows_wrong(rows, [r[:-1] for r in rows]) == 1
