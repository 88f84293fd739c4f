"""The harness finds every cell's parts by the names in BENCHMARK.json, and
a cell, a configuration, a mix and a metric can be added by files alone."""
import json
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

from yardstick.cell import Cell


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_resolves_by_name():
    b = _bench()
    for w in b["workloads"]:
        cell = Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["kind"] in ("ops", "requests")
        assert hasattr(cell.driver(), "Driver")
        assert cell.reference() is not None
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = cell.per_layer()
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e
            assert callable(cell.reader(m["name"]))


def test_every_file_is_named_from_benchmark_json():
    b = _bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        stem = c["file"].rsplit("/", 1)[1][:-len(".json")]
        assert stem == c["name"]
        assert (BENCH / "configs" / f"{stem}.ref.py").is_file()
    for w in b["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_a_cell_added_by_files_alone(tmp_path):
    """A copy of the checkout gains a configuration, a mix, a metric and a
    cell by new files and entries only, and runs it on the CPU."""
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = _bench()
    cfg = json.loads((BENCH / "configs" / "cylon35m.json").read_text())
    cfg.update({"name": "cylon_small", "rows": 4000,
                "capacity_per_rank": 2064, "key_range": 4000})
    (tmp_path / "perfbench/configs/cylon_small.json").write_text(
        json.dumps(cfg))
    shutil.copy(BENCH / "configs/cylon35m.ref.py",
                tmp_path / "perfbench/configs/cylon_small.ref.py")
    (tmp_path / "perfbench/traffic/join_one_ahead.json").write_text(
        json.dumps({"kind": "ops", "op": "dist_join", "loop": "closed",
                    "clients": 1, "ahead": 1, "inputs": 1, "warmup": 1,
                    "checked": 2, "checked_among": 4}))
    (tmp_path / "perfbench/metrics/ops_done.py").write_text(
        "def read(ctx):\n"
        "    return float(sum(1 for t in ctx['tasks']\n"
        "                     if t.end_time <= ctx['t_end']))\n")
    b["configs"].append({"name": "cylon_small", "source": "https://arxiv.org/abs/2403.15721",
                         "file": "perfbench/configs/cylon_small.json",
                         "reduced": ["rows"], "why": "a test"})
    b["workloads"].append({"name": "cylon_small.join_one_ahead",
                           "config": "cylon_small",
                           "traffic": "join_one_ahead", "chips": 1,
                           "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "rows_per_s":
            m["workloads"].append("cylon_small.join_one_ahead")
    b["per_layer"].append({"name": "ops_done", "unit": "ops",
                           "better": "higher", "source": "host_clock",
                           "layer": "runtime", "moves": "rows_per_s",
                           "workloads": ["cylon_small.join_one_ahead"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(tmp_path / 'perfbench')!r}, "
        f"{str(ROOT / 'src')!r}]\n"
        "from yardstick.runner import run_cell\n"
        "t = time.perf_counter()\n"
        "out = {}\n"
        "for trace in (0, 1):\n"
        "    out[trace] = run_cell('cylon_small.join_one_ahead', 9, 1.0, "
        "bool(trace), t, device='cpu')\n"
        "print(json.dumps(out))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["0"]["correct"] and out["1"]["correct"]
    assert set(out["0"]["metrics"]) == {"rows_per_s", "setup_s"}
    assert out["1"]["metrics"]["ops_done"]["value"] > 0
