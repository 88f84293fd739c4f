"""The shape of a run's last lines, and the guards a run keeps: no JAX or
JAX package in the process (by whole top-level name), no result without the
card, no result from a directory that holds only the benchmark."""
import io
import json
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from conftest import BENCH, ROOT, tiny

from yardstick import runner

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(workload, trace, overrides=None):
    import time
    out = runner.run_cell(workload, 2 ** 33 + 7, 1.5, trace,
                          time.perf_counter(), device="cpu",
                          overrides=overrides or tiny(workload))
    so, se = io.StringIO(), io.StringIO()
    with redirect_stdout(so), redirect_stderr(se):
        runner.print_result(out)
    return out, so.getvalue(), se.getvalue()


@pytest.mark.parametrize("workload", ["cylon35m.sort",
                                      "falcon-mamba-7b.rag_sat"])
def test_last_lines(workload):
    from yardstick.cell import Cell
    cell = Cell(workload)
    out, so, se = _run(workload, False)
    line = json.loads(so.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end()}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    tail = se.strip().splitlines()[-len(line["checks"]):]
    for name, row in zip(line["checks"], tail, strict=True):
        assert re.match(rf"check {re.escape(name)} = .* limit .* ok$", row)


def test_traced_line_reads_per_layer_metrics():
    from yardstick.cell import Cell
    workload = "falcon-mamba-7b.rag_sat"
    out, so, _ = _run(workload, True)
    line = json.loads(so.strip().splitlines()[-1])
    allowed = {m["name"] for m in Cell(workload).per_layer()}
    # on the CPU the device readers find nothing and are left out
    assert set(line["metrics"]) <= allowed
    assert {"decode_round_ms.sat", "mfu.sat"} <= set(line["metrics"])


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jaxtyping",
                 "reprolib"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert runner.forbidden_modules() == []
    for name in ("repro", "repro.core", "jax.numpy", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert runner.forbidden_modules() == sorted(
        ["repro", "repro.core", "jax.numpy", "jaxlib", "flax"])


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|repro)(?:\.|\s|$)", re.M)


def test_no_benchmark_file_imports_jax_or_reads_the_jax_benchmarks():
    files = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 20
    for p in files:
        text = p.read_text()
        assert not _IMPORT.search(text), p
        if p.parent.name != "tests":
            assert "benchmarks/" not in text, p


def test_the_harness_imports_without_jax():
    code = ("import sys\n"
            f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]\n"
            "import yardstick.runner, yardstick.cell\n"
            "from yardstick.cell import Cell\n"
            "for w in ('cylon35m.join', 'falcon-mamba-7b.rag_sat'):\n"
            "    Cell(w).driver(); Cell(w).reference()\n"
            "import repro_torch.serve.driver, repro_torch.dataframe.ops_dist\n"
            "bad = yardstick.runner.forbidden_modules()\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_no_result_without_the_card_or_the_program(tmp_path):
    cmd = [sys.executable, "perfbench/run.py", "--workload",
           "cylon35m.join", "--seed", "1", "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    import torch
    if not torch.cuda.is_available():
        assert p.returncode != 0 and p.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
