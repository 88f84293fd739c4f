"""Find a cell's parts by the names in ``BENCHMARK.json`` and run it.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in files of its own, found by name:

* ``perfbench/configs/<config>.json``: the configuration as it is run; its
  ``"driver"`` names ``perfbench/drivers/<driver>.py``, the code that sets
  the program up and drives it, and ``perfbench/configs/<config>.ref.py``
  is its plain reference;
* ``perfbench/traffic/<traffic>.json``: the traffic mix's parameters, read
  by the one generator (``yardstick/traffic.py``);
* ``perfbench/metrics/<metric>.py``: one per-layer metric's reader, a
  function ``read(ctx)`` that returns a number, or None where it finds
  nothing to read (the metric is then left out of the line).

A later cell, configuration or metric is added by adding such files and
entries; no file here needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]          # the checkout
BENCH = ROOT / "perfbench"


def load_module(path: Path, name: str):
    """Import a file by its path (its name may hold dots and dashes)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, mix and
    metrics resolved."""

    def __init__(self, workload: str):
        bench_file = ROOT / "BENCHMARK.json"
        if not bench_file.is_file():
            raise FileNotFoundError(f"{bench_file} is missing")
        self.bench = json.loads(bench_file.read_text())
        self.dir = BENCH
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        cfgs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = cfgs[self.workload["config"]]
        self.config = json.loads((ROOT / self.config_entry["file"])
                                 .read_text())
        self.traffic = json.loads(
            (BENCH / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def reference(self):
        stem = Path(self.config_entry["file"]).name[:-len(".json")]
        return load_module(self.dir / "configs" / f"{stem}.ref.py",
                           f"perfbench_ref_{stem.replace('-', '_')}")

    def driver(self):
        name = self.config["driver"]
        return load_module(self.dir / "drivers" / f"{name}.py",
                           f"perfbench_driver_{name}")

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self) -> list:
        """Per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str):
        mod = load_module(self.dir / "metrics" / f"{metric}.py",
                          "perfbench_metric_" + metric.replace(".", "_")
                          .replace("-", "_"))
        return mod.read
