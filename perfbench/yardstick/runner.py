"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, and the result line.

A driver (``perfbench/drivers/<name>.py``) exposes ``Driver(cell, seed,
device, overrides)`` with:

* ``setup()``: make the inputs and weights from the seed, build the
  program's objects, warm up the shapes the cell's traffic uses;
* ``run(seconds, clock)``: the measured window; it calls
  ``clock.open(t0_ns)`` as the window opens (``time.time_ns``) and
  ``clock.tick()`` at each turn of its driving loop, on which the traced
  sub-window's profiler starts (``devtrace.DeviceWindow``);
* ``release()``: free the program's state once the peak memory is read;
* ``check()``: a list of ``(name, value, limit)``; a run is correct when
  every value is at most its limit and nothing failed;
* ``end_to_end()``: the end-to-end metrics of the window, by name;
* ``context()``: what the per-layer readers read (``metrics/*.py``);
* ``attempted`` and ``failed``: work offered in the window, and work that
  failed or never came back.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from yardstick.cell import Cell
from yardstick.devtrace import DeviceWindow

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_START_S, TRACE_MAX_S = 4.0, 10.0   # traced sub-window: from 4 s (at
# most a quarter of the window) in, for half of the window at most 10 s


class NoTrace:
    """The window's clock hooks of an untraced run."""

    def open(self, t0_ns: int):
        pass

    def tick(self):
        pass


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def device_record(device: torch.device, peak: int) -> dict:
    rec = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        rec["power_limit_w"] = _power_limit()
    return rec


def _power_limit():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_process: float, device: str = "cuda",
             overrides: dict | None = None, cell: Cell | None = None) -> dict:
    """Run one cell and return the result line's object (``checks`` last).
    ``t_process`` is ``time.perf_counter()`` at the process's start."""
    cell = cell or Cell(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    drv = cell.driver().Driver(cell, seed, dev, overrides or {})
    devwin = None
    if trace and dev.type == "cuda":
        devwin = DeviceWindow(min(TRACE_START_S, 0.25 * seconds),
                              min(0.5 * seconds, TRACE_MAX_S))
    drv.setup()
    setup_s = time.perf_counter() - t_process
    if devwin is not None:
        devwin.prepare()
    phases = {"setup": setup_s}
    mark = time.perf_counter()
    drv.run(seconds, devwin or NoTrace())
    if devwin is not None:
        devwin.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        peak = 0
    drv.release()
    phases["window_and_drain"] = time.perf_counter() - mark
    mark = time.perf_counter()
    checks = drv.check()
    phases["check"] = time.perf_counter() - mark

    metrics = {}
    if not trace:
        values = drv.end_to_end()
        values["setup_s"] = setup_s
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = drv.context()
        ctx["device_window"] = devwin if devwin is not None and devwin.ok \
            else None
        for m in cell.per_layer():
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    device_rec = device_record(dev, peak)
    out = {"correct": (drv.failed == 0 and all(v <= lim for _, v, lim
                                                in checks)),
           "attempted": drv.attempted, "failed": drv.failed,
           "metrics": metrics, "device": device_rec}
    if trace:
        if devwin is not None and devwin.ok:
            device_rec["busy_s"] = devwin.busy_s
            device_rec["window_s"] = devwin.window_s
            out["breakdown"] = {"device_ops": devwin.top_ops(10),
                                "idle_gaps": devwin.idle_gaps(
                                    drv.context()["spans"], 10)}
        elif devwin is not None:
            device_rec["trace_error"] = devwin.error or "empty trace"
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for name, s in phases.items():
        print(f"phase {name} {s:.3f} s", file=sys.stderr, flush=True)
    return out


def print_result(out: dict):
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


def emit(rec: dict, path: str | None = None):
    """A measurement tool's line: printed, and appended to ``path``."""
    line = json.dumps(rec)
    print(line, flush=True)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")
