"""Cylon-style distributed operators as pilot tasks: the dataframe cells.

Set-up makes ``inputs`` table sets on the card from the seed (keys uniform
in the configuration's key range, float32 values), each sharded into
contiguous per-rank blocks padded to the configuration's capacity, and
warms the path up with two tasks (the first builds the ``radix_partition``
kernel with nvcc into the checkout and grows the allocator).

The window is one client's closed loop: it keeps ``ahead`` tasks submitted
to a ``SchedulerSession`` over a ``ThreadExecutor`` whose pool is the
configuration's logical ranks of the card.  Each task gets its private
``Communicator`` from the runtime and runs one distributed operator on all
ranks (``ops_dist.make_dist_join`` or ``make_dist_sort``), inside the
benchmark's payload, which times the call and a synchronise and keeps the
output of the tasks drawn for the comparison.  Task ``i`` reads input set
``i mod inputs``.  The loop stops submitting when the window closes and
waits for what is in flight.

``rows_per_s`` counts the input rows (both sides of a join) of every task
that the session saw done inside the window, over the window's seconds.
"""
from __future__ import annotations

import threading
import time

import torch

from yardstick import counts
from yardstick.devtrace import Spans
from yardstick.traffic import checked_indices, subseed

OPS = ("dist_join", "dist_sort")


class Driver:
    def __init__(self, cell, seed: int, device: torch.device,
                 overrides: dict):
        self.cell = cell
        self.cfg = {**cell.config, **overrides.get("config", {})}
        self.traffic = {**cell.traffic, **overrides.get("traffic", {})}
        if self.traffic["op"] not in OPS:
            raise ValueError(f"unknown operator {self.traffic['op']!r}")
        self.ref = cell.reference()
        self.seed = seed
        self.device = device
        self.spans = Spans()
        self.ops: dict = {}          # index -> record of the payload
        self.tasks: list = []        # (index, Task) of the window
        self.attempted = self.failed = 0
        self._lock = threading.Lock()

    # -- inputs ------------------------------------------------------------
    def _table(self, gen, value_col: str):
        n, kr = self.cfg["rows"], self.cfg["key_range"]
        k = torch.randint(0, kr, (n,), generator=gen, dtype=torch.int32,
                          device=self.device)
        v = torch.randn(n, generator=gen, dtype=torch.float32,
                        device=self.device)
        return {self.cfg["key"]: k, value_col: v}

    def _shard(self, cols: dict):
        """Contiguous per-rank blocks, as ``ops_dist.shard_table`` lays a
        table out, each padded with zeros to the capacity."""
        from repro_torch.dataframe.table import DistTable, Table
        p, cap = self.cfg["ranks"], self.cfg["capacity_per_rank"]
        n = self.cfg["rows"]
        per = [n // p + (1 if r < n % p else 0) for r in range(p)]
        shards, at = [], 0
        for r in range(p):
            c = {}
            for name, v in cols.items():
                buf = torch.zeros(cap, dtype=v.dtype, device=self.device)
                buf[:per[r]] = v[at:at + per[r]]
                c[name] = buf
            shards.append(Table(columns=c, nrows=torch.tensor(
                per[r], dtype=torch.int32, device=self.device)))
            at += per[r]
        return DistTable(shards)

    def setup(self):
        from repro_torch.core.communicator import logical_devices
        from repro_torch.core.pilot import ResourceManager
        from repro_torch.core.scheduler import SchedulerSession
        from repro_torch.core.executors import ThreadExecutor
        from repro_torch.dataframe import ops_dist

        self.inputs = []             # (raw columns, sharded tables)
        for i in range(int(self.traffic["inputs"])):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(subseed(self.seed, "table", i))
            raw = [self._table(gen, "v")]
            if self.traffic["op"] == "dist_join":
                raw.append(self._table(gen, "w"))
            self.inputs.append((raw, [self._shard(c) for c in raw]))

        key, slack = self.cfg["key"], self.cfg["slack"]
        if self.traffic["op"] == "dist_join":
            self._make = lambda comm: ops_dist.make_dist_join(
                comm, key, slack=slack, out_factor=self.cfg["out_factor"])
        else:
            self._make = lambda comm: ops_dist.make_dist_sort(
                comm, key, slack=slack)
        self.rows_per_op = self.cfg["rows"] * len(self.inputs[0][0])
        self.keep = checked_indices(self.traffic, self.seed)

        ranks = logical_devices(self.cfg["ranks"], self.device)
        self.session = SchedulerSession(ThreadExecutor(),
                                        ResourceManager(ranks),
                                        ckpt_root="", result_cache="0")
        for i in range(int(self.traffic.get("warmup", 2))):
            self._submit(-1 - i)
        self.session.drain(timeout=600)
        if any(t.state.name != "DONE" for _, t in self.tasks):
            raise RuntimeError("a warm-up task failed: " + "; ".join(
                str(t.error) for _, t in self.tasks))
        self.tasks.clear()
        self.ops.clear()
        self.spans = Spans()

    # -- the window ----------------------------------------------------------
    def _payload(self, comm, index: int, tables: list):
        t0, t0n = time.perf_counter(), time.time_ns()
        out, ovf = self._make(comm)(*tables)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1, t1n = time.perf_counter(), time.time_ns()
        overflow = bool(ovf)
        self.spans.add(self.traffic["op"], t0n, t1n, index=index)
        with self._lock:
            self.ops[index] = {"start": t0, "end": t1, "overflow": overflow}
        return out if index in self.keep else None

    def _submit(self, index: int):
        from repro_torch.core.task import TaskDescription
        tables = self.inputs[index % len(self.inputs)][1]
        [t] = self.session.submit([TaskDescription(
            name=f"{self.traffic['op']}#{index}", ranks=self.cfg["ranks"],
            fn=self._payload, args=(index, tables), max_retries=0,
            tags={"pipeline": "etl"})])
        self.tasks.append((index, t))

    def run(self, seconds: float, clock):
        ahead = int(self.traffic.get("ahead", 2))
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + seconds
        clock.open(time.time_ns())
        nxt = 0
        for _ in range(ahead):
            self._submit(nxt)
            nxt += 1
        while True:
            clock.tick()
            t0n = time.time_ns()
            done = self.session.wait_any(timeout=60.0)
            self.spans.add("scheduler wait_any", t0n, time.time_ns())
            now = time.perf_counter()
            if now < self.t_end:
                for _ in done:
                    self._submit(nxt)
                    nxt += 1
            elif not self.session.outstanding:
                break
            if not done and not self.session.running and \
                    self.session.outstanding:
                raise RuntimeError("the session is stuck")
        self.attempted = sum(1 for i, t in self.tasks
                             if t.submit_time < self.t_end)
        self.failed = sum(1 for i, t in self.tasks
                          if t.state.name != "DONE"
                          or self.ops.get(i, {}).get("overflow", True))
        self.report = self.session.close()

    def release(self):
        self.kept = {i: t.result for i, t in self.tasks
                     if i in self.keep and t.result is not None}
        for _, t in self.tasks:
            t.result = None
        self.session = None
        self.inputs = [(raw, None) for raw, _ in self.inputs]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------------
    def _program_rows(self, out) -> list:
        names = list(out.shards[0].columns)
        cols = {k: [] for k in names}
        for s in out.shards:
            n = int(s.nrows)
            for k in names:
                cols[k].append(s.columns[k][:n])
        key = self.cfg["key"]
        order = [key] + [k for k in names if k != key]
        return [torch.cat(cols[k]) for k in order]

    def check(self) -> list:
        wrong, wants = 0, {}
        for i in sorted(self.kept):
            slot = i % len(self.inputs)
            raw = self.inputs[slot][0]
            key = self.cfg["key"]
            got = self._program_rows(self.kept[i])
            if self.traffic["op"] == "dist_join":
                if slot not in wants:
                    wants[slot] = self.ref.join(
                        raw[0][key], raw[0]["v"], raw[1][key], raw[1]["w"],
                        self.cfg["key_range"])
                wrong += self.ref.rows_wrong(self.ref.canonical(got),
                                             wants[slot])
            else:
                if slot not in wants:
                    wants[slot] = self.ref.sort(raw[0][key], raw[0]["v"])
                keys, rows = wants[slot]
                wrong += self.ref.rows_wrong([got[0]], [keys])
                wrong += self.ref.rows_wrong(self.ref.canonical(got), rows)
            del got
        self.compared = len(self.kept)
        # the drawn tasks that ran in the window were all compared; a window
        # that ran none of them compared nothing, and that is no pass
        return [("rows_wrong", wrong, 0),
                ("nothing_compared", int(self.compared == 0), 0)]

    # -- metrics ----------------------------------------------------------------
    def end_to_end(self) -> dict:
        rows = sum(self.rows_per_op for i, t in self.tasks
                   if t.state.name == "DONE" and t.end_time <= self.t_end)
        return {"rows_per_s": rows / (self.t_end - self.t0)}

    def context(self) -> dict:
        return {"kind": "dataframe", "cfg": self.cfg, "traffic": self.traffic,
                "t0": self.t0, "t_end": self.t_end,
                "tasks": [t for _, t in self.tasks],
                "index": {t.uid: i for i, t in self.tasks},
                "ops": self.ops, "trace": self.report.trace,
                "spans": self.spans, "counts": counts,
                "valid_rows_per_rank": self.cfg["rows"] / self.cfg["ranks"]}
