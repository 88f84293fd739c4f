"""Deterministic event-heap executor — the paper's large-scale simulation
mode (84–2688 ranks in milliseconds)."""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Callable, Optional, Sequence

from repro_torch.core.executors.base import ExecEvent, Executor
from repro_torch.core.task import Task


# ---------------------------------------------------------------------------
# calibrated models (defaults measured on this container; see
# benchmarks/bench_overhead.py which re-measures and can override)
# ---------------------------------------------------------------------------
def default_overhead_model(ranks: int) -> float:
    """Communicator-construction + task-description overhead (seconds).
    The paper's Table 2 reports 2.3-3.5 s, roughly flat in ranks; our
    communicator build is milliseconds, so the sim uses the paper-calibrated
    constants to reproduce Table 2, while bench_overhead.py reports our own
    measured numbers."""
    return 2.8 + 0.0012 * ranks


@dataclasses.dataclass
class SimOptions:
    policy: str = "heterogeneous"
    overhead_model: Callable[[int], float] = default_overhead_model
    noise: float = 0.02                  # lognormal sigma on durations
    seed: int = 0
    straggler_prob: float = 0.0          # chance a task runs slow
    straggler_slowdown: float = 3.0
    speculative_factor: Optional[float] = None   # e.g. 1.5 -> spec-exec on
    failure_prob: float = 0.0            # chance a task attempt fails
    device_failures: Sequence[tuple] = ()  # [(time_s, n_devices), ...]
    grow_at: Sequence[tuple] = ()        # [(time_s, n_devices), ...]: elastic
    # grow — the core invents fresh handles and backfills pending work, so
    # elastic scenarios (paper: pilot resize mid-run) replay deterministically
    retire_at: Sequence[tuple] = ()      # [(time_s, n_devices), ...]: graceful
    # shrink — up to n free devices leave the pool (busy ones stay with
    # their tasks; the executor-level analogue is ProcessExecutor.retire_worker)
    placement: str = "spread"            # pack|spread (see core/placement.py)
    work_stealing: bool = False          # BATCH: lease idle partition devices
    devices_per_node: int = 0            # synthetic topology: devices per
    # simulated node (0 -> the whole pool is one node, topology-blind)
    ckpt_period_s: float = 0.0           # model payloads checkpointing every
    # N virtual seconds: a failed attempt banks its durable progress
    # (floored to whole periods) and the retry runs only the remainder,
    # reporting resumed_from_step — the sim analogue of CheckpointContext.
    # Takes effect only for tasks launched with a checkpoint namespace
    # (session ckpt_root/REPRO_CKPT_DIR), mirroring the live backends.
    # 0 -> retries re-run from scratch (the historical behaviour)


class VirtualClockExecutor(Executor):
    """Deterministic event-heap executor — the paper's large-scale mode.

    Durations come from ``desc.duration_model(ranks)`` with lognormal noise,
    straggler and failure injection per ``SimOptions``; communicator-build
    overhead from ``opts.overhead_model``.  Device failures are injected as
    timed events the core turns into pool shrinks."""

    wall_clock = False

    def __init__(self, opts: Optional[SimOptions] = None):
        import random
        self.opts = opts or SimOptions()
        self.rng = random.Random(self.opts.seed)
        self._now = 0.0
        self._seq = itertools.count()
        self._heap: list = []
        self._canceled: set = set()
        self._ckpt_progress: dict = {}   # primary uid -> durable virtual
        # seconds banked by failed attempts (ckpt_period_s resume model)
        for ft, nf in self.opts.device_failures:
            heapq.heappush(self._heap,
                           (ft, next(self._seq),
                            ExecEvent("device_failure", n_devices=nf)))
        for gt, ng in self.opts.grow_at:
            heapq.heappush(self._heap,
                           (gt, next(self._seq),
                            ExecEvent("grow", n_devices=ng)))
        for rt, nr in self.opts.retire_at:
            heapq.heappush(self._heap,
                           (rt, next(self._seq),
                            ExecEvent("retire", n_devices=nr)))

    def now(self) -> float:
        return self._now

    def launch(self, task: Task, duration_hint: Optional[float] = None):
        opts = self.opts
        if duration_hint is not None:
            # speculative duplicate: runs at the hinted (median) rate on a
            # fresh device — no overhead, no straggler/failure injection
            oh, dur, fails = 0.0, duration_hint, False
        else:
            oh = opts.overhead_model(task.desc.ranks)
            dur = task.desc.duration_model(task.desc.ranks)
            dur *= math.exp(self.rng.gauss(0.0, opts.noise))
            if opts.straggler_prob and self.rng.random() < opts.straggler_prob:
                dur *= opts.straggler_slowdown
            fails = bool(opts.failure_prob
                         and self.rng.random() < opts.failure_prob)
        resumed = 0
        period = opts.ckpt_period_s
        if period > 0 and task.ckpt_dir and duration_hint is None:
            # resume model: this attempt restores whatever whole-period
            # progress earlier attempts durably banked, and runs only the
            # remainder.  A spec twin (duration_hint) models a fresh device
            # at the hinted rate and is left alone.
            banked = self._ckpt_progress.get(task.uid, 0.0)
            resumed = int(banked // period)
            dur = max(dur - resumed * period, 0.0)
            if fails:
                # what THIS attempt will have durably saved when it dies
                self._ckpt_progress[task.uid] = \
                    resumed * period + (dur // period) * period
            else:
                self._ckpt_progress.pop(task.uid, None)
        ev = ExecEvent("fail" if fails else "done", task=task,
                       error="injected failure" if fails else None,
                       comm_build_s=oh, resumed_from_step=resumed)
        heapq.heappush(self._heap,
                       (self._now + oh + dur, next(self._seq), ev))

    def poll(self, timeout: Optional[float]) -> Optional[ExecEvent]:
        if timeout == 0:
            return None   # never advance the clock on an opportunistic poll
        while self._heap:
            t, _, ev = heapq.heappop(self._heap)
            if ev.task is not None and ev.task.uid in self._canceled:
                continue
            self._now = t
            return ev
        return None

    def cancel(self, task: Task) -> bool:
        self._canceled.add(task.uid)
        return True

    def topology(self, devices):
        """Synthetic nodes: integer device ``d`` lives on node
        ``n{d // devices_per_node}`` — a stable assignment, so the same
        device maps to the same node no matter which subset (e.g. a pool's
        free list) is being classified.  Non-integer handles, or
        ``devices_per_node == 0``, degrade to one flat node (the historical
        topology-blind view)."""
        from repro_torch.core.placement import Topology
        k = self.opts.devices_per_node
        if k <= 0 or not all(isinstance(d, int) for d in devices):
            return Topology({"node0": tuple(devices)})
        nodes: dict = {}
        for d in devices:
            nodes.setdefault(f"n{d // k}", []).append(d)
        return Topology(nodes)
