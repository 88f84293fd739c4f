"""MPMD pipelines: DAGs of SPMD tasks (the paper's 'traced program comprising
multiple computations').

A Pipeline is a set of named stages with dependencies.  ``run_pipelines``
drives one persistent :class:`SchedulerSession` with *continuous DAG
release*: every stage is submitted the moment its OWN deps complete — not
when a whole frontier drains — so independent branches across concurrent
pipelines backfill freed devices immediately (paper §4.4: 'identifying
independent branches of execution and executing such independent tasks
parallelly', and the §4.3 heterogeneous-backfill win).  The previous
implementation executed DAGs in waves with a full barrier between frontiers,
which let freed devices idle until the slowest stage of a wave finished —
exactly the convoy effect the paper's runtime eliminates.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.scheduler import (
    HETEROGENEOUS, SPREAD, Executor, SchedulerSession, SimReport,
    ThreadExecutor,
)
from repro_torch.core.task import TaskDescription, TaskState


@dataclasses.dataclass
class Stage:
    name: str
    ranks: int
    fn: Optional[Callable]  # fn(comm, *dep_results, **kwargs); None in sim
    deps: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    mesh_axes: tuple = ("df",)
    pipeline: str = "default"
    priority: int = 0
    duration_model: Optional[Callable[[int], float]] = None  # sim mode


class Pipeline:
    def __init__(self, name: str = "pipeline"):
        self.name = name
        self.stages: dict[str, Stage] = {}

    def add(self, name: str, ranks: int, fn: Optional[Callable] = None,
            deps: Sequence[str] = (), priority: int = 0,
            duration_model: Optional[Callable] = None,
            **kwargs) -> "Pipeline":
        assert name not in self.stages
        for d in deps:
            assert d in self.stages, f"unknown dep {d}"
        self.stages[name] = Stage(name=name, ranks=ranks, fn=fn,
                                  deps=tuple(deps), kwargs=kwargs,
                                  pipeline=self.name, priority=priority,
                                  duration_model=duration_model)
        return self

    def topo_order(self) -> list[str]:
        order, seen = [], set()

        def visit(n):
            if n in seen:
                return
            for d in self.stages[n].deps:
                visit(d)
            seen.add(n)
            order.append(n)

        for n in self.stages:
            visit(n)
        return order


def run_pipelines(pipelines: Sequence[Pipeline], resource_manager,
                  policy: str = HETEROGENEOUS, timeout: float = 600.0,
                  executor: Optional[Executor] = None,
                  placement: str = SPREAD, work_stealing: bool = False):
    """Execute several MPMD pipelines concurrently on one device pool.

    Continuous dependency release: each stage is submitted to the persistent
    scheduler session the moment its own deps complete, so a freed device is
    never held hostage by an unrelated still-running sibling stage.  Pass a
    :class:`VirtualClockExecutor` as ``executor`` to run the same DAG logic
    on the virtual clock (stages then need ``duration_model`` instead of
    ``fn``).  ``placement`` selects the topology policy (``spread``/``pack``,
    see ``core/placement.py``); ``work_stealing=True`` lets BATCH partitions
    lease each other's idle devices.  Returns ``(results, report)`` where
    ``report.trace`` holds the per-task event timeline."""
    results: dict[tuple, Any] = {}
    remaining = {(p.name, s): p.stages[s] for p in pipelines for s in p.stages}
    sess = SchedulerSession(executor or ThreadExecutor(), resource_manager,
                            policy=policy,
                            pipelines=[p.name for p in pipelines],
                            placement=placement, work_stealing=work_stealing)
    key_of: dict[int, tuple] = {}
    submitted: set[tuple] = set()

    def submit_ready():
        ready = [key for key, st in remaining.items()
                 if key not in submitted
                 and all((key[0], d) in results for d in st.deps)]
        descs = []
        for key in ready:
            st = remaining[key]
            dep_vals = tuple(results[(key[0], d)] for d in st.deps)
            descs.append(TaskDescription(
                name=f"{key[0]}.{st.name}", ranks=st.ranks, fn=st.fn,
                args=dep_vals, kwargs=st.kwargs, mesh_axes=st.mesh_axes,
                priority=st.priority, duration_model=st.duration_model,
                tags={"pipeline": key[0]}))
        for key, task in zip(ready, sess.submit(descs), strict=True):
            key_of[task.uid] = key
            submitted.add(key)

    submit_ready()
    while remaining:
        if not sess.outstanding:
            raise RuntimeError("dependency cycle or failed deps: "
                               f"{sorted(remaining)}")
        finished = sess.wait_any(timeout=timeout)
        if not finished:
            sess.close()
            raise RuntimeError(
                f"pipelines stalled (timeout or insufficient resources); "
                f"unfinished stages: {sorted(remaining)}")
        for task in finished:
            key = key_of[task.uid]
            if task.state != TaskState.DONE:
                sess.close()
                raise RuntimeError(f"stage {key} failed: {task.error}")
            results[key] = task.result
            del remaining[key]
        submit_ready()
    report: SimReport = sess.close()
    return results, report
