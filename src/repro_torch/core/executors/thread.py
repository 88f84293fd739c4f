"""Live in-process executor: one worker thread + private communicator per
task on its allocated ranks."""
from __future__ import annotations

import dataclasses
import threading
from time import perf_counter
from typing import Any, Optional

from repro_torch.core.executors.base import ExecEvent, QueueEventExecutor
from repro_torch.core.task import Task
from repro_torch.obs import spans as _spans


@dataclasses.dataclass
class StubComm:
    """Communicator stand-in when ``ThreadExecutor(build_comm=False)`` — used
    by tests that exercise scheduling on fake device handles."""
    devices: tuple
    build_seconds: float = 0.0
    placement: str = ""          # policy that placed the devices (pack|spread)
    p2p_bytes: int = 0           # uniform comm-stats surface: an in-process
    hub_calls: int = 0           # comm never pays a hub or peer transfer
    spills: int = 0              # nor spills shuffle partitions to disk
    raw_coll_bytes: int = 0      # nor ships raw/shm frames or forwards
    shm_bytes: int = 0           # ring blocks — constant zeros keep the
    ring_steps: int = 0          # transport counters uniform across backends
    checkpoint: Any = None       # CheckpointContext when the session runs
    # with a checkpoint root (REPRO_CKPT_DIR); None otherwise

    @property
    def size(self) -> int:
        return len(self.devices)


class ThreadExecutor(QueueEventExecutor):
    """Live executor: each task runs ``fn(comm, *args, **kwargs)`` in a
    worker thread on its allocated devices, with a freshly built private
    Communicator (the paper's per-task MPI_Comm analogue).

    Each task records its flight-recorder spans — ``launch`` (from
    ``launch()`` to its thread running), ``comm_build``, ``compute`` and
    whatever the payload's code records under them — and ships them on its
    terminal event, on this process's ``perf_counter`` clock, tagged
    ``worker="thread"``, ``part=0``, ``uid`` and ``task``."""

    def __init__(self, build_comm: bool = True, tick: float = 0.05):
        super().__init__()
        self.build_comm = build_comm
        self.tick = tick

    def launch(self, task: Task, duration_hint: Optional[float] = None):
        t_launch = perf_counter()

        def worker():
            # the task's flight recorder, bound to this thread so the code
            # the payload calls records its own spans (as the process
            # worker's part thread does)
            rec = _spans.SpanRecorder()
            rec.add("launch", t_launch, perf_counter())
            comm_s = 0.0
            ckpt = None
            if task.ckpt_dir:
                # in-process tasks always run as one part, so the p0-of-1
                # scope interoperates with single-part proc attempts
                from repro_torch.train.checkpoint import CheckpointContext
                ckpt = CheckpointContext(task.ckpt_dir,
                                         attempt=task.ckpt_attempt or "a0")

            def event(kind, **kw):
                spans = _spans.align(rec.export(), 0.0, worker="thread",
                                     part=0, uid=task.uid,
                                     task=task.desc.name)
                return ExecEvent(
                    kind, task=task, comm_build_s=comm_s, spans=spans,
                    resumed_from_step=ckpt.resumed_from_step if ckpt else 0,
                    **kw)

            try:
                with _spans.bound(rec):
                    if self.build_comm:
                        from repro_torch.core.communicator import (
                            build_communicator)
                        with rec.span("comm_build"):
                            comm = build_communicator(
                                task.devices, task.desc.mesh_axes,
                                task.desc.mesh_shape, uid=f"task{task.uid}",
                                placement=task.placement)
                        comm_s = comm.build_seconds
                    else:
                        comm = StubComm(devices=tuple(task.devices),
                                        placement=task.placement)
                    comm.checkpoint = ckpt
                    with rec.span("compute"):
                        res = task.desc.fn(comm, *task.desc.args,
                                           **task.desc.kwargs)
                self._q.put(event("done", result=res))
            except Exception as e:  # noqa: BLE001 — report any payload error
                self._q.put(event("fail", error=f"{type(e).__name__}: {e}"))

        threading.Thread(target=worker, daemon=True).start()
