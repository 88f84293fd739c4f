"""Live in-process executor: one worker thread + private communicator per
task on its allocated ranks."""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

from repro_torch.core.executors.base import ExecEvent, QueueEventExecutor
from repro_torch.core.task import Task


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
    checkpoint: Any = None       # checkpoint context (a later slice)

    @property
    def size(self) -> int:
        return len(self.devices)


class ThreadExecutor(QueueEventExecutor):
    """Live executor: each task runs ``fn(comm, *args, **kwargs)`` in a
    worker thread on its allocated devices, with a freshly built private
    Communicator (the paper's per-task MPI_Comm analogue)."""

    def __init__(self, build_comm: bool = True, tick: float = 0.05):
        super().__init__()
        self.build_comm = build_comm
        self.tick = tick

    def launch(self, task: Task, duration_hint: Optional[float] = None):
        def worker():
            comm_s = 0.0
            try:
                if task.ckpt_dir:
                    raise NotImplementedError(
                        "task checkpointing is not ported yet (ROADMAP "
                        "modules item 7); run without a checkpoint root")
                if self.build_comm:
                    from repro_torch.core.communicator import (
                        build_communicator)
                    comm = build_communicator(task.devices,
                                              task.desc.mesh_axes,
                                              task.desc.mesh_shape,
                                              uid=f"task{task.uid}",
                                              placement=task.placement)
                    comm_s = comm.build_seconds
                else:
                    comm = StubComm(devices=tuple(task.devices),
                                    placement=task.placement)
                res = task.desc.fn(comm, *task.desc.args, **task.desc.kwargs)
                self._q.put(ExecEvent("done", task=task, result=res,
                                      comm_build_s=comm_s))
            except Exception as e:  # noqa: BLE001 — report any payload error
                self._q.put(ExecEvent(
                    "fail", task=task, error=f"{type(e).__name__}: {e}",
                    comm_build_s=comm_s))

        threading.Thread(target=worker, daemon=True).start()
