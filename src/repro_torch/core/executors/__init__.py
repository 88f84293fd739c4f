"""Executor backends behind the unified scheduler core.

* ``VirtualClockExecutor`` — deterministic event heap (paper-scale sims).
* ``ThreadExecutor`` — worker threads on this process's ranks.

The process executor of the JAX package is a later slice of the port.
``repro_torch.core.scheduler`` re-exports these, so imports such as
``from repro_torch.core.scheduler import ThreadExecutor`` work too.
"""
from repro_torch.core.executors.base import ExecEvent, Executor
from repro_torch.core.executors.thread import StubComm, ThreadExecutor
from repro_torch.core.executors.virtual import (
    SimOptions, VirtualClockExecutor, default_overhead_model,
)

__all__ = [
    "ExecEvent", "Executor", "SimOptions", "StubComm", "ThreadExecutor",
    "VirtualClockExecutor", "default_overhead_model",
]
