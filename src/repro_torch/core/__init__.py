"""The paper's primary contribution in PyTorch: a heterogeneous pilot
runtime (RADICAL-Pilot/RAPTOR analogue) that executes differently-sized SPMD
tasks — Cylon-style dataframe ops — on dynamically carved rank sets with
private communicators, plus the batch-execution baseline it is compared
against in the paper."""
from repro_torch.core.communicator import (
    Communicator, RankDevice, build_communicator, cuda_devices,
    degenerate_axes, logical_devices, resolve_device,
)
from repro_torch.core.pilot import (
    InsufficientResources, Pilot, PilotDescription, PilotManager,
    ResourceManager,
)
from repro_torch.core.pipeline import Pipeline, Stage, run_pipelines
from repro_torch.core.raptor import RaptorMaster, session
from repro_torch.core.scheduler import (
    BATCH, HETEROGENEOUS, PACK, PLACEMENTS, SPREAD, ExecEvent, Executor,
    LiveScheduler, ProcDevice, ProcessExecutor, SchedulerSession, SimOptions,
    SimReport, StubComm, ThreadExecutor, Topology, TraceEvent,
    VirtualClockExecutor, default_overhead_model, interleave_by_pipeline,
    simulate,
)
from repro_torch.core.task import Task, TaskDescription, TaskState

__all__ = [
    "BATCH", "HETEROGENEOUS", "PACK", "PLACEMENTS", "SPREAD", "Communicator",
    "ExecEvent", "Executor", "InsufficientResources", "LiveScheduler",
    "Pilot", "PilotDescription", "PilotManager", "Pipeline", "ProcDevice",
    "ProcessExecutor", "RankDevice", "RaptorMaster", "ResourceManager", "SchedulerSession", "SimOptions",
    "SimReport", "Stage", "StubComm", "Task", "TaskDescription", "TaskState",
    "ThreadExecutor", "Topology", "TraceEvent", "VirtualClockExecutor",
    "build_communicator", "cuda_devices", "default_overhead_model",
    "degenerate_axes", "interleave_by_pipeline", "logical_devices",
    "resolve_device", "run_pipelines", "session", "simulate",
]
