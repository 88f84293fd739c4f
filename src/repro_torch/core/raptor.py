"""RAPTOR-style master/worker facade over the unified scheduler core (paper
Fig. 3/4).

The master receives TaskDescriptions, asks the scheduler core to place them
on the pilot's devices, builds the private communicator per task, and
collects results — i.e. the orchestration flow of the paper:

    client -> PilotManager -> Pilot -> RaptorMaster -> (comm, task) -> result

Live and simulated execution are the SAME ``SchedulerSession`` dispatch/
retry/spec-exec code path; only the executor differs (threads on real
devices vs the deterministic virtual clock).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.pilot import Pilot, PilotDescription, PilotManager
from repro_torch.core.scheduler import (
    HETEROGENEOUS, SchedulerSession, SimOptions, SimReport,
    ThreadExecutor, simulate,
)
from repro_torch.core.task import TaskDescription


class RaptorMaster:
    """Execution master bound to one pilot."""

    def __init__(self, pilot: Pilot, policy: str = HETEROGENEOUS,
                 speculative_factor: Optional[float] = None):
        self.pilot = pilot
        self.policy = policy
        self.speculative_factor = speculative_factor
        self._queue: list[TaskDescription] = []

    def submit(self, desc: TaskDescription):
        self._queue.append(desc)
        return desc

    def submit_many(self, descs: Sequence[TaskDescription]):
        self._queue.extend(descs)

    def run(self, timeout: float = 600.0) -> SimReport:
        """Execute all queued tasks on real devices; returns the report."""
        sess = SchedulerSession(ThreadExecutor(),
                                self.pilot.resource_manager,
                                policy=self.policy,
                                speculative_factor=self.speculative_factor)
        descs, self._queue = self._queue, []
        return sess.run(descs, timeout=timeout)

    def run_simulated(self, opts: Optional[SimOptions] = None) -> SimReport:
        """Execute on the virtual clock (large-scale experiments) — the same
        scheduler core over a VirtualClockExecutor."""
        opts = opts or SimOptions(policy=self.policy,
                                  speculative_factor=self.speculative_factor)
        descs, self._queue = self._queue, []
        return simulate(descs, self.pilot.desc.n_devices, opts)


def session(n_devices: Optional[int] = None, policy: str = HETEROGENEOUS,
            devices=None) -> RaptorMaster:
    """One-call setup: PilotManager -> Pilot -> RaptorMaster."""
    pm = PilotManager(devices=devices)
    n = n_devices or pm.global_rm.total
    pilot = pm.submit_pilot(PilotDescription(n_devices=n))
    return RaptorMaster(pilot, policy)
