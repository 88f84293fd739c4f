"""Pilot abstraction: acquire a device pool once, then let the scheduler carve
it up per task (the paper's core resource-management idea).

ResourceManager models the HPC RM (Slurm/LSF): it owns the device inventory,
honours allocate/release, and supports *failure injection* (devices lost at
runtime) plus *elastic* grow/shrink — the fault-tolerance hooks exercised by
tests/test_runtime.py.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence


class InsufficientResources(Exception):
    pass


@dataclasses.dataclass
class PilotDescription:
    n_devices: int
    name: str = "pilot"


class ResourceManager:
    """Device inventory with allocate/release and failure injection.

    Devices are any hashable handles; in real mode they are
    :class:`~repro_torch.core.communicator.RankDevice` records, in simulation
    they are integer rank ids.
    """

    def __init__(self, devices: Sequence):
        self._lock = threading.Lock()
        self._all = list(devices)
        self._free = list(devices)
        self._failed: set = set()

    @property
    def total(self) -> int:
        return len(self._all)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def failed_devices(self) -> set:
        with self._lock:
            return set(self._failed)

    @property
    def all_devices(self) -> tuple:
        """Snapshot of the full inventory (free AND busy), in pool order —
        what an elastic grow must not collide with when inventing handles."""
        with self._lock:
            return tuple(self._all)

    def __contains__(self, device) -> bool:
        """True while the device is part of this inventory (free OR busy);
        failed devices have left the inventory."""
        with self._lock:
            return device in self._all

    def allocate(self, n: int, exclude: Sequence = ()) -> tuple:
        """Historical flat allocation: first ``n`` free devices in pool
        order, excluded devices last.  Shim over :meth:`allocate_placed`
        with no topology — i.e. the ``spread`` placement."""
        return self.allocate_placed(n, exclude=exclude)

    def allocate_placed(self, n: int, topology=None,
                        policy: Optional[str] = None,
                        exclude: Sequence = ()) -> tuple:
        """Allocate ``n`` devices honouring a placement policy.

        ``topology`` is a :class:`repro_torch.core.placement.Topology` over (a
        superset of) this pool's devices, or a callable producing one from
        the current free list — the scheduler passes the executor's
        ``topology`` method so grouping happens atomically under the pool
        lock.  ``policy`` is ``"spread"`` (historical flat order; default)
        or ``"pack"`` (fewest distinct nodes; see ``placement.plan``).
        Devices in ``exclude`` are chosen only when nothing else fits (the
        retry-with-device-exclusion contract)."""
        from repro_torch.core.placement import SPREAD, _exclude_last, plan
        with self._lock:
            if len(self._free) < n:
                raise InsufficientResources(f"want {n}, free {len(self._free)}")
            if policy is None or policy == SPREAD:
                # the historical flat path, preserved EXACTLY — including the
                # excluded-last reordering persisting into the remaining free
                # list — so pre-placement schedules reproduce bit-for-bit;
                # the topology is never materialized here (spread ignores it)
                ordered = _exclude_last(self._free, set(exclude))
                got, self._free = ordered[:n], ordered[n:]
                return tuple(got)
            if callable(topology):
                topology = topology(tuple(self._free))
            got = plan(n, self._free, topology, policy, exclude)
            taken = set(got)
            self._free = [d for d in self._free if d not in taken]
            return tuple(got)

    def release(self, devices: Sequence):
        with self._lock:
            # snapshot sets once: membership scans on the raw lists would be
            # O(pool) per device, quadratic at paper-scale (2688) pools
            owned, free = set(self._all), set(self._free)
            for d in devices:
                # the membership check on _free guards against double
                # release: the same handle appended twice would satisfy two
                # concurrent allocations with one physical device
                if d not in self._failed and d in owned and d not in free:
                    self._free.append(d)
                    free.add(d)

    def fail_devices(self, devices: Sequence):
        """Failure injection: devices die; running tasks on them must retry."""
        with self._lock:
            self._failed.update(devices)
            self._all = [d for d in self._all if d not in self._failed]
            self._free = [d for d in self._free if d not in self._failed]

    def add_devices(self, devices: Sequence):
        """Elastic grow.  Handles already in the inventory are skipped, so
        replaying a grow event against a pool that absorbed it (executor-side
        AND session-side registration paths) stays idempotent — a duplicate
        handle in ``_free`` would satisfy two allocations with one device.
        An admitted handle is also cleared from the failed set: re-adding a
        previously failed/retired device is a rehabilitation (the node came
        back), and a handle left in ``_failed`` would be silently dropped by
        ``release`` after its first lease — a permanent pool leak."""
        with self._lock:
            known = set(self._all)
            for d in devices:
                if d not in known:
                    self._all.append(d)
                    self._free.append(d)
                    self._failed.discard(d)
                    known.add(d)


class Pilot:
    """An acquired resource pool (placeholder for compute, as in RP)."""

    def __init__(self, desc: PilotDescription, rm: ResourceManager):
        self.desc = desc
        self.rm = rm
        self.devices = rm.allocate(desc.n_devices)
        self._own_rm = ResourceManager(self.devices)

    @property
    def resource_manager(self) -> ResourceManager:
        return self._own_rm

    def cancel(self):
        self.rm.release(self.devices)


class PilotManager:
    """Owns pilots over a global inventory (rp.PilotManager analogue).
    The default inventory is one rank per visible CUDA device; pass
    ``logical_devices(n, device)`` for several ranks on one device."""

    def __init__(self, devices: Optional[Sequence] = None):
        if devices is None:
            from repro_torch.core.communicator import cuda_devices
            devices = cuda_devices()
        self.global_rm = ResourceManager(devices)
        self.pilots: list[Pilot] = []

    def submit_pilot(self, desc: PilotDescription) -> Pilot:
        p = Pilot(desc, self.global_rm)
        self.pilots.append(p)
        return p
