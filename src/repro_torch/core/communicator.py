"""Private per-task communicators over logical ranks — the PyTorch analogue
of RAPTOR's runtime MPI_Comm construction.

A rank is a :class:`RankDevice`, a ``(rank, torch.device)`` record.  Several
ranks may share one device (:func:`logical_devices`), the port's
counterpart of JAX's ``--xla_force_host_platform_device_count``: the
dataframe operators then run their ranks bulk-synchronously, and traffic
between two ranks is a copy between their devices.  A Communicator holds the
exact ranks allocated to one task; construction is timed, as the paper
reports it as the RP overhead of Table 2.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class RankDevice(NamedTuple):
    """One logical rank and the device its shard lives on."""
    rank: int
    device: torch.device


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  With no CUDA device and no explicit request this raises — the
    port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run on the "
                "CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{dev} requested but no CUDA device is visible")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def logical_devices(n: int, device=None) -> list:
    """``n`` logical ranks on one device (``cuda:0`` unless ``device`` says
    otherwise)."""
    dev = resolve_device(device if device is not None else "cuda:0")
    return [RankDevice(r, dev) for r in range(n)]


def cuda_devices() -> list:
    """One rank per visible CUDA device (the pilot's default inventory)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass the inventory "
                           "explicitly, e.g. logical_devices(n, 'cpu')")
    return [RankDevice(i, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def torch_device(handle) -> torch.device:
    """The ``torch.device`` behind a rank handle (a :class:`RankDevice`, a
    ``torch.device`` or a device string)."""
    if isinstance(handle, RankDevice):
        return handle.device
    return torch.device(handle)


@dataclasses.dataclass
class Communicator:
    devices: tuple
    axes: tuple
    shape: tuple
    build_seconds: float
    uid: str = ""
    placement: str = ""           # policy that placed the devices (pack|
    # spread; "" when allocation bypassed the scheduler's placement layer)
    # comm-stats surface, uniform across backends: in-process ranks have no
    # cross-process data plane, so these are constants here
    p2p_bytes: int = 0            # bytes moved worker-to-worker
    hub_calls: int = 0            # parent-hub round-trips paid
    spills: int = 0               # shuffle partitions spilled to disk
    raw_coll_bytes: int = 0       # bytes shipped with zero-copy framing
    shm_bytes: int = 0            # bytes moved through shm segments
    ring_steps: int = 0           # ring-allgather forwards performed
    checkpoint: Any = None        # checkpoint context (a later slice)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def torch_devices(self) -> list:
        """The torch device of each rank, in rank order."""
        return [torch_device(d) for d in self.devices]

    def device_of(self, rank: int) -> torch.device:
        """The torch device that rank ``rank`` of this communicator uses."""
        return torch_device(self.devices[rank])

    @property
    def degenerate_axes(self) -> tuple:
        """Axis names whose extent collapsed to 1 in a multi-rank mesh —
        see :func:`degenerate_axes`."""
        return tuple(self.axes[i] for i in degenerate_axes(self.shape))

    def sub(self, axis: str):
        """Axis size lookup (MPI_Comm_size analogue per axis)."""
        try:
            return dict(zip(self.axes, self.shape, strict=True))[axis]
        except KeyError:
            raise ValueError(
                f"unknown mesh axis {axis!r}; this communicator has axes "
                f"{self.axes}") from None


def _factor_shape(n: int, naxes: int) -> tuple:
    """Default factorization of ``n`` ranks into ``naxes`` axes, largest
    factor first (so any degenerate size-1 factors trail, e.g. prime ``n``
    with ``naxes=2`` gives ``(n, 1)``, never ``(1, n)``).

    A prime or near-prime ``n`` cannot be factored into ``naxes``
    non-trivial axes; the result then contains size-1 axes — a *degenerate*
    mesh that behaves like a lower-dimensional one (collectives over a
    size-1 axis are no-ops).  Callers that care should check
    :func:`degenerate_axes` instead of assuming every axis is usable."""
    if naxes == 1:
        return (n,)
    shape = []
    rem = n
    for i in range(naxes - 1):
        f = int(round(rem ** (1 / (naxes - i))))
        while f > 1 and rem % f:
            f -= 1
        shape.append(max(f, 1))
        rem //= max(f, 1)
    shape.append(rem)
    return tuple(sorted(shape, reverse=True))


def degenerate_axes(shape: tuple) -> tuple:
    """Indices of size-1 axes in a multi-rank mesh shape.

    ``(7, 1)`` -> ``(1,)``: the second axis exists in name only — a
    collective over it is a no-op, so code partitioning work along it gets
    no parallelism.  A genuinely single-rank mesh (total size 1) has no
    usable parallelism on ANY axis, so nothing is flagged: ``(1,)`` and
    ``(1, 1)`` -> ``()``."""
    if int(np.prod(shape)) <= 1:
        return ()
    return tuple(i for i, s in enumerate(shape) if s == 1)


def build_communicator(devices, axes=("df",), shape: Optional[tuple] = None,
                       uid: str = "", placement: str = "") -> Communicator:
    """Construct the private communicator over ``devices`` (rank handles;
    every task gets its own, any size).  ``placement`` records which policy
    chose the devices (pack/spread) so a payload — and the trace consumers —
    can see how its ranks were laid out."""
    t0 = time.perf_counter()
    n = len(devices)
    shape = shape or _factor_shape(n, len(axes))
    assert int(np.prod(shape)) == n, (shape, n)
    for d in devices:
        torch_device(d)              # every handle must name a device
    dt = time.perf_counter() - t0
    return Communicator(devices=tuple(devices), axes=tuple(axes),
                        shape=tuple(shape), build_seconds=dt, uid=uid,
                        placement=placement)
