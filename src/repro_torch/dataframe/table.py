"""Columnar Table: the Cylon/Arrow table abstraction with static shapes.
Columns are fixed-capacity padded tensors plus a valid-row count; every
operator preserves the (capacity, nrows) contract and reports overflow
explicitly instead of reallocating.

A distributed table (:class:`DistTable`) holds one local :class:`Table` per
rank, each on that rank's device.  Its public layout is the JAX package's:
rank-major ``(P * capacity,)`` columns and a ``(P,)`` ``nrows``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.communicator import resolve_device, torch_device


@dataclasses.dataclass
class Table:
    columns: Dict[str, torch.Tensor]   # each (capacity, ...)
    nrows: torch.Tensor                # 0-d int32, on the columns' device

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def column_names(self):
        return sorted(self.columns)

    @property
    def device(self) -> torch.device:
        return self.nrows.device

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.nrows

    def to_numpy(self) -> dict:
        n = int(self.nrows)
        return {k: v[:n].cpu().numpy() for k, v in self.columns.items()}


@dataclasses.dataclass
class DistTable:
    """One local Table per rank (all of one capacity and one schema)."""
    shards: list

    @property
    def n_parts(self) -> int:
        return len(self.shards)

    @property
    def columns(self) -> dict:
        """Rank-major ``(P * capacity, ...)`` columns on rank 0's device."""
        dev = self.shards[0].device
        return {k: torch.cat([s.columns[k].to(dev) for s in self.shards])
                for k in self.shards[0].columns}

    @property
    def nrows(self) -> torch.Tensor:
        """``(P,)`` int32 valid-row counts on rank 0's device."""
        dev = self.shards[0].device
        return torch.stack([s.nrows.to(dev) for s in self.shards])

    def to_numpy(self) -> dict:
        from repro_torch.dataframe.ops_dist import collect_table
        return collect_table(self)


def from_numpy(data: dict, capacity: int | None = None,
               device=None) -> Table:
    """Host columns -> a padded Table on ``device`` (the card unless the
    caller names another)."""
    dev = resolve_device(device)
    n = len(next(iter(data.values())))
    cap = capacity or n
    assert cap >= n
    cols = {}
    for k, v in data.items():
        src = torch.from_numpy(np.ascontiguousarray(v))
        buf = torch.zeros((cap,) + src.shape[1:], dtype=src.dtype, device=dev)
        buf[:n] = src.to(dev)
        cols[k] = buf
    return Table(columns=cols,
                 nrows=torch.tensor(n, dtype=torch.int32, device=dev))


def key_sentinel(dtype: torch.dtype):
    """Max value used to push invalid rows to the end of sorts."""
    if dtype.is_floating_point:
        return torch.finfo(dtype).max
    return torch.iinfo(dtype).max


def from_reference(columns: dict, nrows, devices) -> Table | DistTable:
    """The JAX package's table as numpy arrays -> the port's table.

    ``nrows`` a scalar: a local Table on ``devices`` (one device or a
    one-element list).  ``nrows`` of shape ``(P,)``: a DistTable whose
    rank-major ``(P * cap,)`` columns are split into P shards, one on each
    of ``devices`` (rank handles or torch devices)."""
    nrows = np.asarray(nrows)
    if nrows.ndim == 0:
        dev = devices[0] if isinstance(devices, (list, tuple)) else devices
        dev = torch_device(dev)
        cols = {k: torch.from_numpy(np.array(v)).to(dev)
                for k, v in columns.items()}
        return Table(columns=cols, nrows=torch.tensor(
            int(nrows), dtype=torch.int32, device=dev))
    pcount = nrows.shape[0]
    assert len(devices) == pcount, (len(devices), pcount)
    shards = []
    for r, d in enumerate(devices):
        dev = torch_device(d)
        cols = {}
        for k, v in columns.items():
            v = np.asarray(v)
            v = v.reshape((pcount, -1) + v.shape[1:])[r]
            cols[k] = torch.from_numpy(np.array(v)).to(dev)
        shards.append(Table(columns=cols, nrows=torch.tensor(
            int(nrows[r]), dtype=torch.int32, device=dev)))
    return DistTable(shards)


def to_reference(table: Table | DistTable):
    """The port's table -> ``(columns, nrows)`` as numpy arrays in the JAX
    package's layout (padded columns; rank-major for a DistTable)."""
    cols = {k: v.cpu().numpy() for k, v in table.columns.items()}
    return cols, table.nrows.cpu().numpy().astype(np.int32)
