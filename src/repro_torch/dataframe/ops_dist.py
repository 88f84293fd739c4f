"""Cylon 'distributed operators': bulk-synchronous SPMD over a rank list.

Each operator is built for a Communicator (the private per-task rank set
the runtime delivers) and runs every rank's step in turn, with the
collectives of :mod:`repro_torch.dataframe.comm` between steps:

  * shuffle       — hash/range repartition rows via all_to_all
  * dist_sort     — sample sort: local sort -> splitter all_gather -> range
                    shuffle -> local sort  (globally sorted across ranks)
  * dist_join     — hash-shuffle both sides, local sort-merge inner join
  * dist_groupby  — hash shuffle + local segmented sum

Static shapes: every rank holds (capacity,) padded columns + nrows.  Send
buffers have per-destination capacity slack; overflow is detected and
reported (overflow flag), never silently dropped.  The send buffers are
packed through the ``radix_partition`` kernel, so every shuffle on the card
launches it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dataframe import comm
from repro_torch.dataframe import ops_local as L
from repro_torch.dataframe.table import DistTable, Table, from_numpy
from repro_torch.kernels.radix_partition.ops import radix_partition


class ShuffleOverflow(RuntimeError):
    """A shuffle dropped rows: some rank's per-destination row count
    exceeded its send-buffer capacity (``counts > send_cap``).  Carries the
    structured context callers need to retry with more slack — or to switch
    to the out-of-core path (``repro_torch.dataframe.shuffle``), which has no
    fixed send capacity at all."""

    def __init__(self, op: str, slack: float):
        self.op = op
        self.slack = slack
        super().__init__(
            f"{op}: send buffer overflow (some rank's rows for one "
            f"destination exceeded capacity * slack / n_parts with "
            f"slack={slack}); retry with a larger slack= or use the "
            f"out-of-core shuffle (repro_torch.dataframe.shuffle)")


def _checked(fn, op: str, slack: float, on_overflow: str):
    """Wrap a ``(table, ovf)`` op: ``on_overflow="return"`` passes the flag
    through; ``"raise"`` turns a True overflow flag into a
    :class:`ShuffleOverflow` so it can never be silently dropped."""
    if on_overflow not in ("return", "raise"):
        raise ValueError(f"on_overflow={on_overflow!r} "
                         "(expected 'return' or 'raise')")
    if on_overflow == "return":
        return fn

    def wrapped(*args):
        out, ovf = fn(*args)
        if bool(ovf):
            raise ShuffleOverflow(op, slack)
        return out, ovf

    return wrapped


# ---------------------------------------------------------------------------
# shuffle
# ---------------------------------------------------------------------------
def _local_shuffle_pack(table: Table, target, n_parts: int, send_cap: int):
    """Pack rows into a (P, send_cap, ...) send buffer by destination.

    Positions and counts come from ``radix_partition`` over ``n_parts + 1``
    buckets, invalid rows in the last: a row's position is its stable rank
    among the valid rows bound for the same rank — what the JAX version
    takes from a stable argsort."""
    valid = table.valid_mask()
    tgt = torch.where(valid, target.to(torch.int32), n_parts)  # invalid -> P
    dest, hist = radix_partition(tgt.contiguous(), n_parts + 1)
    offsets = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    pos = dest - offsets[tgt.long()]
    counts = hist[:n_parts]
    overflow = torch.any(counts > send_cap)

    bufs = {}
    row_ok = valid & (pos < send_cap)
    # dropped rows go to the spare last slot of a (P*send_cap + 1) buffer
    slot = torch.where(row_ok, tgt.long() * send_cap + pos.long(),
                       n_parts * send_cap)
    for k, v in table.columns.items():
        buf = torch.zeros((n_parts * send_cap + 1,) + v.shape[1:],
                          dtype=v.dtype, device=v.device)
        buf[slot] = v
        bufs[k] = buf[:n_parts * send_cap].view((n_parts, send_cap)
                                                + v.shape[1:])
    sent = torch.clamp(counts, max=send_cap).to(torch.int32)  # rows per dest
    return bufs, sent, overflow


def _shuffle(shards: list, targets: list, devices: list, slack: float):
    """Shuffle every rank's rows to their target ranks.  Returns (per-rank
    Tables with capacity P*send_cap, overflow flag per rank)."""
    n_parts = comm.axis_size(devices)
    send_cap = int(shards[0].capacity * slack) // n_parts + 8
    packs = [_local_shuffle_pack(t, tgt, n_parts, send_cap)
             for t, tgt in zip(shards, targets, strict=True)]
    recv = {k: comm.all_to_all([p[0][k] for p in packs], devices)
            for k in shards[0].columns}                   # (P, send_cap, ...)
    recv_counts = comm.all_to_all([p[1].reshape(-1, 1) for p in packs],
                                  devices)                # (P, 1)
    ovf = comm.psum([p[2].to(torch.int32) for p in packs], devices)
    out = []
    for r, dev in enumerate(devices):
        # rows arrive as P blocks with per-block validity: mark ALL slots
        # valid, then compact by the true receive mask
        pos_in_block = torch.arange(send_cap, device=dev)[None, :]
        rvalid = (pos_in_block < recv_counts[r][:, 0][:, None]).reshape(-1)
        cols = {k: v[r].reshape((-1,) + v[r].shape[2:])
                for k, v in recv.items()}
        t = Table(columns=cols, nrows=torch.tensor(
            rvalid.shape[0], dtype=torch.int32, device=dev))
        out.append(L.filter_rows(t, rvalid))
    return out, [o > 0 for o in ovf]


def _result(shards: list, ovf: list):
    return DistTable(shards), ovf[0]


def _per_rank(target: torch.Tensor, table: DistTable) -> list:
    """Split a rank-major ``(P * capacity,)`` target (the JAX layout) into
    one tensor per rank, on that rank's device."""
    parts = target.reshape(table.n_parts, -1)
    return [parts[r].to(s.device) for r, s in enumerate(table.shards)]


def make_shuffle(comm_obj, slack: float = 2.0, on_overflow: str = "return"):
    """Returns shuffle(table, target) over the communicator's ranks, with
    ``target`` rank-major like the table's columns.  ``on_overflow="raise"``
    turns a dropped-rows overflow into a :class:`ShuffleOverflow` instead of
    a flag callers may ignore."""
    devices = comm_obj.torch_devices

    def _shuf(table: DistTable, target):
        out, ovf = _shuffle(table.shards, _per_rank(target, table), devices,
                            slack)
        return _result(out, ovf)

    return _checked(_shuf, "shuffle", slack, on_overflow)


# ---------------------------------------------------------------------------
# distributed sample sort
# ---------------------------------------------------------------------------
def _dist_sort(shards: list, key: str, devices: list, slack: float):
    n_parts = comm.axis_size(devices)
    ts = [L.sort_by(t, key) for t in shards]
    samples = []
    for t in ts:
        # sample n_parts values per rank at even quantiles of the VALID rows
        q = (torch.arange(n_parts, dtype=torch.float32, device=t.device)
             + 0.5) / n_parts
        nr = torch.clamp(t.nrows, min=1).to(torch.float32)
        idx = torch.clamp((q * nr).to(torch.int32), 0, t.capacity - 1)
        samples.append(t.columns[key][idx.long()])                # (P,)
    all_samples = comm.all_gather(samples, devices)               # (P, P)
    targets = []
    for t, a in zip(ts, all_samples, strict=True):
        ssorted = torch.sort(a.reshape(-1)).values
        splitters = ssorted[torch.arange(1, n_parts, device=t.device)
                            * n_parts].contiguous()               # (P-1,)
        target = torch.searchsorted(L.search_image(splitters),
                                    L.search_image(t.columns[key]),
                                    right=True)
        targets.append(torch.where(t.valid_mask(), target.to(torch.int32), 0))
    shuffled, ovf = _shuffle(ts, targets, devices, slack)
    return [L.sort_by(s, key) for s in shuffled], ovf


def make_dist_sort(comm_obj, key: str, slack: float = 2.0,
                   on_overflow: str = "return"):
    devices = comm_obj.torch_devices

    def _sort(table: DistTable):
        return _result(*_dist_sort(table.shards, key, devices, slack))

    return _checked(_sort, "dist_sort", slack, on_overflow)


# ---------------------------------------------------------------------------
# distributed hash join
# ---------------------------------------------------------------------------
def _hash_target(t: Table, key: str, n_parts: int) -> torch.Tensor:
    h = (L.hash_key(t.columns[key]) % n_parts).to(torch.int32)
    return torch.where(t.valid_mask(), h, 0)


def _dist_join(left: list, right: list, key: str, devices: list,
               slack: float, out_factor: float):
    n_parts = comm.axis_size(devices)
    ls, ovl = _shuffle(left, [_hash_target(t, key, n_parts) for t in left],
                       devices, slack)
    rs, ovr = _shuffle(right, [_hash_target(t, key, n_parts) for t in right],
                       devices, slack)
    out_cap = int(max(left[0].capacity, right[0].capacity) * out_factor)
    joined = [L.join_inner(a, b, key, out_cap)
              for a, b in zip(ls, rs, strict=True)]
    ovj = comm.psum([j[1].to(torch.int32) for j in joined], devices)
    ovf = [a | b | (c > 0) for a, b, c in zip(ovl, ovr, ovj, strict=True)]
    return [j[0] for j in joined], ovf


def make_dist_join(comm_obj, key: str, slack: float = 2.0,
                   out_factor: float = 2.0, on_overflow: str = "return"):
    devices = comm_obj.torch_devices

    def _join(left: DistTable, right: DistTable):
        return _result(*_dist_join(left.shards, right.shards, key, devices,
                                   slack, out_factor))

    return _checked(_join, "dist_join", slack, on_overflow)


# ---------------------------------------------------------------------------
# distributed groupby-sum
# ---------------------------------------------------------------------------
def make_dist_groupby_sum(comm_obj, key: str, value_cols, slack: float = 2.0,
                          on_overflow: str = "return"):
    devices = comm_obj.torch_devices

    def _gb(table: DistTable):
        n_parts = comm.axis_size(devices)
        shuffled, ovf = _shuffle(
            table.shards, [_hash_target(t, key, n_parts) for t in table.shards],
            devices, slack)
        return _result([L.groupby_sum(s, key, value_cols) for s in shuffled],
                       ovf)

    return _checked(_gb, "dist_groupby_sum", slack, on_overflow)


# ---------------------------------------------------------------------------
# host-side helpers: build a distributed Table for a communicator
# ---------------------------------------------------------------------------
def shard_table(comm_obj, data: dict, capacity_per_rank: int) -> DistTable:
    """Partition host data into contiguous per-rank blocks (rank r holds
    rows ``[offs[r], offs[r+1])``, as in the JAX package), each padded to
    ``capacity_per_rank`` on that rank's device."""
    devices = comm_obj.torch_devices
    n = len(next(iter(data.values())))
    pcount = len(devices)
    per = [n // pcount + (1 if r < n % pcount else 0) for r in range(pcount)]
    assert max(per) <= capacity_per_rank, (max(per), capacity_per_rank)
    offs = np.cumsum([0] + per)
    return DistTable([
        from_numpy({k: np.asarray(v)[offs[r]:offs[r + 1]]
                    for k, v in data.items()}, capacity_per_rank, dev)
        for r, dev in enumerate(devices)])


def collect_table(table: DistTable) -> dict:
    """Gather a distributed Table back to host as dict of np arrays."""
    per_rank = [s.to_numpy() for s in table.shards]
    return {k: np.concatenate([p[k] for p in per_rank], axis=0)
            for k in per_rank[0]}
