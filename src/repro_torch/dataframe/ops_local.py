"""Cylon 'local operators': run on locally resident data only.
All static-shape: outputs are (capacity,)-padded with explicit nrows and an
overflow flag where the logical result size is data-dependent (join).

Scatters whose JAX twins use ``mode="drop"`` write into a buffer one row
longer than the output and aim every dropped row at that last row, which
is then cut off: no index ever leaves the buffer, and no mask needs a sync
with the host.
"""
from __future__ import annotations

import torch

from repro_torch.dataframe.table import Table, key_sentinel

_HASH_MULT = 2654435761
_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit
    constant, in 16-bit halves so that no int64 product overflows."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def hash_key(key: torch.Tensor) -> torch.Tensor:
    """Knuth multiplicative hash with wrapping uint32 arithmetic (the JAX
    ``hash_key``); the uint32 values come back in an int64 tensor.

    Float keys take XLA's saturating float -> uint32 convert first, as the
    JAX ``astype(jnp.uint32)`` does: NaN and values below 0 give 0, values
    of 2**32 and above (+inf too) give 2**32 - 1, the rest truncate toward
    zero.  Integer keys wrap to their low 32 bits."""
    if key.is_floating_point():
        x = key.to(torch.float64)
        x = torch.where(x >= 2.0 ** 32, _MASK32, torch.where(x > 0, x, 0.0))
        k = x.to(torch.int64)
    else:
        k = key.to(torch.int64) & _MASK32
    h = _mul32(k, _HASH_MULT) ^ (k >> 16)
    return _mul32(h, _HASH_MULT)


def search_image(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor whose order is the order ``jnp.searchsorted``
    compares float keys in (``lax._sort_lt_comparator``): NaN of either
    sign is one value above +inf, -0.0 equals +0.0, every other float keeps
    its IEEE order.  ``torch.searchsorted`` over the images of a sorted
    sequence and of the values then gives JAX's indices; torch's own binary
    search orders NaN otherwise.  Integer tensors come back as they are.

    Floats narrower than 32 bits widen to float32 (exactly); the image is
    the bit pattern with every bit but the sign flipped for negatives."""
    if not x.is_floating_point():
        return x
    if x.dtype != torch.float64:
        x = x.to(torch.float32)
    x = torch.where(torch.isnan(x), float("nan"), x)      # canonical NaN
    x = torch.where(x == 0, 0.0, x)                       # -0.0 -> +0.0
    ints = torch.int64 if x.dtype == torch.float64 else torch.int32
    bits = x.view(ints)
    return torch.where(bits < 0, bits ^ torch.iinfo(ints).max, bits)


def masked_key(table: Table, key: str) -> torch.Tensor:
    col = table.columns[key]
    return torch.where(table.valid_mask(), col, key_sentinel(col.dtype))


def sort_by(table: Table, key: str) -> Table:
    """Stable local sort by key; invalid rows stay at the end."""
    order = torch.argsort(masked_key(table, key), stable=True)
    cols = {k: v[order] for k, v in table.columns.items()}
    return Table(columns=cols, nrows=table.nrows)


def filter_rows(table: Table, keep: torch.Tensor) -> Table:
    """Compact rows where keep & valid (stable)."""
    keep = keep & table.valid_mask()
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    cols = {k: v[order] for k, v in table.columns.items()}
    return Table(columns=cols, nrows=keep.sum(dtype=torch.int32))


def project(table: Table, names) -> Table:
    return Table(columns={k: table.columns[k] for k in names},
                 nrows=table.nrows)


def concat(a: Table, b: Table, capacity: int) -> Table:
    """Concatenate valid rows of a and b into a new padded table."""
    an, bn = a.nrows, b.nrows
    dev = a.device
    cols = {}
    for k in a.columns:
        va, vb = a.columns[k], b.columns[k]
        buf = torch.zeros((capacity + 1,) + va.shape[1:], dtype=va.dtype,
                          device=dev)
        buf[:va.shape[0]] = va
        # place b's rows starting at a.nrows; rows past capacity drop
        rows = torch.arange(vb.shape[0], device=dev)
        idx = torch.where(rows < bn, rows + an, capacity)
        idx = torch.clamp(idx, max=capacity)
        buf[idx] = vb
        cols[k] = buf[:capacity]
    return Table(columns=cols, nrows=(an + bn).to(torch.int32))


def join_inner(left: Table, right: Table, key: str, out_capacity: int):
    """Sort-merge inner join with duplicate keys.

    Returns (Table, overflow: 0-d bool tensor).  Non-key columns are
    prefixed l_/r_ on name collision.  Output order: left-key sorted,
    stable.
    """
    ls = sort_by(left, key)
    rs = sort_by(right, key)
    lk = masked_key(ls, key)
    rk = masked_key(rs, key)
    rk, lk = search_image(rk), search_image(lk)
    lo = torch.searchsorted(rk, lk, right=False)
    hi = torch.searchsorted(rk, lk, right=True)
    # clamp matches against invalid right rows
    hi = torch.minimum(hi, rs.nrows)
    lo = torch.minimum(lo, rs.nrows)
    counts = torch.where(ls.valid_mask(), hi - lo, 0)
    ends = torch.cumsum(counts, 0)
    total = ends[-1]
    starts = ends - counts

    out_idx = torch.arange(out_capacity, device=ls.device)
    li = torch.searchsorted(ends, out_idx, right=True)   # left row of pair j
    li_c = torch.clamp(li, max=ls.capacity - 1)
    ri = lo[li_c] + (out_idx - starts[li_c])
    valid_out = out_idx < torch.clamp(total, max=out_capacity)
    li_g = torch.where(valid_out, li_c, 0)
    ri_g = torch.where(valid_out, torch.clamp(ri, max=rs.capacity - 1), 0)

    cols = {}
    for k, v in ls.columns.items():
        name = k if k == key else (f"l_{k}" if k in rs.columns else k)
        g = v[li_g]
        cols[name] = torch.where(_expand(valid_out, v.dim()), g,
                                 torch.zeros_like(g))
    for k, v in rs.columns.items():
        if k == key:
            continue
        name = f"r_{k}" if k in ls.columns else k
        g = v[ri_g]
        cols[name] = torch.where(_expand(valid_out, v.dim()), g,
                                 torch.zeros_like(g))
    out = Table(columns=cols,
                nrows=torch.clamp(total, max=out_capacity).to(torch.int32))
    return out, total > out_capacity


def _expand(mask, ndim):
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def groupby_sum(table: Table, key: str, value_cols) -> Table:
    """Sum value_cols per key.  Output: unique keys (padded) + sums."""
    ts = sort_by(table, key)
    k = masked_key(ts, key)
    valid = ts.valid_mask()
    cap = ts.capacity
    dev = ts.device
    rows = torch.arange(cap, device=dev)
    is_start = valid & ((rows == 0) | (k != torch.roll(k, 1)))
    seg_ids = torch.cumsum(is_start, 0) - 1       # group index per row
    n_groups = is_start.sum(dtype=torch.int32)
    cols = {}
    # representative key per group
    first_pos = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
    first_pos[torch.where(is_start, seg_ids, cap)] = rows
    first_pos = first_pos[:cap]
    cols[key] = torch.where(rows < n_groups, ts.columns[key][first_pos], 0)
    seg = torch.where(valid, seg_ids, cap)
    for vc in value_cols:
        col = ts.columns[vc]
        v = torch.where(_expand(valid, col.dim()), col, 0)
        summed = torch.zeros((cap + 1,) + v.shape[1:], dtype=v.dtype,
                             device=dev)
        summed.index_add_(0, seg, v)
        cols[vc] = summed[:cap]
    return Table(columns=cols, nrows=n_groups)
