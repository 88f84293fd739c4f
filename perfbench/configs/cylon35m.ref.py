"""Plain reference of the cylon35m cells: the rows a distributed join or sort
of the benchmark's tables must give, and the comparison.

Plain PyTorch on whatever device holds the inputs; it imports nothing of the
program.  The join is a counting join over the key range (right rows
grouped by key with ``bincount``, each left row expanded over its key's
group), not the program's sort-merge with binary searches.  Rows are put in
one canonical order (key, then the value columns' bits) before they are
compared, so the comparison does not depend on how the program orders rows
inside a rank; a sort's keys are compared in the order the program returns
them, ranks in rank order.
"""
from __future__ import annotations

import torch


def bits(x: torch.Tensor) -> torch.Tensor:
    """A float32 column's bit patterns (so -0.0, NaN payloads and every last
    bit count)."""
    return x.contiguous().view(torch.int32)


def canonical(cols: list) -> list:
    """Rows of ``cols`` (key first, then float32 columns) sorted by key and
    then by each column's bits."""
    keys = [cols[0]] + [bits(c) for c in cols[1:]]
    idx = torch.arange(cols[0].shape[0], device=cols[0].device)
    for k in reversed(keys):
        idx = idx[torch.argsort(k[idx], stable=True)]
    return [c[idx] for c in cols]


def rows_wrong(got: list, want: list) -> int:
    """Rows missing, extra or different between two row sets in the same
    canonical order: the count difference plus every aligned row in which
    any column's bits differ."""
    n, m = got[0].shape[0], want[0].shape[0]
    k = min(n, m)
    bad = torch.zeros(k, dtype=torch.bool, device=got[0].device)
    for g, w in zip(got, want, strict=True):
        if g.is_floating_point():
            g, w = bits(g), bits(w)
        bad |= g[:k] != w[:k]
    return abs(n - m) + int(bad.sum())


def join(lk, lv, rk, rw, key_range: int) -> list:
    """Every (key, left value, right value) of the inner join of two tables
    whose keys lie in [0, key_range), in canonical order."""
    order = torch.argsort(rk, stable=True)
    rw_by_key = rw[order]
    count = torch.bincount(rk.long(), minlength=key_range)
    first = torch.cumsum(count, 0) - count
    matches = count[lk.long()]
    left = torch.repeat_interleave(
        torch.arange(lk.shape[0], device=lk.device), matches)
    start = torch.cumsum(matches, 0) - matches
    within = torch.arange(left.shape[0], device=lk.device) - \
        torch.repeat_interleave(start, matches)
    right = first[lk.long()[left]] + within
    return canonical([lk[left], lv[left], rw_by_key[right]])


def sort(k, v) -> tuple:
    """The ascending keys, and the (key, value) rows in canonical order."""
    return torch.sort(k).values, canonical([k, v])


def control(rows: list) -> list:
    """The reference put in the program's place with the guarantee broken
    the way a cheaper path would break it: every float column moved as
    bfloat16."""
    return [rows[0]] + [c.to(torch.bfloat16).to(c.dtype) for c in rows[1:]]
