"""Pure-numpy oracles for the dataframe operators (tests + benchmarks)."""
from __future__ import annotations

import numpy as np


def ref_sort(data: dict, key: str) -> dict:
    order = np.argsort(data[key], kind="stable")
    return {k: np.asarray(v)[order] for k, v in data.items()}


def ref_join_inner(left: dict, right: dict, key: str) -> dict:
    """Inner join with duplicates, left-key-sorted output (matches
    ops_local.join_inner / ops_dist ordering after sorting)."""
    lk, rk = np.asarray(left[key]), np.asarray(right[key])
    r_order = np.argsort(rk, kind="stable")
    rk_s = rk[r_order]
    lo = np.searchsorted(rk_s, lk, side="left")
    hi = np.searchsorted(rk_s, lk, side="right")
    l_idx = np.repeat(np.arange(len(lk)), hi - lo)
    r_idx = np.concatenate([r_order[a:b] for a, b in zip(lo, hi, strict=True)]) \
        if len(lk) else np.zeros((0,), np.int64)
    out = {}
    for k, v in left.items():
        name = k if k == key else (f"l_{k}" if k in right else k)
        out[name] = np.asarray(v)[l_idx]
    for k, v in right.items():
        if k == key:
            continue
        name = f"r_{k}" if k in left else k
        out[name] = np.asarray(v)[r_idx]
    return out


def ref_groupby_sum(data: dict, key: str, value_cols) -> dict:
    keys = np.asarray(data[key])
    uniq, inv = np.unique(keys, return_inverse=True)
    out = {key: uniq}
    for vc in value_cols:
        v = np.asarray(data[vc])
        acc = np.zeros((len(uniq),) + v.shape[1:], v.dtype)
        np.add.at(acc, inv, v)
        out[vc] = acc
    return out


def sorted_rows(data: dict, keys=None) -> np.ndarray:
    """Canonical row ordering for set-equality comparisons."""
    names = keys or sorted(data)
    arr = np.stack([np.asarray(data[n]).astype(np.float64) for n in names], 1)
    order = np.lexsort(arr.T[::-1])
    return arr[order]
