"""Oracle: stable within-bucket positions + histogram via a cumsum of the
one-hot (the torch twin of the JAX package's ``radix_partition/ref.py``).
The one-hot is taken one bucket's row at a time, so memory stays O(n)
whatever the bucket count."""
from __future__ import annotations

import torch


def radix_partition_ref(buckets: torch.Tensor, n_buckets: int):
    b = buckets.long()
    within = torch.zeros_like(b)
    hist = torch.zeros(n_buckets, dtype=torch.int64, device=b.device)
    for j in range(n_buckets):
        row = b == j                    # row j of the one-hot
        within = torch.where(row, torch.cumsum(row, 0) - 1, within)
        hist[j] = row.sum()
    return within.to(torch.int32), hist.to(torch.int32)


def destinations_ref(buckets: torch.Tensor, n_buckets: int):
    within, hist = radix_partition_ref(buckets, n_buckets)
    offsets = torch.cumsum(hist, dim=0, dtype=torch.int32) - hist
    return offsets[buckets.long()] + within, hist
