"""Partitioners: map rows -> destination rank (Cylon's shuffle targets)."""
from __future__ import annotations

import torch

from repro_torch.dataframe.ops_local import hash_key, search_image
from repro_torch.dataframe.table import Table


def hash_partition(table: Table, key: str, n_parts: int) -> torch.Tensor:
    """Destination rank per row (uint32 hash mod P); invalid rows -> 0."""
    tgt = (hash_key(table.columns[key]) % n_parts).to(torch.int32)
    return torch.where(table.valid_mask(), tgt, 0)


def range_partition(table: Table, key: str,
                    splitters: torch.Tensor) -> torch.Tensor:
    """Destination = index of the splitter range containing the key.
    splitters: (P-1,) sorted.  Used by distributed sample-sort."""
    tgt = torch.searchsorted(search_image(splitters),
                             search_image(table.columns[key]), right=True)
    return torch.where(table.valid_mask(), tgt.to(torch.int32), 0)
