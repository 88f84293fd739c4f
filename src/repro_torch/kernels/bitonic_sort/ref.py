"""Oracle: a stable argsort, then the keys and the payload gathered in that
order (the torch twin of the JAX package's ``bitonic_sort/ref.py``)."""
from __future__ import annotations

import torch


def sort_ref(keys: torch.Tensor, payload: torch.Tensor):
    order = torch.argsort(keys, dim=-1, stable=True)
    return (torch.take_along_dim(keys, order, -1),
            torch.take_along_dim(payload, order, -1))
