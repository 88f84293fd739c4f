"""The six collectives of the dataframe operators over per-rank tensor lists
— the analogue of Cylon's channel layer.  Element ``r`` of each list is rank
``r``'s tensor on ``devices[r]``; traffic between two ranks is a copy
between their devices (none when they share one)."""
from __future__ import annotations

import torch


def all_to_all(xs: list, devices: list) -> list:
    """``xs[s]`` is ``(P, ...)``; rank ``r`` receives ``stack_s xs[s][r]``."""
    return [torch.stack([x[r].to(dev) for x in xs])
            for r, dev in enumerate(devices)]


def all_gather(xs: list, devices: list) -> list:
    return [torch.stack([x.to(dev) for x in xs]) for dev in devices]


def psum(xs: list, devices: list) -> list:
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return [total.to(dev) for dev in devices]


def pmax(xs: list, devices: list) -> list:
    top = xs[0]
    for x in xs[1:]:
        top = torch.maximum(top, x.to(top.device))
    return [top.to(dev) for dev in devices]


def axis_index(devices: list) -> list:
    return [torch.tensor(r, dtype=torch.int32, device=dev)
            for r, dev in enumerate(devices)]


def axis_size(devices: list) -> int:
    return len(devices)
