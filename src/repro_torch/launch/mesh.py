"""Meshes over logical ranks, the JAX package's ``src/repro/launch/mesh.py``:
the production meshes and local ones.

A mesh is a :class:`~repro_torch.core.communicator.Communicator` with axes
``("data", "model")`` (``("pod", "data", "model")`` across pods).  Its
ranks are logical: all of them may share one device, as the JAX package's
host devices share one CPU, and on ``meta`` they hold shapes only (the
dry run, ``launch/dryrun.py``).
"""
from __future__ import annotations

import math

from repro_torch.core.communicator import build_communicator, logical_devices


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The JAX package's production mesh over logical ranks on ``device``
    (``cuda:0`` unless the caller names another, e.g. ``"meta"``): one pod
    is (16, 16) = 256 ranks on ``("data", "model")``, two pods (2, 16, 16)
    = 512 on ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_communicator(logical_devices(math.prod(shape), device),
                              axes=axes, shape=shape)


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` mesh of ``data * model`` logical ranks on
    ``device`` (``cuda:0`` unless the caller names another, e.g.
    ``"cpu"``), rank ``r`` at coordinates ``divmod(r, model)``."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model}): every axis needs a rank")
    return build_communicator(logical_devices(data * model, device),
                              axes=("data", "model"), shape=(data, model))
