"""Local meshes over logical ranks, the JAX package's
``src/repro/launch/mesh.py::make_local_mesh``.

A mesh is a :class:`~repro_torch.core.communicator.Communicator` with axes
``("data", "model")``.  Its ranks are logical: all of them may share one
device, as the JAX package's host devices share one CPU.
"""
from __future__ import annotations

from repro_torch.core.communicator import build_communicator, logical_devices


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` mesh of ``data * model`` logical ranks on
    ``device`` (``cuda:0`` unless the caller names another, e.g.
    ``"cpu"``), rank ``r`` at coordinates ``divmod(r, model)``."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model}): every axis needs a rank")
    return build_communicator(logical_devices(data * model, device),
                              axes=("data", "model"), shape=(data, model))
