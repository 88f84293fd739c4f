"""The ambient mesh of a step, the JAX package's
``src/repro/distributed/context.py``.

``distributed/steps.py`` runs each data rank's loss under
``axes_ctx(mesh, moe_impl, dp)``; ``models/moe.py::moe_ffn`` reads the mesh
and ``moe_impl`` from it to pick the local-expert dispatch.  ``constrain``
and ``shard_tokens``/``shard_heads``/``shard_ff`` validate and filter a
spec as the JAX package does (``constrained_spec`` returns the result),
then hand ``x`` back unchanged: the JAX package passes the spec to its
compiler as a hint, and the port has no compiler to hint.  The state is
thread-local, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def mesh_sizes(mesh) -> dict:
    """Axis name -> size of a mesh: a ``Communicator`` (or any object with
    ``axes`` and ``shape``), or a dict of name -> size."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.axes, mesh.shape))


@contextlib.contextmanager
def axes_ctx(mesh, moe_impl: str = "gspmd", dp=("pod", "data")):
    """Accepts a ``Communicator`` or a dict name -> size; restores the
    previous state on exit."""
    is_mesh = not isinstance(mesh, dict)
    prev = (getattr(_state, "sizes", {}), getattr(_state, "mesh", None),
            getattr(_state, "moe_impl", "gspmd"),
            getattr(_state, "dp", ("pod", "data")))
    _state.sizes = mesh_sizes(mesh)
    _state.mesh = mesh if is_mesh else None
    _state.moe_impl = moe_impl
    _state.dp = tuple(dp)
    try:
        yield
    finally:
        _state.sizes, _state.mesh, _state.moe_impl, _state.dp = prev


def current_mesh():
    return getattr(_state, "mesh", None)


def current_moe_impl() -> str:
    return getattr(_state, "moe_impl", "gspmd")


def current_axes() -> dict:
    return getattr(_state, "sizes", {})


def current_dp() -> tuple:
    return getattr(_state, "dp", ("pod", "data"))


def _filter(entry, sizes, dim):
    """Keep only mesh axes that exist AND divide the dim size."""
    if entry is None:
        return None
    cand = entry if isinstance(entry, (tuple, list)) else (entry,)
    keep, prod = [], 1
    for a in cand:
        n = sizes.get(a, 0)
        if n and dim % (prod * n) == 0:
            keep.append(a)
            prod *= n
    if not keep:
        return None
    return tuple(keep) if len(keep) > 1 else keep[0]


def constrained_spec(x, *spec):
    """The spec ``constrain(x, *spec)`` applies: each entry filtered to the
    ambient mesh's axes that divide its dim; None without a mesh context
    or when no entry survives, as the JAX ``constrain`` then applies
    nothing.  A spec longer than ``x``'s rank raises."""
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has more entries than the {x.ndim} "
                         f"dims of {tuple(x.shape)}")
    sizes = current_axes()
    if not sizes:
        return None
    filtered = tuple(_filter(e, sizes, d) for e, d in zip(spec, x.shape))
    if all(e is None for e in filtered):
        return None
    return filtered


def constrain(x, *spec):
    """Validate and filter ``spec`` for ``x`` (``constrained_spec``) and
    return ``x``: no compiler takes the hint."""
    constrained_spec(x, *spec)
    return x


def shard_tokens(x):
    """Batch-shard an activation whose leading dim is (global) batch."""
    return constrain(x, current_dp(), *([None] * (x.ndim - 1)))


def shard_heads(x):
    """(B, S, H, hd): batch over DP, heads over TP."""
    dp = current_dp()
    return constrain(x, dp, None, "model" if "model" not in dp else None, None)


def shard_ff(x):
    """(..., f): batch over DP, ff/vocab dim over TP."""
    dp = current_dp()
    return constrain(x, dp, *([None] * (x.ndim - 2)),
                     "model" if "model" not in dp else None)
