"""The ambient mesh of a step, the JAX package's
``src/repro/distributed/context.py``, and the model group of a data
rank's pass.

``distributed/steps.py`` runs each data rank's pass under
``axes_ctx(mesh, moe_impl, dp)``; ``models/moe.py::moe_ffn`` reads the mesh
and ``moe_impl`` from it to pick the local-expert dispatch.  ``constrain``
validates and filters a spec as the JAX package does
(``constrained_spec`` returns the result), then hands ``x`` back
unchanged: the JAX package passes the spec to its compiler as a hint, and
the port has no compiler to hint.

Where the JAX compiler splits a data rank's compute over ``model`` (each
model rank its heads, ff columns, experts and vocabulary slice, one
all-reduce after each row-parallel product), the port splits it itself:
the step enters :func:`model_group` with one working slice a model rank
(a model of the same structure whose tensors are that rank's blocks), and
the model functions ask :func:`is_split` whether a tensor of the lead
slice (rank 0's, which the pass is handed) is split, run each rank's share
through :func:`over_model` on its twin (:func:`twins`), and add the
partial outputs with :func:`model_sum`, in model-rank order.  What no spec
splits runs once, on the lead.  Without a group, or with one slice, every
one of them is a no-op.  The state is thread-local, as in the JAX package;
:func:`carried` hands it to a checkpointed body's recompute, which the
autograd engine may run on another thread.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from repro_torch.dataframe import comm

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


# ---------------------------------------------------------------------------
# the model group of a data rank's pass
# ---------------------------------------------------------------------------
class _Group(NamedTuple):
    size: int               # model ranks
    twins: dict             # id(lead group) -> [its twin in each slice]
    split: frozenset        # id of each lead tensor its spec splits
    share: int | None       # the one rank computed (a dry run), or None


@contextlib.contextmanager
def model_group(slices: list, split, share: int | None = None):
    """The model group of one data rank: ``slices[m]`` is model rank m's
    working slice (``slices[0]``, the lead, is what the pass is handed),
    ``split`` the ids of the lead tensors whose spec puts ``model`` on one
    of their dims.  ``share`` computes rank ``share``'s part alone
    (``launch/dryrun.py`` measures one rank): the others' parts are None
    and drop out of the sums.  One slice is no group."""
    prev = getattr(_state, "group", None)
    if len(slices) < 2:
        _state.group = None
    else:
        mods = [dict(s.named_modules()) for s in slices]
        twins = {id(mod): [m[name] for m in mods]
                 for name, mod in mods[0].items()}
        _state.group = _Group(len(slices), twins, frozenset(split), share)
    try:
        yield
    finally:
        _state.group = prev


def _group():
    return getattr(_state, "group", None)


def model_size() -> int:
    """The model ranks whose shares the pass computes (1 outside a group)."""
    g = _group()
    return g.size if g else 1


def is_split(t) -> bool:
    """Whether the lead tensor ``t``'s spec splits it over ``model``."""
    g = _group()
    return g is not None and id(t) in g.split


def twins(group) -> list:
    """The lead parameter group's twin in each slice, in rank order."""
    return _group().twins[id(group)]


def over_model(fn, items) -> list:
    """``fn(m, items[m])`` for each model rank m in order, m the rank whose
    share is computed; a rank a dry run does not compute gives None."""
    share = _group().share
    return [fn(m, item) if share is None or m == share else None
            for m, item in enumerate(items)]


SUM_RANGE = "model_sum"   # the profiler range around each model-rank sum


def model_sum(parts: list):
    """The all-reduce after a row-parallel product: the ranks' partial
    outputs added in rank order (None parts skipped), inside a profiler
    range named :data:`SUM_RANGE`, so that a trace can add up the device
    time of the kernels it launches."""
    parts = [p for p in parts if p is not None]
    with torch.profiler.record_function(SUM_RANGE):
        return comm.psum(parts, [parts[0].device])[0]


def model_max(parts: list):
    """The elementwise maximum over the ranks' parts (None skipped)."""
    parts = [p for p in parts if p is not None]
    return comm.pmax(parts, [parts[0].device])[0]


def carried(fn):
    """``fn`` run under this thread's ambient state as it is now, on
    whatever thread calls it."""
    saved = _snapshot()

    def run(*args, **kwargs):
        prev = _snapshot()
        _restore(saved)
        try:
            return fn(*args, **kwargs)
        finally:
            _restore(prev)
    return run


_FIELDS = ("sizes", "mesh", "moe_impl", "dp", "group")


def _snapshot() -> dict:
    return {k: getattr(_state, k) for k in _FIELDS if hasattr(_state, k)}


def _restore(saved: dict):
    for k in _FIELDS:
        if k in saved:
            setattr(_state, k, saved[k])
        elif hasattr(_state, k):
            delattr(_state, k)
