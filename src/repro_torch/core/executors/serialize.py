"""Payload serialization for cross-process task shipping.

Two layers are deliberately kept apart:

* *protocol framing* (``protocol.py``) pickles only plain control dicts
  (strings, ints, bytes) with the stdlib pickler — version-stable and cheap.
* *payload serialization* (this module) carries the user's ``fn``/args/
  results, which may be closures or lambdas.  cloudpickle handles those by
  value; when it is absent we fall back to stdlib pickle, which restricts
  payloads to importable module-level functions (the error message says so).
"""
from __future__ import annotations

import pickle

try:
    import cloudpickle as _cp
    HAVE_CLOUDPICKLE = True
except ImportError:          # pragma: no cover - depends on environment
    _cp = None
    HAVE_CLOUDPICKLE = False


def _reject_main_refs(obj, depth: int = 2):
    """Stdlib pickle serializes a __main__-defined function BY REFERENCE,
    which dumps fine here but explodes with an opaque AttributeError inside
    the worker (whose __main__ is the worker module).  Catch the common
    shapes — the payload tuple's functions/objects — at dump time with an
    actionable error instead."""
    mod = getattr(obj, "__module__", None) or \
        getattr(type(obj), "__module__", None)
    if mod == "__main__":
        raise TypeError(
            f"task payload {obj!r} is defined in __main__ and cannot be "
            f"shipped to a worker process by stdlib pickle; install "
            f"cloudpickle or move it to an importable module")
    if depth and isinstance(obj, (tuple, list)):
        for item in obj:
            _reject_main_refs(item, depth - 1)
    elif depth and isinstance(obj, dict):
        for item in obj.values():
            _reject_main_refs(item, depth - 1)


def dumps(obj) -> bytes:
    if HAVE_CLOUDPICKLE:
        return _cp.dumps(obj)
    _reject_main_refs(obj)
    try:
        return pickle.dumps(obj)
    except Exception as e:
        raise TypeError(
            f"cannot serialize task payload without cloudpickle "
            f"({type(obj).__name__}: {e}); install cloudpickle or use "
            f"importable module-level functions") from e


def loads(data: bytes):
    # cloudpickle output is plain pickle on the wire; stdlib loads both
    return pickle.loads(data)


# --- array-leaf splitting (zero-copy collective framing) --------------------
#
# A collective payload is usually a container whose big leaves are numpy
# arrays or torch tensors and whose everything-else is small.
# ``dumps_arrays`` splits such a payload into a tiny pickled *skeleton*
# (the container structure with each
# array leaf replaced by an :class:`_ArrayRef`) plus the arrays' contiguous
# buffers, which the transport ships as raw bytes — no pickle pass over the
# MB-scale body.  ``loads_arrays`` reverses it with zero-copy
# ``np.frombuffer`` views.  Payloads with no array leaves return ``None``
# from ``dumps_arrays`` so callers take the plain pickled path.


class _ArrayRef:
    """Skeleton placeholder for an extracted array leaf; ``i`` indexes the
    side-channel buffer list.  Stdlib-picklable on purpose: skeletons must
    decode even without cloudpickle."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __reduce__(self):
        return (_ArrayRef, (self.i,))


def _as_array(leaf):
    """``leaf`` as a C-contiguous ndarray when it is raw-shippable (numpy
    array or torch tensor of a non-object dtype), else None.  A CPU tensor
    comes through ``.numpy()`` without a copy; a CUDA tensor is staged to
    the host first.  A tensor of a dtype numpy lacks (bfloat16, the float8
    types) stays a pickled leaf and comes back a tensor.  Detection is
    type-based — lists/scalars/bytes must never be promoted to arrays, or
    the round trip would change the payload's types."""
    import numpy as np
    if isinstance(leaf, np.ndarray):
        a = leaf
    elif type(leaf).__module__.split(".", 1)[0] == "torch" \
            and hasattr(leaf, "detach") and hasattr(leaf, "numpy"):
        try:
            a = leaf.detach().cpu().numpy()
        except TypeError:            # no numpy dtype: pickle the tensor
            return None
    else:
        return None
    if a.dtype.hasobject:
        return None                  # object arrays still need pickle
    return np.ascontiguousarray(a)


def _split(obj, bufs: list):
    a = _as_array(obj)
    if a is not None:
        bufs.append(a)
        return _ArrayRef(len(bufs) - 1)
    t = type(obj)
    # walk only the exact builtin containers: subclasses (namedtuples,
    # OrderedDicts with semantics, user types) stay opaque pickled leaves
    if t is dict:
        return {k: _split(v, bufs) for k, v in obj.items()}
    if t is list:
        return [_split(v, bufs) for v in obj]
    if t is tuple:
        return tuple(_split(v, bufs) for v in obj)
    return obj


def _join(obj, arrs: list):
    if isinstance(obj, _ArrayRef):
        return arrs[obj.i]
    t = type(obj)
    if t is dict:
        return {k: _join(v, arrs) for k, v in obj.items()}
    if t is list:
        return [_join(v, arrs) for v in obj]
    if t is tuple:
        return tuple(_join(v, arrs) for v in obj)
    return obj


def dumps_arrays(obj):
    """Split ``obj`` into ``(skeleton_bytes, metas, bufs)`` where ``metas``
    is ``[(dtype_str, shape), ...]`` and ``bufs`` the matching contiguous
    arrays whose raw bytes follow the header on the wire.  Returns ``None``
    when the payload holds no array leaves — plain pickle is then both
    simpler and cheaper."""
    bufs: list = []
    skel = _split(obj, bufs)
    if not bufs:
        return None
    metas = [(a.dtype.str, a.shape) for a in bufs]
    return dumps(skel), metas, bufs


def loads_arrays(skel_bytes: bytes, metas, payload):
    """Inverse of :func:`dumps_arrays` given the received body ``payload``
    (the buffers concatenated in ``metas`` order).  Array leaves come back
    as read-only ``np.frombuffer`` views aliasing ``payload`` — callers
    that mutate must copy first (same contract as the shuffle frames)."""
    import numpy as np
    arrs, off = [], 0
    for dtype, shape in metas:
        dt = np.dtype(dtype)
        count = 1
        for s in shape:
            count *= int(s)
        arrs.append(np.frombuffer(payload, dt, count=count,
                                  offset=off).reshape(shape))
        off += dt.itemsize * count
    return _join(loads(skel_bytes), arrs)


def copy_local(obj):
    """Deep copy with the exact semantics of ``loads(dumps(obj))`` — the
    result never aliases the input — but without pickling array bytes:
    array leaves short-circuit through ``np.array`` (a writable copy) and
    only the small skeleton round-trips through pickle.  This is the
    single-part collective path, the hottest pack-placement overhead."""
    import numpy as np
    bufs: list = []
    skel = _split(obj, bufs)
    if not bufs:
        return loads(dumps(obj))
    return _join(loads(dumps(skel)), [np.array(a) for a in bufs])
