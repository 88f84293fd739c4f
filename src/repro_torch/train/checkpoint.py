"""Checkpoints of tensor trees with async save, in the JAX package's format.

Layout:  <dir>/step_<N>/
           manifest.json           — leaf keys, shapes, dtypes, step
           <leaf-path>.npy         — one file per leaf

A tree is plain dict/list/tuple containers over torch tensors, numpy
arrays or scalars.  Leaf keys are the container path joined by "/", as the
JAX package flattens its trees (``src/repro/train/checkpoint.py``), so a
checkpoint written by either package restores in the other.  Tensors are
written from host copies, taken before ``save`` returns, so training may
go on updating them in place while a background thread writes.  A bfloat16
tensor is written as its raw 2-byte words under the ``<V2`` descriptor with
manifest dtype ``"bfloat16"``: the file ``np.save`` writes for an
``ml_dtypes`` bfloat16 array, which is what the JAX package saves.
``restore`` reads such a leaf back as ``torch.bfloat16``.

Crash-safety contract: a step EXISTS iff its ``manifest.json`` landed
complete — leaf files are written first, then the manifest commits the step
via tmp-file + ``os.replace``, and only then does ``LATEST`` advance (also
atomically, and only forward).  A process killed mid-save therefore leaves
either a fully restorable step or an ignorable partial dir; ``latest_step``
validates what ``LATEST`` points at and falls back to the newest step whose
manifest is complete, so a torn tail never wedges resume.

``CheckpointContext`` is the task-level face of this module: the runtime
binds one per ``(task lineage, attempt, part)`` and hands it to payloads as
``comm.checkpoint`` — each attempt writes only into its own directory, but
``latest()``/``restore()`` read across sibling attempts, so a retry or a
speculative twin resumes from whatever step the doomed primary durably
completed.

``restore(..., mesh=, specs=)`` is the elastic re-shard: each leaf that
``specs`` names is loaded whole and placed on the mesh's ranks by its spec
(``distributed/sharding.py::shard``), a list of per-rank blocks in the
restored tree, as the reference ``device_put``s each leaf with its
``NamedSharding``.  A checkpoint written on one mesh restores onto any
other: it holds whole leaves.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path

import numpy as np
import torch

STEP_FMT = "step_{:08d}"
BF16 = "bfloat16"           # manifest dtype of a raw-word bfloat16 leaf
_BF16_DESCR = "<V2"         # np.save's descriptor of an ml_dtypes bfloat16

# serializes LATEST read-modify-write within a process; cross-process safety
# comes from the runtime binding one writer (uid, attempt, part) per dir
_latest_lock = threading.Lock()


class CheckpointError(RuntimeError):
    """Structured checkpoint failure (missing leaf, no restorable step...)."""


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, bool, int,
                          float, complex))


def _check_tree(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            _check_tree(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _check_tree(v)
    elif not _is_leaf(tree):
        raise TypeError(f"checkpoint leaves are tensors, numpy arrays or "
                        f"scalars, not {type(tree).__name__}")


def _flatten(tree, path=(), out=None) -> dict:
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, path + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, path + (str(i),), out)
    else:
        out["/".join(path)] = tree
    return out


def _rebuild(like, loaded: dict, path=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, loaded, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_rebuild(v, loaded, path + (str(i),))
                for i, v in enumerate(like)]
        if hasattr(like, "_fields"):          # namedtuple
            return type(like)(*vals)
        return type(like)(vals)
    return loaded["/".join(path)]


def host_array(x, copy: bool = True) -> np.ndarray:
    """A host copy of a leaf as numpy (``copy=False``: a host tensor's own
    memory); a bfloat16 tensor as its raw words (dtype ``V2``, the bytes of
    an ``ml_dtypes`` bfloat16 array)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(x)


def tensor_from_host(a: np.ndarray, dtype_name: str | None = None,
                     device=None) -> torch.Tensor:
    """Inverse of :func:`host_array`: 2-byte void words (or ``dtype_name``
    ``"bfloat16"``) become a bfloat16 tensor.  The tensor is a copy, made
    on ``device`` in one step (no host copy first for a device)."""
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a)
    if dtype_name == BF16 or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device, copy=True)


def _dtype_name(a: np.ndarray) -> str:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return BF16
    return str(a.dtype)


def _write_leaf(path: Path, a: np.ndarray) -> None:
    if _dtype_name(a) != BF16:
        np.save(path, a)
        return
    # np.save would write a plain void array as "|V2"; the JAX package's
    # file says "<V2", so write that header over the same raw words
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": a.shape})
        f.write(np.ascontiguousarray(a).tobytes())


def _atomic_write_text(path: Path, text: str) -> None:
    tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    tmp.write_text(text)
    os.replace(tmp, path)


def _advance_latest(root: Path, step: int) -> None:
    with _latest_lock:
        cur = _read_latest(root)
        if cur is None or step > cur:
            _atomic_write_text(root / "LATEST", str(step))


def _read_latest(root: Path) -> int | None:
    try:
        return int((root / "LATEST").read_text().strip())
    except (OSError, ValueError):
        return None  # absent or torn — caller falls back to manifest scan


def _manifest_ok(d: Path, step: int | None = None) -> dict | None:
    """The step's manifest, or None unless it parses, matches ``step``, and
    every leaf file it names is present (= the step committed completely)."""
    try:
        m = json.loads((d / "manifest.json").read_text())
    except (OSError, ValueError):
        return None
    if not isinstance(m, dict) or not isinstance(m.get("leaves"), dict):
        return None
    if step is not None and m.get("step") != step:
        return None
    for meta in m["leaves"].values():
        if not (d / meta["file"]).exists():
            return None
    return m


def save(ckpt_dir, step: int, tree, *, async_: bool = True):
    """Write the tree; returns a join()-able handle (None when sync).  An
    asynchronous save takes its host copies before this returns; a
    synchronous one writes host tensors from their own memory."""
    _check_tree(tree)
    d = Path(ckpt_dir) / STEP_FMT.format(step)
    d.mkdir(parents=True, exist_ok=True)
    host = {k: host_array(v, copy=async_) for k, v in _flatten(tree).items()}

    def _write():
        manifest = {"step": step, "leaves": {}}
        for k, v in host.items():
            fname = k.replace("/", "__") + ".npy"
            _write_leaf(d / fname, v)
            manifest["leaves"][k] = {"file": fname, "shape": list(v.shape),
                                     "dtype": _dtype_name(v)}
        # commit point: the step exists once the manifest lands whole
        _atomic_write_text(d / "manifest.json", json.dumps(manifest))
        _advance_latest(Path(ckpt_dir), step)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def completed_steps(ckpt_dir) -> list[int]:
    """Ascending steps under ``ckpt_dir`` whose manifests are complete."""
    root = Path(ckpt_dir)
    steps = []
    try:
        entries = list(root.iterdir())
    except OSError:
        return []
    for d in entries:
        if not d.name.startswith("step_"):
            continue
        try:
            s = int(d.name.split("_", 1)[1])
        except ValueError:
            continue
        if _manifest_ok(d, s) is not None:
            steps.append(s)
    return sorted(steps)


def latest_step(ckpt_dir) -> int | None:
    root = Path(ckpt_dir)
    cur = _read_latest(root)
    if cur is not None and _manifest_ok(root / STEP_FMT.format(cur), cur) is not None:
        return cur
    # LATEST absent/torn/pointing at an incomplete step: trust the manifests
    steps = completed_steps(root)
    return steps[-1] if steps else None


def _as_like(a: np.ndarray, dtype_name: str, like, device):
    """A loaded leaf in the type of its ``like`` leaf: a tensor in like's
    dtype on ``device`` (default: like's own, the CPU for a meta tensor), a
    numpy array in like's dtype, or the array as loaded for a scalar."""
    if isinstance(like, torch.Tensor):
        if device is None:
            device = "cpu" if like.device.type == "meta" else like.device
        return tensor_from_host(a, dtype_name, device).to(like.dtype)
    if dtype_name == BF16:
        raise CheckpointError("a bfloat16 leaf restores into a tensor; "
                              "numpy has no bfloat16")
    want = getattr(like, "dtype", None)
    if want is not None and a.dtype != np.dtype(want):
        a = a.astype(want)      # no-op dtypes skip the copy
    return a


def restore(ckpt_dir, step: int, like, *, mesh=None, specs=None,
            device=None):
    """Load into the structure of ``like`` (a tree of tensors — meta tensors
    will do — numpy arrays or scalars), each leaf cast to its like's dtype;
    tensors land on ``device`` (default: each like's device).  With
    ``mesh`` (a ``Communicator``) and ``specs`` (a tree of specs over
    ``like``'s dicts; None for a leaf left unplaced), each leaf with a spec
    becomes the list of its per-rank blocks on the ranks' devices."""
    flat_specs = {}
    if mesh is not None and specs is not None:
        from repro_torch.distributed.sharding import flat_paths
        flat_specs = {k: v for k, v in flat_paths(specs).items()
                      if v is not None}
    d = Path(ckpt_dir) / STEP_FMT.format(step)
    manifest = _manifest_ok(d, step)
    if manifest is None:
        raise CheckpointError(
            f"no complete checkpoint for step {step} under {ckpt_dir}")
    _check_tree(like)
    flat_like = _flatten(like)
    missing = sorted(set(flat_like) - set(manifest["leaves"]))
    if missing:
        raise CheckpointError(
            f"step {step} at {d} has no leaf {missing[0]!r} required by "
            f"`like`; manifest holds {sorted(manifest['leaves'])}")
    loaded = {}
    for k, meta in manifest["leaves"].items():
        if k in flat_like:
            if k not in flat_specs:
                loaded[k] = _as_like(np.load(d / meta["file"]),
                                     meta["dtype"], flat_like[k], device)
                continue
            # a sharded leaf lands whole on rank 0's device, then is cut
            from repro_torch.distributed.sharding import shard
            whole = _as_like(np.load(d / meta["file"]), meta["dtype"],
                             flat_like[k], device if device is not None
                             else mesh.device_of(0))
            loaded[k] = shard(torch.as_tensor(whole), flat_specs[k], mesh, k)
    return _rebuild(like, loaded)


class CheckpointContext:
    """Task-level checkpoint handle, bound per ``(task lineage, attempt, part)``.

    Directory layout under the session checkpoint root::

        <root>/t<primary-uid>/p<part>-of-<n_parts>/<attempt>/step_<N>/...

    ``save`` writes only into this attempt's own directory (no cross-attempt
    write races — a doomed primary keeps appending steps while its retry is
    already up).  ``latest``/``restore`` read the whole part scope: own
    attempt first, then sibling attempts newest-step-first, which is how a
    retry (attempt ``a1``) or a speculative twin (attempt ``s<uid>``) picks
    up the primary ``a0``'s last durably completed step.  A task relaunched
    with a different part split gets a different scope and conservatively
    starts fresh.  ``resumed_from_step`` records the last step restored and
    flows back through PART_DONE → ExecEvent → TraceEvent as resume evidence.
    """

    def __init__(self, task_dir, *, attempt: str = "a0",
                 part: int = 0, n_parts: int = 1):
        self.attempt = str(attempt) or "a0"
        self.scope = Path(task_dir) / f"p{part}-of-{n_parts}"
        self.dir = self.scope / self.attempt       # this attempt's write dir
        self.resumed_from_step = 0

    def _read_dirs(self) -> list[Path]:
        try:
            siblings = [d for d in self.scope.iterdir()
                        if d.is_dir() and d != self.dir]
        except OSError:
            siblings = []
        ranked = sorted(siblings,
                        key=lambda d: latest_step(d) if latest_step(d) is not None
                        else -1, reverse=True)
        return [self.dir] + ranked

    def save(self, step: int, tree, *, async_: bool = False):
        """Durable by default: payloads report a step done only once it is
        restorable (pass ``async_=True`` to overlap with compute)."""
        return save(self.dir, step, tree, async_=async_)

    def latest(self) -> int | None:
        steps = [s for d in self._read_dirs()
                 if (s := latest_step(d)) is not None]
        return max(steps) if steps else None

    def restore(self, step: int, like, *, mesh=None, specs=None,
                device=None):
        last_err = None
        for d in self._read_dirs():
            if _manifest_ok(d / STEP_FMT.format(step), step) is None:
                continue
            try:
                tree = restore(d, step, like, mesh=mesh, specs=specs,
                               device=device)
            except CheckpointError as e:
                last_err = e
                continue
            self.resumed_from_step = max(self.resumed_from_step, step)
            return tree
        raise last_err or CheckpointError(
            f"no attempt under {self.scope} holds a complete step {step}")
