"""Sharding rules: param/batch/cache trees -> partition specs, and the
placement of a tensor on a mesh's ranks by its spec; the JAX package's
``src/repro/distributed/sharding.py``.

Strategy (per ParallelConfig):
  * TP   — heads / ff / experts / vocab over the 'model' axis, with a
           divisibility fallback to replication (e.g. internvl2's 14 heads).
  * FSDP — the 'embed'-like dim of every large weight over 'data'
           (ZeRO-3 style).
  * DP   — batch dims over ('pod','data') (or what exists in the mesh).
  * KV cache — batch over DP; kv-heads over 'model' when divisible, else the
           sequence dim over 'model' (context-sharded cache).

The rules are the JAX package's name-and-shape walks, run on trees in the
JAX layout: per-layer tensors stacked on their leading axes, under the JAX
key paths (``registry.eval_params_shape`` gives that tree on ``meta``
tensors; ``models/convert.py::jax_layout`` maps it to the port's
per-layer tensors).  So every quirk of the rules carries over, among them
the expert rule matching a stacked layer axis of the reduced MoE configs
(``blocks/moe/shared/wg`` of (4, 64, 128) with 4 experts gets
``('model', 'data', None)``: the model ranks hold whole layers).

A spec is a tuple with one entry per leading dim (missing trailing entries
are None): None, an axis name, or a tuple of names, the first the major
one, with a 1-tuple written as its name, as ``PartitionSpec`` canonicalises
it.  A mesh is a ``Communicator`` with named axes (``launch/mesh.py``) or a
shape-only stand-in with ``axes`` and ``shape`` (:class:`MeshShape`).
:func:`shard` places a tensor on a mesh's ranks as ``NamedSharding`` does,
one contiguous block a rank, replicas as copies; :func:`unshard` is its
inverse.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.communicator import torch_device
from repro_torch.distributed.context import mesh_sizes

TP_AXIS = "model"
FSDP_AXIS = "data"


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without ranks: what the rules read."""
    axes: tuple
    shape: tuple


def P(*entries) -> tuple:
    """A spec, with each 1-tuple entry written as its axis name."""
    return tuple(e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                 else tuple(e) if isinstance(e, list) else e
                 for e in entries)


def mesh_axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


def _names(mesh) -> tuple:
    return tuple(mesh_sizes(mesh))


def dp_axes(mesh, parallel: ParallelConfig):
    return tuple(a for a in parallel.dp_axes if a in _names(mesh))


def _div(n: int, k: int) -> bool:
    return k > 1 and n % k == 0


def _axis_if(mesh, axis, dim_size, enabled=True):
    return axis if (enabled and axis in _names(mesh)
                    and _div(dim_size, mesh_axis_size(mesh, axis))) else None


def _fsdp_entry(mesh, parallel, dim_size):
    """Longest prefix of parallel.fsdp_axes whose product divides the dim."""
    if not parallel.fsdp:
        return None
    keep, prod = [], 1
    for a in parallel.fsdp_axes:
        n = mesh_axis_size(mesh, a)
        if a in _names(mesh) and n > 1 and dim_size % (prod * n) == 0:
            keep.append(a)
            prod *= n
    if not keep:
        return None
    return tuple(keep) if len(keep) > 1 else keep[0]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
_TP_LAST = {"wg", "wi"}         # (..., d, f): shard f (output dim)
_TP_FIRST = {"wo"}              # (..., f, d): shard f (input dim)
_REPLICATE = {"ln", "ln1", "ln2", "ln3", "final_norm", "enc_norm", "norm_w",
              "q_norm", "k_norm", "conv_b", "dt_bias", "A_log", "D",
              "shared_gate", "count"}


def _param_spec(path_keys, leaf, mesh, parallel: ParallelConfig,
                cfg: ModelConfig):
    name = path_keys[-1]
    tp_on = parallel.tensor_parallel
    shape = tuple(leaf.shape)
    nd = len(shape)

    def spec(*trailing):
        """Pad with leading Nones for stacked layer dims."""
        return P(*([None] * (nd - len(trailing)) + list(trailing)))

    if name in _REPLICATE or nd == 0:
        return P()

    if name == "embedding":                      # (V, d)
        return spec(_axis_if(mesh, TP_AXIS, shape[-2], tp_on),
                    _fsdp_entry(mesh, parallel, shape[-1]))
    if name == "lm_head":                        # (d, V)
        return spec(_fsdp_entry(mesh, parallel, shape[-2]),
                    _axis_if(mesh, TP_AXIS, shape[-1], tp_on))
    if name in ("wq", "wk", "wv"):               # (..., d, H|K, hd)
        return spec(_fsdp_entry(mesh, parallel, shape[-3]),
                    _axis_if(mesh, TP_AXIS, shape[-2], tp_on),
                    None)
    if name == "wo" and nd >= 3 and shape[-2] == cfg.head_dim:
        # attention output proj (..., H, hd, d)
        return spec(_axis_if(mesh, TP_AXIS, shape[-3], tp_on),
                    None,
                    _fsdp_entry(mesh, parallel, shape[-1]))
    if name == "router":                         # (..., d, E)
        return spec(_fsdp_entry(mesh, parallel, shape[-2]), None)
    if name in ("wg", "wi", "wo") and nd >= 3 and cfg.n_experts and \
            shape[-3] == cfg.n_experts:          # (..., E, d, f) / (..., E, f, d)
        e_ax = _axis_if(mesh, TP_AXIS, shape[-3], tp_on)
        return spec(e_ax, _fsdp_entry(mesh, parallel, shape[-2]), None)
    if name in _TP_LAST and nd >= 2:             # (..., d, f)
        return spec(_fsdp_entry(mesh, parallel, shape[-2]),
                    _axis_if(mesh, TP_AXIS, shape[-1], tp_on))
    if name in _TP_FIRST and nd >= 2:            # (..., f, d)
        return spec(_axis_if(mesh, TP_AXIS, shape[-2], tp_on),
                    _fsdp_entry(mesh, parallel, shape[-1]))
    # SSM weights: FSDP only, as in the JAX package
    if name in ("in_proj", "x_proj", "out_proj"):   # (..., big, small-or-big)
        return spec(_fsdp_entry(mesh, parallel, shape[-2]), None)
    if name == "dt_proj":                        # (..., dtr, di)
        return spec(None, _fsdp_entry(mesh, parallel, shape[-1]))
    if name == "conv_w":
        return P()
    if nd >= 2:
        # generic large 2D+: fsdp the second-to-last dim
        return spec(_fsdp_entry(mesh, parallel, shape[-2]), None)
    return P()


def _map_leaves(fn, tree, path=()):
    """``fn(key path, leaf)`` over a nested dict, in its shape."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, mesh, parallel: ParallelConfig, cfg: ModelConfig):
    """``params``: a tree in the JAX layout (tensors, ``meta`` ones will
    do); returns the same tree of specs."""
    return _map_leaves(lambda path, leaf: _param_spec(
        path, leaf, mesh, parallel, cfg), params)


def opt_specs(opt_shape, pspecs):
    """Optimizer moments shard exactly like params; count is replicated."""
    return {"mu": pspecs, "nu": pspecs, "count": P()}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------
def _dp_size(mesh, dp):
    n = 1
    for a in dp:
        n *= mesh_axis_size(mesh, a)
    return n


def batch_specs(batch_shapes, mesh, parallel: ParallelConfig):
    """``batch_shapes``: name -> (shape, dtype), as
    ``registry.train_batch_shapes`` gives them."""
    dp = dp_axes(mesh, parallel)
    out = {}
    for name, (shape, _) in batch_shapes.items():
        bdim = dp if _div(shape[0], _dp_size(mesh, dp)) else None
        out[name] = P(*([bdim] + [None] * (len(shape) - 1)))
    return out


def cache_specs(cfg: ModelConfig, cache_shape, mesh, parallel: ParallelConfig):
    """Walk the cache tree in the JAX layout (``registry.eval_cache_shape``)."""
    dp = dp_axes(mesh, parallel)
    dpn = _dp_size(mesh, dp)
    tpn = mesh_axis_size(mesh, TP_AXIS)
    tp_on = parallel.tensor_parallel

    def kv_spec(leaf):
        # (..., B, S, K, hd)
        nd = leaf.ndim
        b, s, k = leaf.shape[-4], leaf.shape[-3], leaf.shape[-2]
        b_ax = dp if _div(b, dpn) else None
        if tp_on and _div(k, tpn):
            k_ax, s_ax = TP_AXIS, None
        elif tp_on and _div(s, tpn):
            k_ax, s_ax = None, TP_AXIS
        else:
            k_ax = s_ax = None
        if b_ax is None and _div(s, dpn * (tpn if s_ax else 1)):
            # batch unshardable (e.g. long_500k B=1): context-shard over data too
            s_ax = tuple(dp) + ((TP_AXIS,) if s_ax else ())
        return P(*([None] * (nd - 4) + [b_ax, s_ax, k_ax, None]))

    def ssm_spec(leaf, kind):
        nd = leaf.ndim
        if kind == "conv":      # (..., B, k-1, C)
            b, c = leaf.shape[-3], leaf.shape[-1]
            return P(*([None] * (nd - 3) +
                       [dp if _div(b, dpn) else None, None,
                        _axis_if(mesh, TP_AXIS, c, tp_on)]))
        if cfg.ssm_version == 2:  # h: (..., B, nh, hd, st)
            b, nh = leaf.shape[-4], leaf.shape[-3]
            return P(*([None] * (nd - 4) +
                       [dp if _div(b, dpn) else None,
                        _axis_if(mesh, TP_AXIS, nh, tp_on), None, None]))
        b, di = leaf.shape[-3], leaf.shape[-2]   # h: (..., B, di, st)
        return P(*([None] * (nd - 3) +
                   [dp if _div(b, dpn) else None,
                    _axis_if(mesh, TP_AXIS, di, tp_on), None]))

    def f(path, leaf):
        name = path[-1]
        if name in ("k", "v", "xk", "xv"):
            return kv_spec(leaf)
        if name == "conv":
            return ssm_spec(leaf, "conv")
        if name == "h":
            return ssm_spec(leaf, "h")
        return P()

    return _map_leaves(f, cache_shape)


# ---------------------------------------------------------------------------
# placement: the port's counterpart of ``named`` (NamedSharding)
# ---------------------------------------------------------------------------
def flat_paths(tree, prefix=()) -> dict:
    """A nested dict's leaves under their "/"-joined key paths, the keys of
    a checkpoint's manifest; specs (tuples) are leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_paths(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


def nest_paths(flat: dict) -> dict:
    """Inverse of :func:`flat_paths`."""
    out = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def rank_coords(mesh) -> list:
    """Each rank's coordinate on each axis (axis -> index), in rank order:
    rank r sits at ``unravel_index(r, shape)``, the last axis minor."""
    sizes = mesh_sizes(mesh)
    return [dict(zip(sizes, map(int, np.unravel_index(r, tuple(
        sizes.values()))))) for r in range(math.prod(sizes.values()))]


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check(shape, spec, mesh, name: str) -> list:
    """Each dim's axes, checked: the spec fits the rank of ``shape``, names
    only mesh axes, each once, and each sharded dim splits evenly."""
    sizes = mesh_sizes(mesh)
    label = f"{name}: " if name else ""
    if len(spec) > len(shape):
        raise ValueError(f"{label}spec {spec} has more entries than the "
                         f"{len(shape)} dims of {tuple(shape)}")
    axes = [_entry_axes(e) for e in spec] + [()] * (len(shape) - len(spec))
    used = [a for names in axes for a in names]
    for a in used:
        if a not in sizes:
            raise ValueError(f"{label}spec {spec} names axis {a!r}; the "
                             f"mesh has {tuple(sizes)}")
    if len(set(used)) != len(used):
        raise ValueError(f"{label}spec {spec} uses an axis twice")
    for d, names in enumerate(axes):
        n = math.prod(sizes[a] for a in names)
        if shape[d] % n:
            raise ValueError(f"{label}dim {d} of {tuple(shape)} does not "
                             f"split into {n} blocks over {names}")
    return axes


def _block(shape, axes, sizes, coords) -> tuple:
    """The slices of the block at ``coords``: dim d's block index is the
    coordinates on its axes read as one number, the first axis major."""
    out = []
    for dim, names in zip(shape, axes):
        idx, n = 0, 1
        for a in names:
            idx = idx * sizes[a] + coords[a]
            n *= sizes[a]
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def owners(spec, mesh) -> list:
    """The ranks whose blocks tile a leaf of this spec once: those at
    coordinate 0 on every axis the spec does not use (the others hold
    copies)."""
    used = {a for e in spec for a in _entry_axes(e)}
    return [r for r, c in enumerate(rank_coords(mesh))
            if all(c[a] == 0 for a in c if a not in used)]


def shard(x: torch.Tensor, spec, mesh, name: str = "") -> list:
    """One contiguous tensor a rank, in rank order, on that rank's device:
    rank r's block of ``x`` under ``spec`` (``NamedSharding(mesh, spec)``);
    ranks that differ only on axes the spec does not use hold copies.  A
    spec that does not fit ``x`` or the mesh raises, naming ``name``."""
    axes = _check(x.shape, spec, mesh, name)
    sizes = mesh_sizes(mesh)
    out = []
    for r, c in enumerate(rank_coords(mesh)):
        block = x[_block(x.shape, axes, sizes, c)]
        out.append(block.to(torch_device(mesh.devices[r]), copy=True)
                   .contiguous())
    return out


def unshard(shards: list, spec, mesh, device=None, out=None,
            name: str = "") -> torch.Tensor:
    """Inverse of :func:`shard`: the whole tensor from the owner ranks'
    blocks, into ``out`` if given, else a new tensor on ``device`` (default:
    rank 0's shard's device)."""
    return gather_block(shards, spec, mesh, {}, device, out, name)


def model_split(spec, shape, mesh, m: int):
    """(dim, slice): the dim of a leaf of ``shape`` that ``spec`` splits
    over ``model`` and model rank m's slice of it; None where the spec
    leaves the leaf whole over ``model``.  ``model`` sharing a dim with
    another axis raises: no parameter spec does, and a rank's share of
    such a dim is not one slice."""
    for dim, entry in enumerate(spec):
        names = _entry_axes(entry)
        if TP_AXIS not in names:
            continue
        if names != (TP_AXIS,):
            raise ValueError(f"spec {spec} puts {TP_AXIS!r} on dim {dim} "
                             f"with {names}")
        step = shape[dim] // mesh_axis_size(mesh, TP_AXIS)
        return dim, slice(m * step, (m + 1) * step)
    return None


def block_of(x: torch.Tensor, spec, mesh, rank: int, name: str = ""):
    """Rank ``rank``'s block of ``x`` under ``spec``, a view of ``x``
    (:func:`shard` gives every rank's, as copies on their devices)."""
    axes = _check(x.shape, spec, mesh, name)
    return x[_block(x.shape, axes, mesh_sizes(mesh),
                    rank_coords(mesh)[rank])]


def gather_block(shards: list, spec, mesh, coords: dict, device=None,
                 out=None, name: str = "") -> torch.Tensor:
    """The block of a leaf at ``coords`` on the axes it names, whole over
    every other axis (model rank m's block: ``{"model": m}``; the whole
    leaf: ``{}``), from the owner blocks of the ranks at those coordinates,
    into ``out`` if given, else a new tensor on ``device`` (default: the
    first such rank's block's).  A spec that does not fit the leaf or the
    mesh raises, naming ``name``."""
    sizes = mesh_sizes(mesh)
    coords_of = rank_coords(mesh)
    ranks_at = [r for r, c in enumerate(coords_of)
                if all(c[a] == v for a, v in coords.items())]
    first = shards[ranks_at[0]]
    used = [_entry_axes(e) for e in spec] + [()] * (first.dim() - len(spec))
    whole = tuple(d * math.prod(sizes.get(a, 1) for a in names)
                  for d, names in zip(first.shape, used))
    _check(whole, spec, mesh, name)
    for names in used:
        if len(names) > 1 and set(names) & set(coords):
            raise ValueError(f"{name}: spec {spec} pairs an axis of "
                             f"{tuple(coords)} with another on one dim")
    rest = [tuple(a for a in names if a not in coords) for names in used]
    shape = tuple(d * math.prod(sizes[a] for a in names)
                  for d, names in zip(first.shape, rest))
    if out is None:
        out = torch.empty(shape, dtype=first.dtype,
                          device=first.device if device is None else device)
    elif tuple(out.shape) != shape:
        raise ValueError(f"{name}: out {tuple(out.shape)}, not {shape}")
    spec_axes = {a for names in used for a in names} | set(coords)
    for r in ranks_at:
        c = coords_of[r]
        if all(c[a] == 0 for a in c if a not in spec_axes):
            out[_block(shape, rest, sizes, c)].copy_(shards[r])
    return out


def shard_tree(flat: dict, specs: dict, mesh) -> list:
    """``flat``: path -> tensor; ``specs``: path -> spec.  Returns one dict
    a rank, path -> that rank's block."""
    out = [{} for _ in range(math.prod(mesh_sizes(mesh).values()))]
    for path, x in flat.items():
        for rank, block in zip(out, shard(x, specs[path], mesh, path)):
            rank[path] = block
    return out


def unshard_tree(ranks: list, specs: dict, mesh, device=None) -> dict:
    """Inverse of :func:`shard_tree`: path -> whole tensor on ``device``."""
    return {path: unshard([r[path] for r in ranks], specs[path], mesh,
                          device, name=path)
            for path in ranks[0]}
