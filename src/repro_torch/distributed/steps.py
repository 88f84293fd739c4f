"""The train step: loss, gradients and the AdamW update, as the JAX
package's ``distributed/steps.py::make_train_step`` builds it, on one
device or over a mesh of logical ranks.

Without a mesh, or on a one-rank mesh, the step is a plain function of
``(model, opt_state, batch)``: the model's parameters and the optimizer's
moments are updated in place (the JAX step donates its inputs and returns
new trees), and the metrics are 0-d tensors on the model's device, so the
step does not wait for the device.

On a mesh (a ``Communicator`` with ``data``/``model`` axes, and ``pod``
where there is one; ``launch/mesh.py``) the state is held as per-rank
shards, each rank exactly the block that the JAX package's rules
(``distributed/sharding.py``) give its device: ``params`` is one dict a
rank, JAX-layout path -> block, and ``opt_state`` one AdamW state a rank
(``mu``/``nu`` blocks under the same paths, a copy of ``count``).  The
data flow is FSDP/ZeRO-3's:

1. gather the parameters into one working model per device (the port's
   per-layer tensors, filled in place from the gathered JAX-layout
   leaves; the data ranks of one card share it, so it is gathered once a
   step);
2. split each microbatch by ``batch_specs`` over the dp axes, one
   contiguous block of rows a data rank (a batch that does not divide is
   replicated, as in the JAX package, and computed once), and run each
   data rank's loss and backward on its rows under ``axes_ctx`` of its
   own ranks, in data-rank order;
3. reduce the gradients to each rank's block as the f32 mean over the data
   ranks and microbatches;
4. take the global gradient norm from the owners' blocks (each element
   counted once) and update every rank's blocks in place with AdamW,
   weight decay on the leaves that are matrices in the JAX layout.

What the port does not split: in the JAX package, the compiler decides
how one data rank's compute is split over ``model``; the port has no such
compiler, and the ranks of one card run one after another.  So a data
rank's forward and backward run on the gathered whole parameters, and the
``model`` axis shards storage only.  The one exception is
``models/moe.py::moe_ffn_shardmap`` (``ParallelConfig.moe_impl =
"shardmap"``), which the JAX package writes per model rank itself: each
model rank runs its own experts and one sum combines them.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core.communicator import build_communicator, torch_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import axes_ctx, mesh_sizes
from repro_torch.models import registry
from repro_torch.models.attention import AttnMode
from repro_torch.models.convert import decayed_names, jax_layout, jax_tree
from repro_torch.train import optimizer as opt_mod

MESH_AXES = ("pod", "data", "model")


def _attn_mode(cfg: ModelConfig, parallel: ParallelConfig,
               seq_len: int) -> AttnMode:
    """The attention path the JAX train step differentiates: full up to
    1024 tokens, blockwise with ``parallel.attn_block`` tiles beyond.  On
    the card the forward runs the kernel and its backward this path."""
    if seq_len <= 1024 and not cfg.unroll_scans:
        return AttnMode(kind="full")
    blk = parallel.attn_block
    return AttnMode(kind="blockwise", q_block=blk, kv_block=blk)


class StepBundle(NamedTuple):
    fn: Any                 # fn(params, opt_state, batch) -> same + metrics
    info: dict


def _microbatches(batch: dict, mb: int) -> list:
    if mb == 1:
        return [batch]
    if any(v.shape[0] % mb for v in batch.values()):
        raise ValueError(f"batch of {len(batch['tokens'])} rows does not "
                         f"split into {mb} microbatches")
    return [dict(zip(batch, micro))
            for micro in zip(*(torch.chunk(v, mb) for v in batch.values()))]


def make_train_step(cfg: ModelConfig, parallel: ParallelConfig,
                    shape: ShapeConfig,
                    ocfg: opt_mod.OptimizerConfig | None = None, mesh=None):
    ocfg = ocfg or opt_mod.OptimizerConfig()
    if mesh is not None and mesh.size > 1:
        return _sharded_train_step(cfg, mesh, parallel, shape, ocfg)
    api = registry.get_model(cfg)
    mode = _attn_mode(cfg, parallel, shape.seq_len)
    mb = parallel.microbatches

    def loss_and_grads(params: dict, model, batch):
        loss = api.loss_fn(model, cfg, batch, mode)
        return loss, torch.autograd.grad(loss, list(params.values()))

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if mb > 1:
            # (loss, grads) / mb summed in f32 over the microbatches, as
            # the JAX step's lax.scan accumulates them
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in params.values()]
            for micro in _microbatches(batch, mb):
                l, g = loss_and_grads(params, model, micro)
                loss = loss + l.detach() / mb
                for a, gi in zip(acc, g):
                    a.add_(gi / mb)
                del g
            grads = acc
        else:
            loss, grads = loss_and_grads(params, model, batch)
            loss = loss.detach()
        _, _, metrics = opt_mod.adamw_update(
            dict(zip(params, grads)), opt_state, params, ocfg,
            decay=decayed_names(params, cfg))
        return model, opt_state, {"loss": loss, **metrics}

    return StepBundle(train_step, {"mode": mode})


# ---------------------------------------------------------------------------
# the step over a mesh
# ---------------------------------------------------------------------------
def _sharded_train_step(cfg, mesh, parallel, shape, ocfg):
    sizes = mesh_sizes(mesh)
    unknown = [a for a in sizes if a not in MESH_AXES]
    if unknown:
        raise ValueError(f"mesh axes {unknown}: a train step's mesh has the "
                         f"axes {MESH_AXES} only")
    api = registry.get_model(cfg)
    mode = _attn_mode(cfg, parallel, shape.seq_len)
    mb = parallel.microbatches
    meta = dict(registry.meta_model(cfg).named_parameters())
    pspecs = sh.flat_paths(sh.param_specs(jax_tree(meta, cfg), mesh,
                                          parallel, cfg))
    bspecs = sh.batch_specs(registry.train_batch_shapes(
        cfg, shape.global_batch, shape.seq_len), mesh, parallel)
    layout = jax_layout(meta, cfg)
    decay = {path for path, (shp, _) in layout.items() if len(shp) >= 2}
    owners = {path: sh.owners(spec, mesh) for path, spec in pspecs.items()}

    # data rank d: the ranks at data index d, a sub-mesh whose dp axes have
    # size 1 (its forward's ambient mesh), and the device its rows run on
    dp = sh.dp_axes(mesh, parallel)
    n_data = math.prod(sizes[a] for a in dp)
    coords = sh.rank_coords(mesh)
    data_of = [0] * mesh.size
    for r, c in enumerate(coords):
        for a in dp:
            data_of[r] = data_of[r] * sizes[a] + c[a]
    members = [[r for r in range(mesh.size) if data_of[r] == d]
               for d in range(n_data)]
    sub_meshes = [build_communicator(
        [mesh.devices[r] for r in ranks], axes=tuple(sizes),
        shape=tuple(1 if a in dp else n for a, n in sizes.items()))
        for ranks in members]
    data_devices = [torch_device(mesh.devices[ranks[0]]) for ranks in members]
    working = {}                      # device -> the working model there

    @torch.no_grad()
    def gather(params: list, dev) -> tuple:
        """The working model on ``dev``, its tensors filled in place from
        every leaf's blocks."""
        if dev not in working:
            working[dev] = registry.meta_model(cfg).to_empty(
                device=dev).requires_grad_(True)
        model = working[dev]
        named = dict(model.named_parameters())
        for path, (_, entries) in layout.items():
            blocks = [r[path] for r in params]
            first, idx = entries[0]
            if len(entries) == 1 and idx == ():
                sh.unshard(blocks, pspecs[path], mesh, out=named[first],
                           name=path)
                continue
            full = sh.unshard(blocks, pspecs[path], mesh, dev, name=path)
            for name, idx in entries:
                named[name].copy_(full[idx])
            del full
        return model, named

    def data_parts(micro: dict) -> list:
        """(data rank, its rows) for each data rank; one part, computed by
        data rank 0, where the rows do not divide."""
        specs = sh.batch_specs({k: (tuple(v.shape), v.dtype)
                                for k, v in micro.items()}, mesh, parallel)
        if all(s[0] is None for s in specs.values()):
            return [(0, micro)]
        return [(d, {k: v.chunk(n_data)[d] for k, v in micro.items()})
                for d in range(n_data)]

    @torch.no_grad()
    def reduce_scatter(accs: dict) -> list:
        """Each rank's block of the f32 gradient, the accumulators summed
        over devices; frees each accumulator as its leaf is placed."""
        grads = [{} for _ in range(mesh.size)]
        for path, (shp, entries) in layout.items():
            total = None
            for acc in accs.values():
                full = _stacked(acc, shp, entries, pop=True)
                total = full if total is None else \
                    total + full.to(total.device)
            for r, block in enumerate(sh.shard(total, pspecs[path], mesh,
                                               path)):
                grads[r][path] = block
            del total
        return grads

    def global_norm(grads: list) -> torch.Tensor:
        dev = data_devices[0]
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for path, ranks in owners.items():
            for r in ranks:
                sq = sq + torch.linalg.vector_norm(
                    grads[r][path], dtype=torch.float32).square().to(dev)
        return torch.sqrt(sq)

    def train_step(params: list, opt_state: list, batch: dict):
        models, accs, loss = {}, {}, None
        for micro in _microbatches(batch, mb):
            parts = data_parts(micro)
            n = mb * len(parts)
            for d, rows in parts:
                dev = data_devices[d]
                if dev not in models:
                    models[dev] = gather(params, dev)
                model, named = models[dev]
                acc = accs.setdefault(dev, {
                    k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                    for k, p in named.items()})
                rows = {k: v.to(dev) for k, v in rows.items()}
                with axes_ctx(sub_meshes[d], parallel.moe_impl,
                              parallel.dp_axes):
                    l = api.loss_fn(model, cfg, rows, mode)
                    g = torch.autograd.grad(l, list(named.values()))
                with torch.no_grad():
                    for a, gi in zip(acc.values(), g):
                        a.add_(gi, alpha=1 / n)
                del g
                l = l.detach().to(data_devices[0]) / n
                loss = l if loss is None else loss + l
        grads = reduce_scatter(accs)
        del accs
        gnorm = global_norm(grads)
        metrics = None
        for r in range(mesh.size):
            dev = torch_device(mesh.devices[r])
            _, _, m = opt_mod.adamw_update(
                grads[r], opt_state[r], params[r], ocfg, decay=decay,
                gnorm=gnorm.to(dev))
            grads[r] = None
            metrics = metrics or m
        return params, opt_state, {"loss": loss, **metrics}

    return StepBundle(train_step, {"mode": mode, "pspecs": pspecs,
                                   "bspecs": bspecs, "layout": layout})


# ---------------------------------------------------------------------------
# sharded state
# ---------------------------------------------------------------------------
def _stacked(named: dict, shp: tuple, entries: list, pop: bool = False):
    """A JAX-layout leaf from the port's tensors in ``named`` (``entries``
    of ``convert.jax_layout``): an unstacked leaf's one tensor itself, else
    a new tensor holding each at its index; ``pop`` removes them from
    ``named`` as it goes."""
    get = named.pop if pop else named.__getitem__
    first, idx = entries[0]
    if len(entries) == 1 and idx == ():
        return get(first)
    ref = named[first]
    full = torch.empty(shp, dtype=ref.dtype, device=ref.device)
    for name, idx in entries:
        full[idx] = get(name)
    return full


@torch.no_grad()
def shard_model(model, info: dict, mesh) -> list:
    """The model's parameters as per-rank blocks by ``info["pspecs"]`` (a
    sharded step's ``StepBundle.info``), one JAX-layout leaf at a time."""
    named = dict(model.named_parameters())
    out = [{} for _ in range(mesh.size)]
    for path, (shp, entries) in info["layout"].items():
        full = _stacked(named, shp, entries).detach()
        for rank, block in zip(out, sh.shard(full, info["pspecs"][path],
                                             mesh, path)):
            rank[path] = block
        del full
    return out
