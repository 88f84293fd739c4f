"""Step builders: the train step (loss, gradients and the AdamW update),
the prefill step and the decode step, as the JAX package's
``distributed/steps.py`` builds them, on one device or over a mesh of
logical ranks.  :func:`make_step` picks one by ``shape.kind``.

Without a mesh, or on a one-rank mesh, each step is a plain function of
the model: the train step of ``(model, opt_state, batch)``, updating the
parameters and the optimizer's moments in place (the JAX step donates
its inputs and returns new trees), its metrics 0-d tensors on the model's
device, so the step does not wait for the device; the prefill and decode
steps are the family's ``prefill`` / ``decode_step``.

On a mesh (a ``Communicator`` with ``data``/``model`` axes, and ``pod``
where there is one; ``launch/mesh.py``) the state is held as per-rank
shards, each rank exactly the block that the JAX package's rules
(``distributed/sharding.py``) give its device: ``params`` is one dict a
rank, JAX-layout path -> block (``shard_model`` makes them), the train
step's ``opt_state`` one AdamW state a rank (``mu``/``nu`` blocks under
the same paths, a copy of ``count``), and a serving cache one dict a rank
under the paths of ``registry.eval_cache_shape`` (the hybrid's Mamba2
states under ``ssm/``).  The data flow is FSDP/ZeRO-3's:

1. gather the parameters into working slices, one a model rank on each
   device that runs a data rank (the port's per-layer tensors, filled in
   place): model rank m's slice holds, of each leaf whose spec puts
   ``model`` on one of its dims, the m-th block over ``model``, gathered
   over the other (FSDP) axes, and every other leaf whole
   (``SlicePlan``); the data ranks of one card share them, so they are
   gathered once a step;
2. split the rows by ``batch_specs`` over the dp axes, one contiguous
   block of rows a data rank (a batch that does not divide is
   replicated, as in the JAX package, and computed once, by data rank
   0), and run each data rank's pass on its rows under ``axes_ctx`` of
   its own ranks and ``model_group`` of the slices, in data-rank order;
3. train: reduce each slice's gradients over the data ranks and
   microbatches as the f32 mean (a split leaf's blocks side by side, a
   whole leaf's copies summed), cut them into each rank's block, take the
   global gradient norm from the owners' blocks (each element counted
   once) and update every rank's blocks in place with AdamW, weight decay
   on the leaves that are matrices in the JAX layout; prefill and decode:
   cut each data rank's cache and last-token logits into its ranks'
   blocks.

The ``model`` axis splits compute as the JAX package's compiler splits it
(Megatron-style tensor parallelism): within a data rank's pass each model
rank computes its own heads, ff columns, experts and vocabulary slice on
its slice, and the partial outputs of each row-parallel product are
summed in model-rank order (``distributed/context.py``, the models'
``over_model``/``over_heads``); what no spec splits (norms, routers, the
SSM layers, attention whose heads do not divide) runs once a data rank.
The ranks of one card run one after another.  A spec that puts ``model``
on a stacked layer axis (the reduced MoE configs, where the expert rule
meets a layer count equal to E) splits storage only: that leaf's
working copy is whole, as GSPMD gathers a scanned layer's weight before
using it.  ``ParallelConfig(tensor_parallel=False)`` puts nothing on
``model``: one whole working model a device, no group.  An MoE layer
under ``"gspmd"`` routes each data rank's tokens at their own capacity,
where the JAX step routes the whole batch at one: the two agree wherever
no (token, expert) pair is dropped.

Each sharded bundle's ``info`` carries the specs (``pspecs``, ``bspecs``,
and ``cspecs`` and ``logit_spec`` for serving; flat JAX-layout paths ->
spec), the ``layout`` (``convert.jax_layout``) and each leaf's
``dtypes``, the mesh's :class:`DataRanks`, the :class:`SlicePlan`
(``slices``), ``working(device)`` (empty working slices there) and
``data_pass``, one data rank's pass as the step runs it, which
``launch/dryrun.py`` runs alone on ``meta`` tensors (its ``share=0``
computing model rank 0's part only).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core.communicator import build_communicator, torch_device
from repro_torch.dataframe import comm
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import axes_ctx, mesh_sizes, model_group
from repro_torch.models import registry
from repro_torch.models.attention import AttnMode
from repro_torch.models.convert import decayed_names, jax_layout, jax_tree
from repro_torch.train import optimizer as opt_mod

MESH_AXES = ("pod", "data", "model")


def _attn_mode(cfg: ModelConfig, parallel: ParallelConfig,
               seq_len: int) -> AttnMode:
    """The attention path the JAX steps take: full up to 1024 tokens,
    blockwise with ``parallel.attn_block`` tiles beyond.  On the card the
    forward runs the kernel and its backward this path.  The JAX
    ``_attn_mode`` also sets ``causal_skip`` and ``unroll``; the port's
    ``AttnMode`` has neither: no config sets ``causal_skip`` (its default
    is False), and ``unroll`` serves only XLA's analysis."""
    if seq_len <= 1024 and not cfg.unroll_scans:
        return AttnMode(kind="full")
    blk = parallel.attn_block
    return AttnMode(kind="blockwise", q_block=blk, kv_block=blk)


def _smax(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Cache length: a VLM's cache holds the patch prefix and the text
    tokens."""
    return shape.seq_len + (cfg.n_patches if cfg.family == "vlm" else 0)


class StepBundle(NamedTuple):
    fn: Any                 # the step; its arguments are make_step's
    info: dict


def make_step(cfg: ModelConfig, mesh, parallel: ParallelConfig,
              shape: ShapeConfig) -> StepBundle:
    """The step of ``shape.kind``, in the JAX package's argument order."""
    if shape.kind == "train":
        return make_train_step(cfg, parallel, shape, mesh=mesh)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, parallel, shape)
    return make_decode_step(cfg, mesh, parallel, shape)


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


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
    if _sharded(mesh):
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
# a mesh's data ranks, the working model, the rows
# ---------------------------------------------------------------------------
class DataRanks(NamedTuple):
    """Data rank d: the mesh's ranks at index d of the dp axes (their
    coordinates read as one number, the first axis major), in rank order;
    a sub-mesh of them whose dp axes have size 1 (its pass's ambient
    mesh); and the device its rows run on (its first rank's)."""
    members: list
    meshes: list
    devices: list

    @property
    def n(self) -> int:
        return len(self.members)


def data_ranks(mesh, parallel: ParallelConfig) -> DataRanks:
    sizes = mesh_sizes(mesh)
    unknown = [a for a in sizes if a not in MESH_AXES]
    if unknown:
        raise ValueError(f"mesh axes {unknown}: a step's mesh has the axes "
                         f"{MESH_AXES} only")
    dp = sh.dp_axes(mesh, parallel)
    n_data = math.prod(sizes[a] for a in dp)
    data_of = [0] * mesh.size
    for r, c in enumerate(sh.rank_coords(mesh)):
        for a in dp:
            data_of[r] = data_of[r] * sizes[a] + c[a]
    members = [[r for r in range(mesh.size) if data_of[r] == d]
               for d in range(n_data)]
    meshes = [build_communicator(
        [mesh.devices[r] for r in ranks], axes=tuple(sizes),
        shape=tuple(1 if a in dp else n for a, n in sizes.items()))
        for ranks in members]
    return DataRanks(members, meshes,
                     [torch_device(mesh.devices[ranks[0]])
                      for ranks in members])


def _param_plan(cfg, mesh, parallel) -> tuple:
    """(specs, layout, dtypes): each JAX-layout leaf's spec, where the
    port's tensors sit in it and its dtype, from the model's ``meta``
    twin."""
    meta = dict(registry.meta_model(cfg).named_parameters())
    pspecs = sh.flat_paths(sh.param_specs(jax_tree(meta, cfg), mesh,
                                          parallel, cfg))
    layout = jax_layout(meta, cfg)
    return pspecs, layout, {path: meta[entries[0][0]].dtype
                            for path, (_, entries) in layout.items()}


class SlicePlan(NamedTuple):
    """How the working model splits over ``model``: ``dims`` maps each
    JAX-layout path to the dim of its port tensors that its spec splits
    over ``model`` (None: the working copy is whole, where the spec has no
    ``model`` or puts it on a stacked layer axis); ``n`` working slices a
    device, the ``model`` size where any leaf splits, else 1."""
    dims: dict
    n: int

    def split(self, path: str) -> int:
        """The leaf's split over ``model`` in a working slice."""
        return 1 if self.dims[path] is None else self.n


def slice_plan(layout: dict, pspecs: dict, mesh) -> SlicePlan:
    dims = {}
    for path, (shp, entries) in layout.items():
        hit = sh.model_split(pspecs[path], shp, mesh, 0)
        stacked = len(entries[0][1])
        dims[path] = None if hit is None or hit[0] < stacked \
            else hit[0] - stacked
    n = sh.mesh_axis_size(mesh, sh.TP_AXIS) \
        if any(d is not None for d in dims.values()) else 1
    return SlicePlan(dims, n)


def slice_shell(cfg, layout: dict, plan: SlicePlan) -> nn.Module:
    """A working slice's structure on ``meta``: the model with each split
    tensor at its block's shape (every model rank's has the same)."""
    model = registry.meta_model(cfg)
    for path, dim in plan.dims.items():
        if dim is None:
            continue
        for name, _ in layout[path][1]:
            owner, _, attr = name.rpartition(".")
            mod = model.get_submodule(owner)
            old = getattr(mod, attr)
            shape = list(old.shape)
            shape[dim] //= plan.n
            setattr(mod, attr, nn.Parameter(
                old.new_empty(shape), requires_grad=old.requires_grad))
    return model


class WorkingSlices(NamedTuple):
    """A device's working slices, model rank m's at ``slices[m]``, and
    ``split``, the ids of the lead's tensors split over ``model``: what
    ``context.model_group`` takes."""
    slices: list
    split: dict

    @property
    def lead(self):
        return self.slices[0]


def working_slices(slices: list, layout: dict, plan: SlicePlan
                   ) -> WorkingSlices:
    named = dict(slices[0].named_parameters())
    split = {id(named[name]) for path, dim in plan.dims.items()
             if dim is not None for name, _ in layout[path][1]}
    return WorkingSlices(slices, split)


@torch.no_grad()
def gather_model(model, params: list, layout: dict, pspecs: dict, mesh,
                 plan: SlicePlan, m: int):
    """Fill ``model``'s tensors in place from every leaf's blocks
    (``params``: one dict a rank): model rank m's working slice under
    ``plan`` (each split leaf's m-th block over ``model``, each other leaf
    whole, gathered over the other axes).  Returns its named
    parameters."""
    named = dict(model.named_parameters())
    dev = next(iter(named.values())).device
    for path, (_, entries) in layout.items():
        blocks = [r[path] for r in params]
        coords = {} if plan.dims[path] is None else {sh.TP_AXIS: m}
        first, idx = entries[0]
        if len(entries) == 1 and idx == ():
            sh.gather_block(blocks, pspecs[path], mesh, coords,
                            out=named[first], name=path)
            continue
        full = sh.gather_block(blocks, pspecs[path], mesh, coords, dev,
                               name=path)
        for name, idx in entries:
            named[name].copy_(full[idx])
        del full
    return named


def row_parts(batch: dict, mesh, parallel, ranks: DataRanks) -> list:
    """(data rank, its rows) for each data rank; one part, computed by
    data rank 0, where the rows do not divide (``batch_specs`` leaves the
    batch replicated)."""
    specs = sh.batch_specs({k: (tuple(v.shape), v.dtype)
                            for k, v in batch.items()}, mesh, parallel)
    if all(s[0] is None for s in specs.values()):
        return [(0, batch)]
    return [(d, {k: v.chunk(ranks.n)[d] for k, v in batch.items()})
            for d in range(ranks.n)]


# ---------------------------------------------------------------------------
# the train step over a mesh
# ---------------------------------------------------------------------------
def _sharded_train_step(cfg, mesh, parallel, shape, ocfg):
    ranks = data_ranks(mesh, parallel)
    api = registry.get_model(cfg)
    mode = _attn_mode(cfg, parallel, shape.seq_len)
    mb = parallel.microbatches
    pspecs, layout, dtypes = _param_plan(cfg, mesh, parallel)
    bspecs = sh.batch_specs(registry.train_batch_shapes(
        cfg, shape.global_batch, shape.seq_len), mesh, parallel)
    decay = {path for path, (shp, _) in layout.items() if len(shp) >= 2}
    owners = {path: sh.owners(spec, mesh) for path, spec in pspecs.items()}
    plan = slice_plan(layout, pspecs, mesh)
    working = {}                      # device -> its working slices

    def empty(dev) -> WorkingSlices:
        return working_slices([slice_shell(cfg, layout, plan).to_empty(
            device=dev).requires_grad_(True) for _ in range(plan.n)],
            layout, plan)

    def gather(params: list, dev) -> WorkingSlices:
        """The working slices on ``dev``, their tensors filled in place
        from every leaf's blocks."""
        if dev not in working:
            working[dev] = empty(dev)
        for m, model in enumerate(working[dev].slices):
            gather_model(model, params, layout, pspecs, mesh, plan, m)
        return working[dev]

    def data_pass(d: int, work: WorkingSlices, accs: list, rows: dict,
                  n: int, share: int | None = None) -> torch.Tensor:
        """Data rank d's loss and backward on its rows, each slice's
        gradients added to its accumulator in ``accs`` over ``n`` (data
        ranks x microbatches); ``share`` computes that model rank's part
        alone (the dry run)."""
        tensors = [t for model in work.slices for t in model.parameters()]
        with axes_ctx(ranks.meshes[d], parallel.moe_impl, parallel.dp_axes), \
                model_group(work.slices, work.split, share):
            l = api.loss_fn(work.lead, cfg, rows, mode)
            g = torch.autograd.grad(l, tensors, allow_unused=True)
        with torch.no_grad():
            for a, gi in zip((a for acc in accs for a in acc.values()), g):
                if gi is not None:
                    a.add_(gi, alpha=1 / n)
        return l.detach()

    @torch.no_grad()
    def reduce_scatter(accs: dict) -> list:
        """Each rank's block of the f32 gradient: each slice's accumulators
        summed over devices, a split leaf's model blocks side by side, a
        whole leaf's copies summed in model-rank order; frees each
        accumulator as its leaf is placed."""
        grads = [{} for _ in range(mesh.size)]
        for path, (shp, entries) in layout.items():
            dim = plan.dims[path]
            at = None if dim is None else len(entries[0][1]) + dim
            block = list(shp)
            if at is not None:
                block[at] //= plan.n
            parts = []
            for m in range(plan.n):
                total = None
                for acc in accs.values():
                    full = _stacked(acc[m], tuple(block), entries, pop=True)
                    total = full if total is None else \
                        total + full.to(total.device)
                parts.append(total)
            total = comm.psum(parts, [parts[0].device])[0] if at is None \
                else torch.cat(parts, at)
            del parts
            for r, b in enumerate(sh.shard(total, pspecs[path], mesh, path)):
                grads[r][path] = b
            del total
        return grads

    def global_norm(grads: list) -> torch.Tensor:
        dev = ranks.devices[0]
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for path, owner in owners.items():
            for r in owner:
                sq = sq + torch.linalg.vector_norm(
                    grads[r][path], dtype=torch.float32).square().to(dev)
        return torch.sqrt(sq)

    def train_step(params: list, opt_state: list, batch: dict):
        works, accs, loss = {}, {}, None
        for micro in _microbatches(batch, mb):
            parts = row_parts(micro, mesh, parallel, ranks)
            n = mb * len(parts)
            for d, rows in parts:
                dev = ranks.devices[d]
                if dev not in works:
                    works[dev] = gather(params, dev)
                work = works[dev]
                acc = accs.setdefault(dev, [
                    {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for k, p in model.named_parameters()}
                    for model in work.slices])
                rows = {k: v.to(dev) for k, v in rows.items()}
                l = data_pass(d, work, acc, rows, n)
                l = l.to(ranks.devices[0]) / n
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

    return StepBundle(train_step, {
        "mode": mode, "pspecs": pspecs, "bspecs": bspecs, "layout": layout,
        "dtypes": dtypes, "ranks": ranks, "slices": plan, "working": empty,
        "data_pass": data_pass})


# ---------------------------------------------------------------------------
# the prefill and decode steps
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, mesh, parallel: ParallelConfig,
                      shape: ShapeConfig) -> StepBundle:
    """``fn(params, batch) -> (cache, logits)``: the prompt's forward,
    its KV cache (or SSM states) of ``_smax`` positions and its last
    token's logits.  On a mesh ``params`` is one dict of blocks a rank
    (``shard_model``), and the cache and the logits come back the same
    way, each rank's blocks by ``cache_specs`` on
    ``registry.eval_cache_shape`` and by ``logit_spec`` (the JAX step's:
    the dp axes on rows where the batch divides, ``model`` on the
    vocabulary under tensor parallelism where it divides)."""
    api = registry.get_model(cfg)
    mode = _attn_mode(cfg, parallel, shape.seq_len)
    smax = _smax(cfg, shape)
    if not _sharded(mesh):
        @torch.no_grad()
        def prefill_step(model, batch):
            return api.prefill(model, cfg, batch, smax, mode)
        return StepBundle(prefill_step, {"mode": mode, "smax": smax})
    plan = _ServePlan(cfg, mesh, parallel, shape, smax, registry
                      .prefill_batch_shapes(cfg, shape.global_batch,
                                            shape.seq_len))

    @torch.no_grad()
    def data_pass(d: int, work: WorkingSlices, rows: dict,
                  share: int | None = None) -> tuple:
        """Data rank d's prefill of its rows: (its cache under the JAX
        layout's paths, its logits), a leaf whose spec splits the heads
        over ``model`` and logits whose spec splits the vocabulary one
        block a model rank (a list); ``share`` computes that model rank's
        part alone (the dry run)."""
        with axes_ctx(plan.ranks.meshes[d], parallel.moe_impl,
                      parallel.dp_axes), \
                model_group(work.slices, work.split, share):
            cache, logits = api.prefill(work.lead, cfg, rows, smax, mode)
        return plan.checked(_jax_cache(cfg, cache)), logits

    def prefill_step(params: list, batch: dict) -> tuple:
        cache = [{} for _ in range(mesh.size)]
        logits = plan.run(params, batch, cache, lambda d, work, rows, _:
                          data_pass(d, work, rows))
        return cache, logits

    return StepBundle(prefill_step, plan.info(mode=mode,
                                              data_pass=data_pass))


def make_decode_step(cfg: ModelConfig, mesh, parallel: ParallelConfig,
                     shape: ShapeConfig) -> StepBundle:
    """``fn(params, batch, cache) -> (logits, cache)``: one token a row
    (``batch``: ``tokens`` (B, 1), ``positions`` (B,), the write index),
    the cache written in place.  On a mesh ``params`` and ``cache`` are
    one dict of blocks a rank, as :func:`make_prefill_step` returns them,
    and each call gathers the parameters into working slices, runs
    ``decode_step`` on each data rank's rows and writes each rank's block
    back in place.  A cache leaf whose spec splits the heads over
    ``model`` stays one block a rank through the attention, as the JAX
    step keeps it, each model rank writing and attending over its own
    block (no gather); any other leaf (the sequence split over ``model``
    where the heads do not divide, the SSM states) is gathered whole for
    the data rank's rows, as the JAX package's compiler gathers it too.
    The JAX step gathers FSDP parameters every step too (GSPMD)."""
    api = registry.get_model(cfg)
    smax = _smax(cfg, shape)
    if not _sharded(mesh):
        @torch.no_grad()
        def decode_step(model, batch, cache):
            return api.decode_step(model, cfg, batch, cache)
        return StepBundle(decode_step, {"smax": smax})
    plan = _ServePlan(cfg, mesh, parallel, shape, smax,
                      registry.decode_batch_shapes(cfg, shape.global_batch))

    @torch.no_grad()
    def data_pass(d: int, work: WorkingSlices, rows: dict, cache: list,
                  split: bool, share: int | None = None) -> tuple:
        """Data rank d's decode step on its rows of the cache (``cache``:
        one dict a rank; all the ranks' where the rows are not ``split``):
        each leaf split over ``model`` on its heads as its model ranks'
        blocks, each other gathered whole; returns (its cache under the
        JAX layout's paths, its logits).  ``share`` computes that model
        rank's part alone (the dry run)."""
        dev = plan.ranks.devices[d]
        sub, members = plan.group(d, split)
        local = {path: plan.rank_blocks(cache, path, d, split, share)
                 if path in plan.own else
                 sh.unshard([cache[r][path] for r in members], spec, sub,
                            dev, name=path)
                 for path, spec in plan.cspecs.items()}
        with axes_ctx(plan.ranks.meshes[d], parallel.moe_impl,
                      parallel.dp_axes), \
                model_group(work.slices, work.split, share):
            logits, out = api.decode_step(work.lead, cfg, rows,
                                          _model_cache(local))
        return plan.checked(_jax_cache(cfg, out)), logits

    def decode_step(params: list, batch: dict, cache: list) -> tuple:
        logits = plan.run(params, batch, cache, lambda d, work, rows, split:
                          data_pass(d, work, rows, cache, split))
        return logits, cache

    return StepBundle(decode_step, plan.info(data_pass=data_pass))


def _jax_cache(cfg, cache: dict) -> dict:
    """A model's cache under the JAX layout's flat paths: the hybrid's
    Mamba2 states under ``ssm/`` (``registry.eval_cache_shape``)."""
    if cfg.family != "hybrid":
        return dict(cache)
    return {f"ssm/{k}" if k in ("conv", "h") else k: v
            for k, v in cache.items()}


def _model_cache(flat: dict) -> dict:
    """Inverse of :func:`_jax_cache`: every family's own cache is flat."""
    return {path.rsplit("/", 1)[-1]: x for path, x in flat.items()}


class _ServePlan:
    """What the prefill and decode steps share on a mesh: the specs, the
    data ranks, the working models and the placement of a data rank's
    results into its ranks' blocks."""

    def __init__(self, cfg, mesh, parallel, shape, smax, bshapes):
        self.cfg, self.mesh, self.parallel = cfg, mesh, parallel
        self.ranks = data_ranks(mesh, parallel)
        self.pspecs, self.layout, self.dtypes = _param_plan(cfg, mesh,
                                                            parallel)
        self.bspecs = sh.batch_specs(bshapes, mesh, parallel)
        self.cspecs = sh.flat_paths(sh.cache_specs(
            cfg, registry.eval_cache_shape(cfg, shape.global_batch, smax),
            mesh, parallel))
        dp = sh.dp_axes(mesh, parallel)
        self.logit_spec = sh.P(
            dp if shape.global_batch % sh._dp_size(mesh, dp) == 0 else None,
            sh._axis_if(mesh, sh.TP_AXIS, cfg.vocab_size,
                        parallel.tensor_parallel))
        self.smax = smax
        self.slices = slice_plan(self.layout, self.pspecs, mesh)
        self._shells = {}             # device -> its working slices' shells
        self._spare = []              # a shell for the first empty()
        self.own = self._held_per_rank()

    def _held_per_rank(self) -> frozenset:
        """The cache leaves the model holds one block a model rank through
        the attention: those its ``cache_init`` makes a list of
        (``attention.kv_zeros``, where the layer's ``wk`` is split), asked
        of a working slice's shell on ``meta``.  The spec of each must
        split its kv heads over ``model``."""
        if self.slices.n == 1:
            return frozenset()
        shell = slice_shell(self.cfg, self.layout, self.slices)
        work = working_slices([shell], self.layout, self.slices)
        with model_group([shell] * self.slices.n, work.split):
            cache = _jax_cache(self.cfg, registry.get_model(self.cfg)
                               .cache_init(self.cfg, 1, 1, device="meta",
                                           params=shell))
        own = frozenset(p for p, x in cache.items() if isinstance(x, list))
        for path in own:
            if sh._entry_axes(self.cspecs[path][-2]) != (sh.TP_AXIS,):
                raise RuntimeError(f"{path}: the model holds it per model "
                                   f"rank, its spec {self.cspecs[path]} "
                                   f"does not split its kv heads")
        self._spare.append(shell)
        return own

    def info(self, **extra) -> dict:
        return {"pspecs": self.pspecs, "bspecs": self.bspecs,
                "cspecs": self.cspecs, "logit_spec": self.logit_spec,
                "layout": self.layout, "dtypes": self.dtypes,
                "ranks": self.ranks, "slices": self.slices,
                "own": self.own, "working": self.empty, "smax": self.smax,
                **extra}

    def empty(self, dev) -> WorkingSlices:
        """Working slices on ``dev``, their storage uninitialised."""
        shells = self._shells.pop(dev, None) or [
            self._spare.pop() if self._spare
            else slice_shell(self.cfg, self.layout, self.slices)
            for _ in range(self.slices.n)]
        return working_slices([s.to_empty(device=dev) for s in shells],
                              self.layout, self.slices)

    def checked(self, cache: dict) -> dict:
        """A pass's cache, its leaves held one block a model rank exactly
        where ``own`` says."""
        for path, x in cache.items():
            if isinstance(x, list) != (path in self.own):
                raise RuntimeError(f"{path}: the model held it "
                                   f"{'per model rank' if isinstance(x, list) else 'whole'}"
                                   f", its spec {self.cspecs[path]} says "
                                   f"otherwise")
        return cache

    def rank_blocks(self, cache: list, path: str, d: int, split: bool,
                    share: int | None) -> list:
        """Data rank d's rows of an ``own`` leaf, one block a model rank:
        the rank's own block where it holds all of them (written in
        place), else gathered over the other axes."""
        sub, members = self.group(d, split)
        coords = sh.rank_coords(sub)
        out = []
        for m in range(self.slices.n):
            at = [r for r, c in zip(members, coords) if c[sh.TP_AXIS] == m]
            if share is not None and m != share:
                out.append(None)
            elif len(at) == 1:
                out.append(cache[at[0]][path])
            else:
                out.append(sh.gather_block(
                    [cache[r][path] for r in members], self.cspecs[path],
                    sub, {sh.TP_AXIS: m}, self.ranks.devices[d], name=path))
        return out

    @torch.no_grad()
    def run(self, params: list, batch: dict, cache: list, data_pass
            ) -> list:
        """Each data rank's ``data_pass(d, work, rows, split)`` on its
        rows in turn, on the working slices of its device; each rank's
        block of its cache goes into ``cache`` (one dict a rank: new
        blocks, or written into the blocks there), and each rank's block
        of its logits is returned."""
        logits = [None] * self.mesh.size
        parts = row_parts(batch, self.mesh, self.parallel, self.ranks)
        split = len(parts) > 1
        with _Working(self, params, {self.ranks.devices[d]
                                     for d, _ in parts}) as models:
            for d, rows in parts:
                dev = self.ranks.devices[d]
                local, out = data_pass(d, models[dev], {
                    k: v.to(dev) for k, v in rows.items()}, split)
                for path, x in local.items():
                    for r, block in self.place(x, self.cspecs[path], d,
                                               split, path):
                        if path not in cache[r]:
                            cache[r][path] = block
                        elif block is not cache[r][path]:
                            cache[r][path].copy_(block)
                del local
                for r, block in self.place(out, self.logit_spec, d, split,
                                           "logits"):
                    logits[r] = block
        return logits

    def group(self, d: int, split: bool) -> tuple:
        """(mesh, ranks) whose blocks hold data rank d's rows: its own
        sub-mesh where the rows are split, else the whole mesh."""
        if split:
            return self.ranks.meshes[d], self.ranks.members[d]
        return self.mesh, range(self.mesh.size)

    def place(self, x, spec, d: int, split: bool, name: str) -> list:
        """(rank, block) of data rank d's result ``x``: its sub-mesh's
        blocks (the dp axes, of size 1 there, cover x's rows), or the
        whole mesh's where x holds every row.  ``x`` held one block a
        model rank (a list) gives each rank its part of its model rank's
        block: that block itself the first time it is the whole part,
        else a copy."""
        sub, members = self.group(d, split)
        if not isinstance(x, list):
            return list(zip(members, sh.shard(x, spec, sub, name)))
        rest = tuple(None if e == sh.TP_AXIS else e for e in spec)
        taken, out = set(), []
        for i, (r, c) in enumerate(zip(members, sh.rank_coords(sub))):
            whole = x[c[sh.TP_AXIS]]
            part = sh.block_of(whole, rest, sub, i, name)
            if part.shape == whole.shape and whole.is_contiguous() \
                    and id(whole) not in taken:
                taken.add(id(whole))
                part = whole
            else:
                part = part.to(torch_device(self.mesh.devices[r]),
                               copy=True).contiguous()
            out.append((r, part))
        return out


class _Working:
    """The working slices of each device for the length of one step: on
    entry each device's slices get new storage (shells built once on
    ``meta``) filled from the blocks; on exit the storage goes back, so
    between steps a device holds only its ranks' blocks."""

    def __init__(self, plan: _ServePlan, params: list, devices):
        self.plan, self.params, self.devices = plan, params, devices

    def __enter__(self) -> dict:
        p, self.models = self.plan, {}
        for dev in self.devices:
            work = self.models[dev] = p.empty(dev)
            for m, model in enumerate(work.slices):
                gather_model(model, self.params, p.layout, p.pspecs, p.mesh,
                             p.slices, m)
        return self.models

    def __exit__(self, *_):
        for dev, work in self.models.items():
            self.plan._shells[dev] = [m.to("meta") for m in work.slices]
        self.models = None
        return False


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
