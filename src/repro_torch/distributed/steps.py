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

1. gather the parameters into one working model per device (the port's
   per-layer tensors, filled in place from the gathered JAX-layout
   leaves; the data ranks of one card share it, so it is gathered once a
   step);
2. split the rows by ``batch_specs`` over the dp axes, one contiguous
   block of rows a data rank (a batch that does not divide is
   replicated, as in the JAX package, and computed once, by data rank
   0), and run each data rank's pass on its rows under ``axes_ctx`` of
   its own ranks, in data-rank order;
3. train: reduce the gradients to each rank's block as the f32 mean over
   the data ranks and microbatches, take the global gradient norm from
   the owners' blocks (each element counted once) and update every rank's
   blocks in place with AdamW, weight decay on the leaves that are
   matrices in the JAX layout; prefill and decode: cut each data rank's
   cache and last-token logits into its ranks' blocks.

What the port does not split: in the JAX package, the compiler decides
how one data rank's compute is split over ``model``; the port has no such
compiler, and the ranks of one card run one after another.  So a data
rank's pass runs on the gathered whole parameters (and, in decode, on
its rows of the cache gathered whole from its model ranks' blocks), and
the ``model`` axis shards storage only.  The one exception is
``models/moe.py::moe_ffn_shardmap`` (``ParallelConfig.moe_impl =
"shardmap"``), which the JAX package writes per model rank itself: each
model rank runs its own experts and one sum combines them.  An MoE layer
under ``"gspmd"`` routes each data rank's tokens at their own capacity,
where the JAX step routes the whole batch at one: the two agree wherever
no (token, expert) pair is dropped.

Each sharded bundle's ``info`` carries the specs (``pspecs``, ``bspecs``,
and ``cspecs`` and ``logit_spec`` for serving; flat JAX-layout paths ->
spec), the ``layout`` (``convert.jax_layout``) and each leaf's
``dtypes``, the mesh's
:class:`DataRanks` and ``data_pass``, one data rank's pass as the step
runs it, which ``launch/dryrun.py`` runs alone on ``meta`` tensors.
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


@torch.no_grad()
def gather_model(model, params: list, layout: dict, pspecs: dict, mesh):
    """Fill ``model``'s tensors in place from every leaf's blocks
    (``params``: one dict a rank); returns its named parameters."""
    named = dict(model.named_parameters())
    dev = next(iter(named.values())).device
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
    working = {}                      # device -> the working model there

    def gather(params: list, dev) -> tuple:
        """The working model on ``dev``, its tensors filled in place from
        every leaf's blocks."""
        if dev not in working:
            working[dev] = registry.meta_model(cfg).to_empty(
                device=dev).requires_grad_(True)
        model = working[dev]
        return model, gather_model(model, params, layout, pspecs, mesh)

    def data_pass(d: int, model, named: dict, acc: dict, rows: dict,
                  n: int) -> torch.Tensor:
        """Data rank d's loss and backward on its rows, the gradients
        added to ``acc`` over ``n`` (data ranks x microbatches)."""
        with axes_ctx(ranks.meshes[d], parallel.moe_impl, parallel.dp_axes):
            l = api.loss_fn(model, cfg, rows, mode)
            g = torch.autograd.grad(l, list(named.values()))
        with torch.no_grad():
            for a, gi in zip(acc.values(), g):
                a.add_(gi, alpha=1 / n)
        return l.detach()

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
        dev = ranks.devices[0]
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for path, owner in owners.items():
            for r in owner:
                sq = sq + torch.linalg.vector_norm(
                    grads[r][path], dtype=torch.float32).square().to(dev)
        return torch.sqrt(sq)

    def train_step(params: list, opt_state: list, batch: dict):
        models, accs, loss = {}, {}, None
        for micro in _microbatches(batch, mb):
            parts = row_parts(micro, mesh, parallel, ranks)
            n = mb * len(parts)
            for d, rows in parts:
                dev = ranks.devices[d]
                if dev not in models:
                    models[dev] = gather(params, dev)
                model, named = models[dev]
                acc = accs.setdefault(dev, {
                    k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                    for k, p in named.items()})
                rows = {k: v.to(dev) for k, v in rows.items()}
                l = data_pass(d, model, named, acc, rows, n)
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
        "dtypes": dtypes, "ranks": ranks, "data_pass": data_pass})


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
    def data_pass(d: int, model, rows: dict) -> tuple:
        """Data rank d's prefill of its rows: (its cache under the JAX
        layout's paths, its logits)."""
        with axes_ctx(plan.ranks.meshes[d], parallel.moe_impl,
                      parallel.dp_axes):
            cache, logits = api.prefill(model, cfg, rows, smax, mode)
        return _jax_cache(cfg, cache), logits

    def prefill_step(params: list, batch: dict) -> tuple:
        cache = [{} for _ in range(mesh.size)]
        logits = plan.run(params, batch, cache, lambda d, model, rows, _:
                          data_pass(d, model, rows))
        return cache, logits

    return StepBundle(prefill_step, plan.info(mode=mode,
                                              data_pass=data_pass))


def make_decode_step(cfg: ModelConfig, mesh, parallel: ParallelConfig,
                     shape: ShapeConfig) -> StepBundle:
    """``fn(params, batch, cache) -> (logits, cache)``: one token a row
    (``batch``: ``tokens`` (B, 1), ``positions`` (B,), the write index),
    the cache written in place.  On a mesh ``params`` and ``cache`` are
    one dict of blocks a rank, as :func:`make_prefill_step` returns them,
    and each call gathers the parameters into a working model, gathers
    each data rank's rows of the cache whole from its ranks' blocks, runs
    ``decode_step`` on them and writes each rank's block back in place.
    The JAX step gathers FSDP parameters every step too (GSPMD); it keeps
    the cache sharded over ``model`` through the attention, where the
    port, whose ``model`` axis does not split compute, gathers it."""
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
    def data_pass(d: int, model, rows: dict, cache: list,
                  split: bool) -> tuple:
        """Data rank d's decode step: its rows of the cache gathered from
        the blocks (``cache``: one dict a rank; all the ranks' where the
        rows are not ``split``), then ``decode_step``; returns (its cache
        under the JAX layout's paths, its logits)."""
        dev = plan.ranks.devices[d]
        sub, members = plan.group(d, split)
        local = {path: sh.unshard([cache[r][path] for r in members],
                                  spec, sub, dev, name=path)
                 for path, spec in plan.cspecs.items()}
        with axes_ctx(plan.ranks.meshes[d], parallel.moe_impl,
                      parallel.dp_axes):
            logits, out = api.decode_step(model, cfg, rows,
                                          _model_cache(local))
        return _jax_cache(cfg, out), logits

    def decode_step(params: list, batch: dict, cache: list) -> tuple:
        logits = plan.run(params, batch, cache, lambda d, model, rows, split:
                          data_pass(d, model, rows, cache, split))
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
        self._shells = {}             # device -> the working model's shell

    def info(self, **extra) -> dict:
        return {"pspecs": self.pspecs, "bspecs": self.bspecs,
                "cspecs": self.cspecs, "logit_spec": self.logit_spec,
                "layout": self.layout, "dtypes": self.dtypes,
                "ranks": self.ranks,
                "smax": self.smax, **extra}

    @torch.no_grad()
    def run(self, params: list, batch: dict, cache: list, data_pass
            ) -> list:
        """Each data rank's ``data_pass(d, model, rows, split)`` on its
        rows in turn, on the working model of its device; each rank's
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
                        if path in cache[r]:
                            cache[r][path].copy_(block)
                        else:
                            cache[r][path] = block
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

    def place(self, x: torch.Tensor, spec, d: int, split: bool,
              name: str) -> list:
        """(rank, block) of data rank d's result ``x``: its sub-mesh's
        blocks (the dp axes, of size 1 there, cover x's rows), or the
        whole mesh's where x holds every row."""
        sub, members = self.group(d, split)
        return list(zip(members, sh.shard(x, spec, sub, name)))


class _Working:
    """One working model per device for the length of one step: on entry
    each device's model gets new storage (a shell built once on ``meta``)
    filled from the blocks; on exit the storage goes back, so between
    steps a device holds only its ranks' blocks."""

    def __init__(self, plan: _ServePlan, params: list, devices):
        self.plan, self.params, self.devices = plan, params, devices

    def __enter__(self) -> dict:
        p, self.models = self.plan, {}
        for dev in self.devices:
            shell = p._shells.pop(dev, None) or registry.meta_model(p.cfg)
            self.models[dev] = shell.to_empty(device=dev)
            gather_model(self.models[dev], self.params, p.layout, p.pspecs,
                         p.mesh)
        return self.models

    def __exit__(self, *_):
        for dev, model in self.models.items():
            self.plan._shells[dev] = model.to("meta")
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
