"""The dry run: every (arch x shape x mesh) cell of the JAX package's
``src/repro/launch/dryrun.py`` through the port's own steps on ``meta``
tensors, one JSON a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The JAX dry run compiles each cell ahead of time on 512 host devices and
reads XLA's memory and cost analyses.  The port has no compiler: it
builds the cell's step (``distributed/steps.py::make_step``) on the
production mesh's logical ranks on ``meta`` (``launch/mesh.py``), takes
each rank's bytes from the specs, and runs one data rank's pass (the
step's own ``data_pass``) on ``meta`` tensors, which hold shapes and
dtypes and no storage.  It needs no subprocess and no XLA flags, runs on
the CPU and touches no card.  One data rank's pass stands for all of
them: every data rank's has the same shapes.

Each cell's JSON (under ``artifacts/dryrun_torch/``) has the JAX keys
where they mean the same thing (``arch``, ``shape``, ``mesh``, ``kind``,
``n_devices``, ``parallel``, ``skipped``, ``model``, ``timing``), bytes a
device with one rank a device, and:

* ``memory.argument_bytes`` / ``output_bytes``: one rank's blocks of the
  step's arguments (train: parameters, AdamW moments and count, batch;
  prefill: parameters and batch; decode: parameters, batch and cache)
  and of its outputs (train: the same state and three f32 metrics;
  prefill: cache and logits; decode: logits and cache), exact by the JAX
  rules, with their ``*_parts``; ``alias_bytes``, the outputs written into
  their arguments' storage (the train step's state, the decode step's
  cache);
* ``memory.working_bytes``, the port's own term: the working model
  gathered on every device that runs a data rank, plus the train step's
  f32 gradient accumulator.  The JAX package has no such term;
* ``memory.temp_bytes``: the peak of live bytes over one data rank's pass
  (forward and backward for train, the prefill, one decode step with its
  rows of the cache gathered), measured by :class:`LiveBytes`;
* ``memory.fits_h100``: argument + output - alias + working + temp
  against 80 GiB;
* ``collectives.per_op``: the bytes a device receives in the step's
  explicit gathers and reduce-scatters, from the specs: ``all-gather``
  for the parameters (and the decode step's cache), ``reduce-scatter``
  for the train step's f32 gradients (``(data ranks - 1)`` x the rank's
  f32 block, the JAX artifact's ring formula);
* ``flops_per_data_rank``: ``torch.utils.flop_counter.FlopCounterMode``
  over the same pass (its matrix products).  ``model`` does not divide
  it: a data rank's pass runs on the gathered whole parameters
  (``steps.py``'s docstring).

On ``meta`` the attention takes the model's plain path and the kernel
wrappers their plain versions, except ``ssm_scan``, which gives its
outputs' shapes (the closed form of the kernel's allocation): its plain
version is a Python loop over the sequence, minutes a cell at 32k tokens,
and it has no matrix products to count.

Not ported: ``parse_collectives``, ``_parse_groups`` and the two-point
``analysis_pass``.  They read XLA's HLO text and work around
``cost_analysis`` counting a scan body once; the port counts the
unrolled pass exactly.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (SHAPES, ParallelConfig, get_config,
                                 get_shape, supports_shape)
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import mesh_sizes
from repro_torch.distributed.steps import make_step
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.models.layers import _sinusoid_table

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
H100_BYTES = 80 * 2**30
METRICS = ("loss", "lr", "grad_norm")   # the train step's f32 scalars

_CELL_ORDER = [
    "internvl2-1b", "whisper-medium", "qwen3-8b", "codeqwen1.5-7b",
    "granite-3-8b", "minitron-8b", "qwen2-moe-a2.7b",
    "llama4-maverick-400b-a17b", "falcon-mamba-7b", "zamba2-7b",
]


def all_cells():
    for arch in _CELL_ORDER:
        for shape in SHAPES:
            for mesh_kind in ("single", "multi"):
                yield arch, shape, mesh_kind


def cell_path(arch, shape, mesh_kind, tag="baseline") -> Path:
    return ART_DIR / f"{arch}__{shape}__{mesh_kind}__{tag}.json"


def skip_reason(cfg, shape) -> str:
    """The JAX dry run's text for a cell that ``supports_shape`` rejects."""
    return (f"{shape.name} requires sub-quadratic state; {cfg.family} arch "
            f"is full-attention (DESIGN.md)")


# ---------------------------------------------------------------------------
# bytes from the specs
# ---------------------------------------------------------------------------
def _split(spec, mesh) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for e in spec for a in sh._entry_axes(e))


def block_shape(shape, spec, mesh) -> tuple:
    """A rank's block of a leaf of ``shape`` under ``spec``: every rank's
    is the same (a spec splits its dims evenly)."""
    sizes = mesh_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes[a] for a in sh._entry_axes(e))
                 for d, e in zip(shape, entries))


def _bytes(shape, dtype, spec, mesh) -> int:
    return math.prod(shape) // _split(spec, mesh) * dtype.itemsize


def batch_shapes(cfg, shape) -> dict:
    """The step's batch: name -> (shape, dtype)."""
    b = shape.global_batch
    if shape.kind == "train":
        return registry.train_batch_shapes(cfg, b, shape.seq_len)
    if shape.kind == "prefill":
        return registry.prefill_batch_shapes(cfg, b, shape.seq_len)
    return registry.decode_batch_shapes(cfg, b)


def step_bytes(cfg, shape, mesh, parallel) -> tuple:
    """(memory, bundle): the cell's step, and one rank's bytes of its
    arguments and outputs by part, exact by the step's specs, with each
    data-rank device's working bytes and collective traffic (``per_op``)."""
    bundle = make_step(cfg, mesh, parallel, shape)
    info = bundle.info
    layout, pspecs, dtype = info["layout"], info["pspecs"], info["dtypes"]
    params = sum(_bytes(shp, dtype[p], pspecs[p], mesh)
                 for p, (shp, _) in layout.items())
    n_params = sum(math.prod(shp) for shp, _ in layout.values())
    whole = sum(math.prod(shp) * dtype[p].itemsize
                for p, (shp, _) in layout.items())
    batch = sum(_bytes(shp, dt, info["bspecs"][k], mesh)
                for k, (shp, dt) in batch_shapes(cfg, shape).items())
    gather = {"count": sum(_split(s, mesh) > 1 for s in pspecs.values()),
              "traffic_bytes": sum(
                  math.prod(shp) * dtype[p].itemsize
                  - _bytes(shp, dtype[p], pspecs[p], mesh)
                  for p, (shp, _) in layout.items())}
    per_op = {"all-gather": gather}
    n_data = info["ranks"].n
    if shape.kind == "train":
        moments = sum(2 * _bytes(shp, torch.float32, pspecs[p], mesh)
                      for p, (shp, _) in layout.items())
        count = torch.int32.itemsize
        metrics = len(METRICS) * torch.float32.itemsize
        args = {"params": params, "opt_state": moments + count,
                "batch": batch}
        outs = {"params": params, "opt_state": moments + count,
                "metrics": metrics}
        alias = params + moments + count
        working = whole + 4 * n_params
        per_op["reduce-scatter"] = {
            "count": len(layout) if n_data > 1 else 0,
            "traffic_bytes": (n_data - 1) * moments // 2}
    else:
        smax = info["smax"]
        cache_shape = sh.flat_paths(registry.eval_cache_shape(
            cfg, shape.global_batch, smax))
        cache = sum(_bytes(t.shape, t.dtype, info["cspecs"][p], mesh)
                    for p, t in cache_shape.items())
        head = dtype.get("embed/lm_head", dtype["embed/embedding"])
        logits = _bytes((shape.global_batch, cfg.vocab_size), head,
                        info["logit_spec"], mesh)
        args = {"params": params, "batch": batch}
        working = whole
        if shape.kind == "prefill":
            outs, alias = {"cache": cache, "logits": logits}, 0
        else:
            args["cache"] = cache
            outs, alias = {"logits": logits, "cache": cache}, cache
            # each data rank's rows of the cache, gathered from its ranks
            rows = _data_rows(shape.global_batch, info)
            per_op["all-gather"] = {
                "count": gather["count"] + sum(
                    _split(s, mesh) > 1 for s in info["cspecs"].values()),
                "traffic_bytes": gather["traffic_bytes"] + sum(
                    math.prod(t.shape) * t.dtype.itemsize * rows
                    // shape.global_batch
                    - _bytes(t.shape, t.dtype, info["cspecs"][p], mesh)
                    for p, t in cache_shape.items())}
    return {"argument_bytes": sum(args.values()), "argument_parts": args,
            "output_bytes": sum(outs.values()), "output_parts": outs,
            "alias_bytes": alias, "working_bytes": working,
            "per_op": per_op}, bundle


def _data_rows(batch: int, info) -> int:
    """The rows one data rank runs: its share where the batch divides
    over the data ranks, else all of them."""
    n = info["ranks"].n
    return batch // n if n > 1 and batch % n == 0 else batch


# ---------------------------------------------------------------------------
# one data rank's pass on meta
# ---------------------------------------------------------------------------
class LiveBytes(TorchDispatchMode):
    """The peak of live bytes of the storages that the ops run inside the
    mode create.  Each op's outputs are looked at: a storage not seen
    before, and not among ``exclude``'s (the step's inputs), is counted
    from then on, and a ``weakref.finalize`` on its Python object (which
    PyTorch keeps alive exactly as long as the storage itself) takes it
    off when the storage is freed.  A storage, not a tensor, is the unit:
    views share their base's storage and free nothing."""

    def __init__(self, exclude=()):
        super().__init__()
        self.seen = {t.untyped_storage()._cdata for t in exclude}
        self.now = self.peak = 0

    def _free(self, key: int, nbytes: int):
        self.seen.discard(key)
        self.now -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.seen:
                continue
            self.seen.add(key)
            self.now += st.nbytes()
            weakref.finalize(st, self._free, key, st.nbytes())
        self.peak = max(self.peak, self.now)
        return out


def _meta_batch(shapes: dict, rows: int) -> dict:
    return {k: torch.empty((rows,) + tuple(shp[1:]), dtype=dt, device="meta")
            for k, (shp, dt) in shapes.items()}


def _meta_blocks(cfg, info, mesh, shape, members) -> list:
    """Meta cache blocks of the ranks ``members`` (None elsewhere)."""
    cache = sh.flat_paths(registry.eval_cache_shape(
        cfg, shape.global_batch, info["smax"]))
    out = [None] * mesh.size
    for r in members:
        out[r] = {p: torch.empty(block_shape(t.shape, info["cspecs"][p],
                                             mesh), dtype=t.dtype,
                                 device="meta")
                  for p, t in cache.items()}
    return out


def group_size(cfg) -> int:
    """Layers in one group of the stack: a hybrid group, an MoE
    superblock, else one layer (the encoder-decoder: one encoder and one
    decoder layer)."""
    return cfg.shared_attn_period if cfg.family == "hybrid" \
        else cfg.moe_layer_period


def depth_cfg(cfg, groups: int):
    """``cfg`` cut to ``groups`` groups of its stack."""
    kw = {"n_layers": groups * group_size(cfg)}
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = groups
    return dataclasses.replace(cfg, **kw)


def run_pass(cfg, shape, mesh, parallel) -> dict:
    """Data rank 0's pass of the step on ``meta``: its temp bytes (the
    peak of what the pass allocates) and its FLOPs, at the config's depth.

    A prefill or decode pass holds the cache at its full depth from its
    start (the decode step's gathered rows too) and one layer's
    temporaries at a time, so both numbers grow linearly with the number
    of layer groups past the first (the first group's input is the
    embedding's output, so one group alone can peak lower).  A stack of G
    > 3 groups is run at 2 and 3 groups and extrapolated, f(G) = f(2) +
    (f(3) - f(2)) (G - 2), the JAX analysis pass's two points: ``meta`` ops
    run through Python reference implementations, about a millisecond an
    op, and a 36-layer prefill of 32k tokens would take twenty minutes a
    cell.  A train pass runs whole: its peak is the larger of the
    activations' and the gradients' (the backward returns every
    parameter's gradient at once), and which one wins moves with the
    depth.  So does an encoder-decoder whose stacks differ in depth.
    ``tests/test_torch_dryrun.py`` holds the extrapolation to the whole
    pass."""
    n_groups = cfg.n_layers // group_size(cfg)
    whole = (n_groups <= 3 or shape.kind == "train"
             or cfg.n_encoder_layers and cfg.n_encoder_layers != n_groups)
    t0 = time.time()
    if whole:
        out = _pass_at(cfg, shape, mesh, parallel)
    else:
        two, three = (_pass_at(depth_cfg(cfg, k), shape, mesh, parallel)
                      for k in (2, 3))
        out = {k: two[k] + (three[k] - two[k]) * (n_groups - 2)
               for k in two}
    return dict(out, pass_s=time.time() - t0)


def _pass_at(cfg, shape, mesh, parallel) -> dict:
    bundle = make_step(cfg, mesh, parallel, shape)
    info = bundle.info
    model = registry.meta_model(cfg).requires_grad_(shape.kind == "train")
    rows = _data_rows(shape.global_batch, info)
    batch = _meta_batch(batch_shapes(cfg, shape), rows)
    split = rows != shape.global_batch
    named = dict(model.named_parameters())
    exclude = list(named.values()) + list(batch.values())
    if shape.kind == "train":
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device="meta")
               for k, p in named.items()}
        exclude += list(acc.values())
        n = parallel.microbatches * (info["ranks"].n if split else 1)
        micro = {k: v[:rows // parallel.microbatches]
                 for k, v in batch.items()}

        def run():
            info["data_pass"](0, model, named, acc, micro, n)
    elif shape.kind == "prefill":
        def run():
            info["data_pass"](0, model, batch)
    else:
        members = (info["ranks"].members[0] if split
                   else range(mesh.size))
        blocks = _meta_blocks(cfg, info, mesh, shape, members)
        exclude += [t for b in blocks if b for t in b.values()]

        def run():
            info["data_pass"](0, model, batch, blocks, split)
    # each pass allocates the position tables it reads, as a process's
    # first step does (whisper's decoder keeps one a length, layers.py)
    _sinusoid_table.cache_clear()
    live = LiveBytes(exclude)
    flops = FlopCounterMode(display=False)
    # a storage held in a reference cycle is freed when the collector runs:
    # held off, it is freed at the pass's end, the same in every run
    collecting = gc.isenabled()
    gc.disable()
    try:
        with flops, live:
            run()
    finally:
        if collecting:
            gc.enable()
    return {"temp_bytes": live.peak, "flops": flops.get_total_flops()}


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, mesh_kind: str = "single",
             parallel_overrides=None, out_path: Path | None = None,
             verbose: bool = True, model_overrides=None, *, cfg=None,
             mesh=None) -> dict:
    """One cell's record (see the module's docstring).  ``shape_name``
    names one of ``SHAPES`` or is a ``ShapeConfig``; ``cfg`` and ``mesh``
    replace the arch's published config and the production mesh of
    ``mesh_kind`` (tests run reduced configs on small meshes, the card's
    smoke run its own cells)."""
    cfg = cfg or get_config(arch)
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    shape = get_shape(shape_name) if isinstance(shape_name, str) \
        else shape_name
    shape_name = shape.name
    if not supports_shape(cfg, shape):
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "skipped": True, "reason": skip_reason(cfg, shape)}
        _write(result, out_path)
        return result
    mesh = mesh or make_production_mesh(multi_pod=mesh_kind == "multi",
                                        device="meta")
    parallel = ParallelConfig(**(parallel_overrides or {}))
    t0 = time.time()
    mem, bundle = step_bytes(cfg, shape, mesh, parallel)
    per_op = mem.pop("per_op")
    timing = {"build_s": time.time() - t0}
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "n_devices": mesh.size,
        "mesh_shape": dict(mesh_sizes(mesh)),
        "parallel": dataclasses.asdict(parallel),
        "model_overrides": model_overrides or {},
        "skipped": False,
        "data_ranks": bundle.info["ranks"].n,
        "rows_per_data_rank": _data_rows(shape.global_batch, bundle.info),
        "memory": mem,
        "collectives": {
            "per_op": per_op,
            "traffic_bytes_per_device": sum(
                v["traffic_bytes"] for v in per_op.values())},
        "model": {"params": cfg.param_count(),
                  "active_params": cfg.active_param_count()},
        "timing": timing,
    }
    p = run_pass(cfg, shape, mesh, parallel)
    mem["temp_bytes"] = p["temp_bytes"]
    mem["total_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                          - mem["alias_bytes"] + mem["working_bytes"]
                          + mem["temp_bytes"])
    mem["fits_h100"] = mem["total_bytes"] <= H100_BYTES
    result["flops_per_data_rank"] = p["flops"]
    timing["pass_s"] = p["pass_s"]
    _write(result, out_path)
    if verbose:
        print(json.dumps({k: result[k] for k in
                          ("arch", "shape", "mesh", "memory")}), flush=True)
    return result


def _write(result: dict, out_path):
    if out_path:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--parallel", default=None,
                    help="JSON dict of ParallelConfig overrides")
    ap.add_argument("--model", default=None,
                    help="JSON dict of ModelConfig overrides")
    args = ap.parse_args(argv)
    overrides = json.loads(args.parallel) if args.parallel else None
    m_overrides = json.loads(args.model) if args.model else None
    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        run_cell(args.arch, args.shape, args.mesh, overrides,
                 cell_path(args.arch, args.shape, args.mesh, args.tag),
                 model_overrides=m_overrides)
        return 0
    failures, records = [], []
    for arch, shape, mesh_kind in all_cells():
        out = cell_path(arch, shape, mesh_kind, args.tag)
        if out.exists() and not args.force:
            print(f"skip (cached): {out.name}")
            records.append(json.loads(out.read_text()))
            continue
        print(f"=== {arch} x {shape} x {mesh_kind}", flush=True)
        try:
            records.append(run_cell(arch, shape, mesh_kind, overrides, out,
                                    model_overrides=m_overrides))
        except Exception as e:           # one cell's fault; go on
            print(f"FAILED {arch} x {shape} x {mesh_kind}: {e!r}",
                  flush=True)
            failures.append((arch, shape, mesh_kind))
    print(summary(records))
    if failures:
        print("FAILED CELLS:", failures)
        return 1
    print("all cells OK")
    return 0


def summary(records: list) -> str:
    """A markdown table of the cells: whether each fits an H100, and its
    GB a device (10^9 bytes) by term."""
    rows = ["| arch | shape | mesh | fits_h100 | total | arguments | "
            "working | temp |", "| --- | --- | --- | --- | --- | --- | --- "
            "| --- |"]
    for r in records:
        if r["skipped"]:
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"skipped | | | | |")
            continue
        m = r["memory"]
        gb = [f"{m[k] / 1e9:.2f}" for k in ("total_bytes", "argument_bytes",
                                            "working_bytes", "temp_bytes")]
        rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                    f"{'yes' if m['fits_h100'] else 'no'} | "
                    + " | ".join(gb) + " |")
    return "\n".join(rows)


if __name__ == "__main__":
    sys.exit(main())
