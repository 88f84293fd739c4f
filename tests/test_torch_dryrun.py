"""The port's dry run (``repro_torch.launch.dryrun``) and production mesh
against the JAX package's rules, on the CPU.

Every arch x shape x mesh cell at the published widths: each rank's
bytes of the step's arguments and outputs equal, exactly, the sum of the
JAX blocks' bytes, the blocks being ``NamedSharding(AbstractMesh(...),
spec).shard_shape`` of the JAX package's ``param_specs`` / ``opt_specs``
/ ``batch_specs`` / ``cache_specs`` over ``jax.eval_shape`` trees (no
device, no compile).  Then whole cells on reduced configs at a (4, 2)
mesh of ``meta`` ranks: the JSON's keys, the FLOPs of a dense decode step
against their closed form (exactly: the counter adds integer products),
the two-point depth extrapolation against the whole pass, and the kernel
wrappers on ``meta`` tensors.
"""
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import repro.launch.mesh as jax_mesh
from repro.configs import ParallelConfig as JParallel
from repro.configs import get_config as jget
from repro.configs import get_shape as jget_shape
from repro.distributed import sharding as jsh
from repro.models import registry as jreg
from repro.train import optimizer as jopt

from repro_torch.configs import (SHAPES, ParallelConfig, get_config,
                                 get_shape, reduced, supports_shape)
from repro_torch.kernels.bitonic_sort import ops as bitonic_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.radix_partition import ops as radix_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
FAMILY_CELLS = [("qwen3-8b", "decode_32k"), ("qwen2-moe-a2.7b", "train_4k"),
                ("falcon-mamba-7b", "prefill_32k"),
                ("zamba2-7b", "long_500k"), ("internvl2-1b", "train_4k"),
                ("whisper-medium", "decode_32k")]


def _meta_mesh(d=4, m=2):
    return make_local_mesh(d, m, device="meta")


# ---------------------------------------------------------------------------
# the production mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi", [False, True])
def test_make_production_mesh_has_the_jax_shapes_and_axes(multi,
                                                          monkeypatch):
    """The JAX function's own arguments to ``jax.make_mesh`` (captured:
    this process has no 512 devices) against the port's mesh."""
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes, **_: (
        tuple(shape), tuple(axes)))
    shape, axes = jax_mesh.make_production_mesh(multi_pod=multi)
    m = make_production_mesh(multi_pod=multi, device="meta")
    assert (m.shape, m.axes, m.size) == (shape, axes, int(np.prod(shape)))
    assert all(d.device.type == "meta" for d in m.devices)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_production_mesh(multi_pod=multi)


# ---------------------------------------------------------------------------
# every cell's bytes against the JAX blocks
# ---------------------------------------------------------------------------
def _nbytes(tree, specs, am) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs,
                                  is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    return sum(int(np.prod(NamedSharding(am, s).shard_shape(x.shape)))
               * x.dtype.itemsize for x, s in zip(leaves, spec_leaves))


@functools.lru_cache(maxsize=None)
def _jax_model(arch) -> tuple:
    """The JAX config, its parameters' tree on ``jax.eval_shape`` and its
    logits' dtype (the JAX prefill's, traced at 8 tokens)."""
    cfg = jget(arch)
    pshape = jreg.eval_params_shape(cfg)
    small = {k: jax.ShapeDtypeStruct((1,) + s[1:], dt) for k, (s, dt) in
             jreg.prefill_batch_shapes(cfg, 1, 8).items()}
    logits = jax.eval_shape(lambda p, x: jreg.get_model(cfg).prefill(
        p, cfg, x, 8 + (cfg.n_patches if cfg.family == "vlm" else 0)),
        pshape, small)[1]
    return cfg, pshape, jnp.dtype(logits.dtype)


def _jax_bytes(arch, shape_name, mesh_kind) -> tuple:
    """(argument bytes, output bytes) of one rank by the JAX rules, the
    JAX step builders' trees and specs (``steps.py``)."""
    (cfg, pshape, ldtype), shape = _jax_model(arch), jget_shape(shape_name)
    grid, axes = MESHES[mesh_kind]
    am = AbstractMesh(grid, axes)
    mesh = types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(grid, dtype=object))
    par = JParallel()
    params = _nbytes(pshape, jsh.param_specs(pshape, mesh, par, cfg), am)
    b = shape.global_batch
    if shape.kind == "train":
        bshapes = jreg.train_batch_shapes(cfg, b, shape.seq_len)
    elif shape.kind == "prefill":
        bshapes = jreg.prefill_batch_shapes(cfg, b, shape.seq_len)
    else:
        bshapes = jreg.decode_batch_shapes(cfg, b)
    btree = {k: jax.ShapeDtypeStruct(s, dt) for k, (s, dt) in
             bshapes.items()}
    batch = _nbytes(btree, jsh.batch_specs(bshapes, mesh, par), am)
    if shape.kind == "train":
        oshape = jax.eval_shape(jopt.adamw_init, pshape)
        opt = _nbytes(oshape, jsh.opt_specs(
            oshape, jsh.param_specs(pshape, mesh, par, cfg)), am)
        metrics = 3 * 4       # loss, lr, grad_norm: f32 scalars, P()
        return params + opt + batch, params + opt + metrics
    smax = shape.seq_len + (cfg.n_patches if cfg.family == "vlm" else 0)
    cshape = jreg.eval_cache_shape(cfg, b, smax)
    cache = _nbytes(cshape, jsh.cache_specs(cfg, cshape, mesh, par), am)
    dp = jsh.dp_axes(mesh, par)
    lspec = JP(dp if b % jsh._dp_size(mesh, dp) == 0 else None,
               jsh._axis_if(mesh, jsh.TP_AXIS, cfg.vocab_size,
                            par.tensor_parallel))
    logits = int(np.prod(NamedSharding(am, lspec).shard_shape(
        (b, cfg.vocab_size)))) * ldtype.itemsize
    if shape.kind == "prefill":
        return params + batch, cache + logits
    return params + batch + cache, logits + cache


@pytest.mark.parametrize("arch", dryrun._CELL_ORDER)
def test_every_cell_holds_the_jax_blocks_bytes(arch):
    cfg = get_config(arch)
    for shape_name in SHAPES:
        shape = get_shape(shape_name)
        if not supports_shape(cfg, shape):
            assert cfg.family not in ("ssm", "hybrid")
            continue
        for mesh_kind in MESHES:
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                        device="meta")
            mem, _ = dryrun.step_bytes(cfg, shape, mesh, ParallelConfig())
            args, outs = _jax_bytes(arch, shape_name, mesh_kind)
            assert (mem["argument_bytes"], mem["output_bytes"]) == (
                args, outs), (shape_name, mesh_kind)


def test_a_skipped_cell_carries_the_jax_reason(tmp_path):
    """The JAX dry run's own text, read from its source (importing it
    would set XLA_FLAGS in this process)."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    assert ('f"{shape_name} requires sub-quadratic state; "\n'
            '                            f"{cfg.family} arch is '
            'full-attention (DESIGN.md)"') in src
    out = tmp_path / "cell.json"
    got = dryrun.run_cell("qwen3-8b", "long_500k", "single", out_path=out,
                          verbose=False)
    assert got == json.loads(out.read_text()) == {
        "arch": "qwen3-8b", "shape": "long_500k", "mesh": "single",
        "skipped": True, "reason": "long_500k requires sub-quadratic "
        "state; dense arch is full-attention (DESIGN.md)"}


# ---------------------------------------------------------------------------
# whole cells on reduced configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape_name", FAMILY_CELLS)
def test_a_reduced_cell_writes_its_record(arch, shape_name, tmp_path):
    out = tmp_path / "cell.json"
    rec = dryrun.run_cell(arch, shape_name, "single", out_path=out,
                          verbose=False, cfg=reduced(get_config(arch)),
                          mesh=_meta_mesh())
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert {"arch", "shape", "mesh", "kind", "n_devices", "parallel",
            "skipped", "model", "timing", "memory", "collectives",
            "flops_per_data_rank"} <= set(rec)
    mem = rec["memory"]
    assert {"argument_bytes", "output_bytes", "working_bytes", "temp_bytes",
            "alias_bytes", "total_bytes", "fits_h100"} <= set(mem)
    assert mem["total_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                  - mem["alias_bytes"] + mem["working_bytes"]
                                  + mem["temp_bytes"])
    assert mem["fits_h100"] == (mem["total_bytes"] <= 80 * 2**30)
    assert mem["temp_bytes"] > 0 and rec["flops_per_data_rank"] > 0
    assert rec["n_devices"] == 8 and not rec["skipped"]
    assert set(rec["collectives"]["per_op"]) <= {"all-gather",
                                                 "reduce-scatter"}
    if rec["kind"] == "train":
        assert rec["collectives"]["per_op"]["reduce-scatter"][
            "traffic_bytes"] > 0


def test_dense_decode_flops_equal_their_closed_form():
    """One data rank's decode step of the reduced qwen3-8b (16 of 128 rows
    on 4 data ranks, 32 768 cache positions): 2 x rows x the matrix
    parameters (q, k, v, o, the MLP and the head; the embedding is a
    lookup) plus, a layer, the scores and the weighted sum over every
    cached position, 2 x 2 x rows x H x hd x smax.  Exactly."""
    cfg = reduced(get_config("qwen3-8b"))
    shape = get_shape("decode_32k")
    rec = dryrun.run_cell("qwen3-8b", "decode_32k", "single", cfg=cfg,
                          mesh=_meta_mesh(), verbose=False)
    rows = shape.global_batch // 4
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = d * h * hd + 2 * d * k * hd + h * hd * d + 3 * d * cfg.d_ff
    matmul = cfg.n_layers * layer + d * cfg.vocab_size
    attention = cfg.n_layers * 4 * rows * h * hd * shape.seq_len
    assert rec["flops_per_data_rank"] == 2 * rows * matmul + attention


@pytest.mark.parametrize("arch,shape_name", [
    ("whisper-medium", "decode_32k"), ("falcon-mamba-7b", "prefill_32k"),
    ("qwen2-moe-a2.7b", "decode_32k")])
def test_depth_extrapolation_equals_the_whole_pass(arch, shape_name):
    """Five groups: run whole, and from the passes at two and three."""
    cfg = dryrun.depth_cfg(reduced(get_config(arch)), 5)
    args = (cfg, get_shape(shape_name), _meta_mesh(), ParallelConfig())
    whole = dryrun._pass_at(*args)
    got = dryrun.run_pass(*args)
    assert {k: got[k] for k in whole} == whole


def test_decode_cell_counts_the_cache_gather():
    """The decode step gathers a data rank's rows of the cache from its
    model ranks' blocks: the all-gather carries them beside the
    parameters, and the pass holds them."""
    cfg = reduced(get_config("qwen3-8b"))
    rec = dryrun.run_cell("qwen3-8b", "decode_32k", "single", cfg=cfg,
                          mesh=_meta_mesh(), verbose=False)
    mem = rec["memory"]
    cache_block = mem["argument_parts"]["cache"]
    rows_cache = cache_block * 2          # the block's 2 model ranks
    gather = rec["collectives"]["per_op"]["all-gather"]["traffic_bytes"]
    params = mem["working_bytes"] - mem["argument_parts"]["params"]
    assert gather == params + rows_cache - cache_block
    assert mem["temp_bytes"] >= rows_cache


def test_cli_writes_a_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                        "--mesh", "multi", "--model",
                        json.dumps({"n_layers": 4}), "--tag", "t"]) == 0
    rec = json.loads((tmp_path / "qwen3-8b__decode_32k__multi__t.json")
                     .read_text())
    assert rec["n_devices"] == 512 and rec["data_ranks"] == 32
    assert rec["model_overrides"] == {"n_layers": 4}


def test_launch_modules_import_without_jax():
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.mesh, repro_torch.distributed.steps\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# the kernel wrappers on meta
# ---------------------------------------------------------------------------
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("ops,plain,args", [
    (flash_ops, "flash_attention_plain",
     lambda: ((_meta(1, 64, 4, 32), _meta(1, 64, 2, 32),
               _meta(1, 64, 2, 32)), {"causal": True})),
    (radix_ops, "radix_partition_plain",
     lambda: ((_meta(100, dtype=torch.int32), 5), {})),
    (bitonic_ops, "bitonic_sort_plain",
     lambda: ((_meta(3, 100, dtype=torch.int32),), {}))])
def test_meta_tensors_take_the_plain_version(ops, plain, args, monkeypatch):
    fn = getattr(ops, plain)
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    monkeypatch.setattr(ops, plain, counted)
    wrapper = getattr(ops, plain.removesuffix("_plain"))
    before = wrapper.launches
    a, k = args()
    out = wrapper(*a, **k)
    assert calls == [1] and wrapper.launches == before
    want = fn(*a, **k)
    for o, w in zip(out if isinstance(out, tuple) else (out,),
                    want if isinstance(want, tuple) else (want,)):
        assert o.is_meta and (o.shape, o.dtype) == (w.shape, w.dtype)


def test_meta_ssm_scan_gives_the_closed_form_of_its_outputs():
    """``ssm_scan`` on ``meta``: the plain version's shapes and dtypes,
    without its loop over the sequence, and no launch."""
    cpu = [torch.zeros(s) for s in ((1, 16, 8), (8, 4), (1, 16, 4),
                                    (1, 16, 4), (1, 16, 8))]
    want = scan_ops.ssm_scan_plain(*cpu, return_state=True)
    before = scan_ops.ssm_scan.launches
    got = scan_ops.ssm_scan(*(t.to("meta") for t in cpu), return_state=True)
    assert scan_ops.ssm_scan.launches == before
    assert [(g.shape, g.dtype, g.is_meta) for g in got] == [
        (w.shape, w.dtype, True) for w in want]
