"""The port's sharded prefill and decode steps against the JAX package's
unsharded ``prefill`` / ``decode_step``, on the CPU.

Each family at a reduced config (qwen3-8b, qwen2-moe-a2.7b under
``moe_impl`` "gspmd" and "shardmap", falcon-mamba-7b, zamba2-7b,
internvl2-1b, whisper-medium), the JAX ``init`` params carried across
(``params_from_jax``) and sharded onto (2, 2), (4, 1) and (1, 4) meshes of
logical CPU ranks and the 3-axis ("pod", "data", "model") mesh (2, 1, 2),
the model axis splitting compute (each model rank its heads, ff columns,
experts and vocabulary slice), and qwen3-8b also on (1, 4) with
``tensor_parallel=False``: one prefill of 4 rows of 8 tokens and 3 greedy
decode steps.  The logits and the whole cache (each leaf unsharded from the
ranks' blocks) within 1e-5 of the JAX results, greedy tokens equal.  Each
rank's block shapes are ``NamedSharding(AbstractMesh, spec).shard_shape``
of the JAX package's ``cache_specs`` and logit spec.  The MoE runs at the
capacity factor n_experts / top_k, where no (token, expert) pair drops,
so every data rank's routing is the whole batch's.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import ParallelConfig as JParallel
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.distributed import sharding as jsh
from repro.models import get_model as jax_get_model

from repro_torch.configs import ParallelConfig, ShapeConfig, get_config, reduced
from repro_torch.core import build_communicator, logical_devices
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.steps import (make_decode_step,
                                           make_prefill_step, make_step,
                                           make_train_step, shard_model)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import get_model, registry
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.train.optimizer import adamw_init

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, DECODES = 4, 8, 3
GRIDS = [(2, 2), (4, 1), (1, 4), (2, 1, 2)]
CASES = [("qwen3-8b", "gspmd"), ("qwen2-moe-a2.7b", "gspmd"),
         ("qwen2-moe-a2.7b", "shardmap"), ("falcon-mamba-7b", "gspmd"),
         ("zamba2-7b", "gspmd"), ("internvl2-1b", "gspmd"),
         ("whisper-medium", "gspmd")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side on one torch thread: the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch):
    jcfg, tcfg = jreduced(jget(arch)), reduced(get_config(arch))
    if jcfg.n_experts:
        cf = jcfg.n_experts / jcfg.top_k
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    return jcfg, tcfg


def _prefix(cfg) -> int:
    return cfg.n_patches if cfg.family == "vlm" else 0


def _shapes(cfg):
    """The prefill and decode cells: room for the prompt and the decode
    steps (after a VLM's patches, which ``_smax`` adds)."""
    n = S + DECODES
    return (ShapeConfig("p", "prefill", n, B),
            ShapeConfig("d", "decode", n, B))


def _batch(cfg, rows=B):
    shapes = registry.prefill_batch_shapes(cfg, rows, S)
    return registry.make_concrete_batch(shapes, np.random.default_rng(3),
                                        cfg.vocab_size)


def _jax_batch(batch: dict) -> dict:
    """The same batch for the JAX side (bf16 through f32, exactly)."""
    return {k: jnp.asarray(v.float().numpy(), dtype=jnp.bfloat16)
            if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """The JAX prefill and DECODES greedy steps on one device: the params
    (host arrays), and each step's logits, cache (flat paths) and the
    tokens it fed."""
    jcfg, tcfg = _configs(arch)
    api = jax_get_model(jcfg)
    params = api.init(jax.random.key(0), jcfg)
    pshape, _ = _shapes(tcfg)
    smax = pshape.seq_len + _prefix(jcfg)
    cache, logits = jax.jit(api.prefill, static_argnums=(1, 3))(
        params, jcfg, _jax_batch(_batch(tcfg)), smax)
    decode = jax.jit(api.decode_step, static_argnums=1)
    out = [(np.asarray(logits), _flat_np(cache), None)]
    for t in range(DECODES):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32)[:, None]
        feed = {"tokens": tok,
                "positions": np.full((B,), _prefix(jcfg) + S + t, np.int32)}
        logits, cache = decode(params, jcfg, {k: jnp.asarray(v) for k, v in
                                              feed.items()}, cache)
        out.append((np.asarray(logits), _flat_np(cache), feed))
    return jax.tree.map(np.asarray, params), out


def _flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in sh.flat_paths(tree).items()}


def _duck_mesh(grid, axes=("data", "model")):
    """What the JAX rules read of a mesh (axis names and its devices'
    shape), for a mesh of no devices."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(grid, dtype=object))


def _jax_blocks(jcfg, grid, parallel, smax, axes=("data", "model")):
    """Each cache leaf's and the logits' block shape by the JAX specs."""
    am = AbstractMesh(grid, axes)
    mesh = _duck_mesh(grid, axes)
    cshape = jax_get_model(jcfg).cache_init
    tree = jax.eval_shape(lambda: cshape(jcfg, B, smax))
    specs = jsh.cache_specs(jcfg, tree, mesh, parallel)
    leaves = sh.flat_paths(tree)
    blocks = {p: NamedSharding(am, s).shard_shape(leaves[p].shape)
              for p, s in sh.flat_paths(specs).items()}
    dp = jsh.dp_axes(mesh, parallel)
    logit_spec = JP(dp if B % jsh._dp_size(mesh, dp) == 0 else None,
                    jsh._axis_if(mesh, jsh.TP_AXIS, jcfg.vocab_size,
                                 parallel.tensor_parallel))
    return blocks, NamedSharding(am, logit_spec).shard_shape(
        (B, jcfg.vocab_size))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def _mesh(grid):
    """A (data, model) mesh of CPU ranks, or (pod, data, model) for a
    3-axis grid (the data ranks over ``pod`` and ``data``)."""
    if len(grid) == 2:
        return make_local_mesh(*grid, device="cpu")
    return build_communicator(logical_devices(int(np.prod(grid)), "cpu"),
                              axes=("pod", "data", "model"), shape=grid)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch,impl", CASES)
def test_sharded_prefill_and_decode_match_jax(arch, impl, grid):
    prefill = _check_steps(arch, _mesh(grid), dict(moe_impl=impl))
    assert prefill.info["slices"].n == grid[-1]


def test_qwen3_steps_without_tensor_parallel():
    """qwen3-8b on (1, 4) with ``tensor_parallel=False``, whose specs put
    nothing on ``model``: one whole working model, no model group, the
    cache's blocks replicated over the model ranks."""
    prefill = _check_steps("qwen3-8b", _mesh((1, 4)),
                           {"tensor_parallel": False})
    assert prefill.info["slices"].n == 1
    assert all(e is None or "model" not in e
               for s in prefill.info["pspecs"].values() for e in s)


def _check_steps(arch, mesh, kw):
    """The sharded prefill and DECODES greedy steps on ``mesh`` under
    ``ParallelConfig(**kw)`` against the JAX results; returns the prefill
    bundle."""
    jcfg, tcfg = _configs(arch)
    host, ref = _jax_run(arch)
    grid, axes = tuple(mesh.shape), tuple(mesh.axes)
    parallel = ParallelConfig(**kw)
    pshape, dshape = _shapes(tcfg)
    prefill = make_prefill_step(tcfg, mesh, parallel, pshape)
    decode = make_decode_step(tcfg, mesh, parallel, dshape)
    params = shard_model(params_from_jax(host, tcfg, "cpu"), prefill.info,
                         mesh)
    cblocks, lblock = _jax_blocks(jcfg, grid, JParallel(**kw),
                                  pshape.seq_len + _prefix(jcfg), axes)
    cspecs, lspec = prefill.info["cspecs"], prefill.info["logit_spec"]

    def check(logits, cache, want_logits, want_cache):
        assert [tuple(x.shape) for x in logits] == [lblock] * mesh.size
        assert set(cache[0]) == set(want_cache) == set(cblocks)
        for path, want in want_cache.items():
            assert all(tuple(c[path].shape) == cblocks[path] for c in cache)
            _close(sh.unshard([c[path] for c in cache], cspecs[path], mesh),
                   want)
        whole = sh.unshard(logits, lspec, mesh)
        _close(whole, want_logits)
        assert np.array_equal(whole.argmax(-1).numpy(),
                              want_logits.argmax(-1))

    cache, logits = prefill.fn(params, _batch(tcfg))
    check(logits, cache, ref[0][0], ref[0][1])
    for want_logits, want_cache, feed in ref[1:]:
        logits, cache = decode.fn(params, {k: torch.tensor(v)
                                           for k, v in feed.items()}, cache)
        check(logits, cache, want_logits, want_cache)
    return prefill


def test_make_step_dispatches_every_kind():
    """make_step in the JAX argument order builds each kind's step: the
    train step's loss is make_train_step's, and on one rank (or no mesh)
    the prefill and decode steps are the family's own functions."""
    jcfg, tcfg = (dataclasses.replace(c, n_layers=2)
                  for c in _configs("qwen3-8b"))
    host = jax.tree.map(np.asarray, jax_get_model(jcfg).init(
        jax.random.key(0), jcfg))
    pshape, dshape = _shapes(tcfg)
    tshape = ShapeConfig("t", "train", S, B)
    mesh = make_local_mesh(2, 2, device="cpu")
    kinds = {k: make_step(tcfg, mesh, ParallelConfig(), s)
             for k, s in (("train", tshape), ("prefill", pshape),
                          ("decode", dshape))}
    assert "cspecs" not in kinds["train"].info
    assert kinds["prefill"].info["cspecs"] == kinds["decode"].info["cspecs"]
    direct = make_train_step(tcfg, ParallelConfig(), tshape, mesh=mesh)
    rng = np.random.default_rng(0)
    batch = registry.make_concrete_batch(
        registry.train_batch_shapes(tcfg, B, S), rng, tcfg.vocab_size)
    losses = []
    for bundle in (kinds["train"], direct):
        params = shard_model(params_from_jax(host, tcfg, "cpu"),
                             bundle.info, mesh)
        opt = [adamw_init(p) for p in params]
        losses.append(float(bundle.fn(params, opt, batch)[2]["loss"]))
    assert losses[0] == losses[1]
    model = params_from_jax(host, tcfg, "cpu")
    api = get_model(tcfg)
    pb = _batch(tcfg)
    for m in (None, make_local_mesh(1, 1, device="cpu")):
        p1 = make_step(tcfg, m, ParallelConfig(), pshape)
        d1 = make_step(tcfg, m, ParallelConfig(), dshape)
        cache, logits = p1.fn(model, pb)
        want_cache, want = api.prefill(model, tcfg, pb, p1.info["smax"])
        assert torch.equal(logits, want)
        feed = {"tokens": logits.argmax(-1, keepdim=True).to(torch.int32),
                "positions": torch.full((B,), S, dtype=torch.int32)}
        got, _ = d1.fn(model, feed, cache)
        want, _ = api.decode_step(model, tcfg, feed, want_cache)
        assert torch.equal(got, want)


def test_undivisible_batch_is_replicated_and_computed_once(monkeypatch):
    """3 rows on 2 data ranks: the batch, the cache's batch dim and the
    logits' rows stay whole on every rank, as the JAX rules leave them,
    and one data rank's prefill and decode compute them: equal to one
    rank's with ``tensor_parallel=False`` (whole working models), within
    1e-5 of it with the model axis splitting compute (f32 sums over the
    model ranks)."""
    _, tcfg = _configs("qwen3-8b")
    host = _jax_run("qwen3-8b")[0]
    calls = {"prefill": 0, "decode_step": 0}
    for name in calls:
        fn = getattr(TT, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(TT, name, counted)
    pshape = ShapeConfig("p", "prefill", S + 1, 3)
    dshape = ShapeConfig("d", "decode", S + 1, 3)
    mesh = make_local_mesh(2, 2, device="cpu")
    model = params_from_jax(host, tcfg, "cpu")
    batch = _batch(tcfg, 3)
    one = make_prefill_step(tcfg, None, ParallelConfig(), pshape)
    want_cache0, want0 = one.fn(model, batch)
    for parallel in (ParallelConfig(tensor_parallel=False), ParallelConfig()):
        same = torch.equal if not parallel.tensor_parallel else \
            (lambda a, b: np.allclose(a.numpy(), b.numpy(), **TOL))
        calls.update(prefill=0, decode_step=0)
        prefill = make_prefill_step(tcfg, mesh, parallel, pshape)
        decode = make_decode_step(tcfg, mesh, parallel, dshape)
        assert prefill.info["bspecs"]["tokens"] == (None, None)
        assert prefill.info["logit_spec"][0] is None
        assert prefill.info["cspecs"]["k"][2] is None
        params = shard_model(model, prefill.info, mesh)
        cache, logits = prefill.fn(params, batch)
        assert calls["prefill"] == 1
        want_cache, want = {k: v.clone() for k, v in want_cache0.items()}, \
            want0
        if parallel.tensor_parallel:
            assert all(same(x, want[:, x.shape[1] * (r % 2):]
                            [:, :x.shape[1]]) for r, x in enumerate(logits))
        else:
            assert all(same(x, want) for x in logits)
        feed = {"tokens": want.argmax(-1, keepdim=True).to(torch.int32),
                "positions": torch.full((3,), S, dtype=torch.int32)}
        logits, cache = decode.fn(params, feed, cache)
        assert calls["decode_step"] == 1
        got = sh.unshard(logits, decode.info["logit_spec"], mesh)
        want, want_cache = make_decode_step(tcfg, None, ParallelConfig(),
                                            dshape).fn(model, feed,
                                                       want_cache)
        assert same(got, want)
        for path, spec in decode.info["cspecs"].items():
            assert same(sh.unshard([c[path] for c in cache], spec, mesh),
                        want_cache[path])
