"""The model axis splitting a data rank's compute, on the CPU: each model
rank's working slice holds exactly its leaves' blocks over ``model`` by
the JAX package's specs, no pass allocates logits of the whole
vocabulary where the specs split it, and the vocabulary-parallel cross
entropy against ``cross_entropy_loss``.

The reduced configs on a (1, 4) mesh of logical CPU ranks; the JAX side
gives only the specs (``param_specs`` on ``eval_params_shape``) and the
block shapes (``NamedSharding(AbstractMesh, spec).shard_shape``).
"""
import types

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.configs import ParallelConfig as JParallel
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.distributed import sharding as jsh
from repro.models import registry as jreg

from repro_torch.configs import ParallelConfig, ShapeConfig, get_config, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import model_group
from repro_torch.distributed.steps import (gather_model, make_prefill_step,
                                           make_train_step, shard_model)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import get_model, registry
from repro_torch.models.layers import (cross_entropy_loss,
                                       vocab_parallel_loss)

GRID = (1, 4)
B, S = 4, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side on one torch thread: the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(cfg):
    return get_model(cfg).init(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-moe-a2.7b",
                                  "whisper-medium", "zamba2-7b"])
def test_working_slices_hold_their_model_blocks(arch):
    """Model rank m's working tensors: each leaf's block over ``model`` by
    the JAX spec (``shard_shape`` on a (1, 4) mesh, where ``data`` has one
    rank), filled with the m-th block of the whole leaf.  A spec that puts
    ``model`` on a stacked layer axis (the reduced MoE's ``shared`` MLP,
    the expert rule meeting 4 layers) leaves its working copy whole."""
    tcfg = reduced(get_config(arch))
    jcfg = jreduced(jget(arch))
    mesh = make_local_mesh(*GRID, device="cpu")
    info = make_prefill_step(tcfg, mesh, ParallelConfig(),
                             ShapeConfig("p", "prefill", S, B)).info
    duck = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(GRID, dtype=object))
    jshape = jreg.eval_params_shape(jcfg)
    jspecs = sh.flat_paths(jsh.param_specs(jshape, duck, JParallel(), jcfg))
    leaves = sh.flat_paths(jshape)
    am = AbstractMesh(GRID, ("data", "model"))
    model = _model(tcfg)
    whole = dict(model.named_parameters())
    params = shard_model(model, info, mesh)
    work = info["working"](torch.device("cpu"))
    assert len(work.slices) == GRID[1]
    stacked_axis = 0
    for m, sl in enumerate(work.slices):
        gather_model(sl, params, info["layout"], info["pspecs"], mesh,
                     info["slices"], m)
        named = dict(sl.named_parameters())
        for path, (shp, entries) in info["layout"].items():
            spec = tuple(jspecs[path])
            block = NamedSharding(am, jspecs[path]).shard_shape(
                leaves[path].shape)
            at = [i for i, e in enumerate(spec) if e == "model"]
            on_stack = bool(at) and at[0] < len(entries[0][1])
            stacked_axis += on_stack
            for name, idx in entries:
                got = named[name]
                want = whole[name]
                if at and not on_stack:
                    dim = at[0] - len(idx)
                    assert tuple(got.shape) == tuple(block[len(idx):]), name
                    n = want.shape[dim] // GRID[1]
                    want = want.narrow(dim, m * n, n)
                else:
                    assert tuple(got.shape) == tuple(want.shape), name
                assert torch.equal(got, want), name
    assert bool(stacked_axis) == (arch == "qwen2-moe-a2.7b")


class _Shapes(TorchDispatchMode):
    """Every op output's shape."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes += [tuple(t.shape) for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)]
        return out


def test_no_pass_allocates_whole_vocabulary_logits():
    """reduced qwen3-8b on (1, 4), its vocabulary split 4 ways: the train
    step's data pass (forward and backward) and the prefill's make each
    rank's (..., V / 4) logits and no tensor whose last dim is V."""
    cfg = reduced(get_config("qwen3-8b"))
    v = cfg.vocab_size
    mesh = make_local_mesh(*GRID, device="cpu")
    model = _model(cfg)
    batch = registry.make_concrete_batch(
        registry.train_batch_shapes(cfg, B, S), np.random.default_rng(0), v)
    train = make_train_step(cfg, ParallelConfig(), ShapeConfig(
        "t", "train", S, B), mesh=mesh)
    prefill = make_prefill_step(cfg, mesh, ParallelConfig(),
                                ShapeConfig("p", "prefill", S, B))
    assert train.info["pspecs"]["embed/embedding"][0] == "model"
    params = shard_model(model, train.info, mesh)
    work = train.info["working"](torch.device("cpu"))
    for m, sl in enumerate(work.slices):
        sl.requires_grad_(True)
        gather_model(sl, params, train.info["layout"], train.info["pspecs"],
                     mesh, train.info["slices"], m)
    accs = [{k: torch.zeros(p.shape) for k, p in sl.named_parameters()}
            for sl in work.slices]
    seen = _Shapes()
    with seen:
        loss = train.info["data_pass"](0, work, accs, batch, 1)
        _, logits = prefill.info["data_pass"](0, work, {
            "tokens": batch["tokens"]})
    assert np.isfinite(float(loss))
    assert [tuple(x.shape) for x in logits] == [(B, v // 4)] * 4
    assert (B, S, v // 4) in seen.shapes
    assert not [s for s in seen.shapes if s[-1:] == (v,)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ranks", [2, 4])
def test_vocab_parallel_loss_matches_cross_entropy(ranks, masked):
    """Logits held one vocabulary piece a rank, labels on every rank: the
    loss within 1e-6 relative of ``cross_entropy_loss`` on the whole
    logits, its gradient within 1e-6 of the largest."""
    rng = np.random.default_rng(ranks)
    v = 64
    logits = torch.tensor(rng.normal(size=(3, 10, v)) * 4, dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, v, (3, 10)), dtype=torch.int32)
    labels[0, :ranks] = torch.arange(ranks) * (v // ranks)   # every rank's
    mask = torch.tensor(rng.integers(0, 2, (3, 10)), dtype=torch.int32) \
        if masked else None
    whole = logits.clone().requires_grad_(True)
    want = cross_entropy_loss(whole, labels, mask)
    (g_want,) = torch.autograd.grad(want, whole)
    pieces = [p.clone().requires_grad_(True) for p in logits.chunk(ranks, -1)]
    with model_group([torch.nn.Module() for _ in range(ranks)], ()):
        got = cross_entropy_loss(pieces, labels, mask)
        assert torch.equal(got, vocab_parallel_loss(pieces, labels, mask))
    g_got = torch.cat(torch.autograd.grad(got, pieces), -1)
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-6 * abs(want)
    assert float((g_got - g_want).abs().max()) <= \
        1e-6 * float(g_want.abs().max())


def test_a_checkpointed_body_carries_the_model_group_to_another_thread():
    """The autograd engine may run a checkpointed layer's recompute on its
    own thread (a CUDA device's): ``carried`` hands that thread the mesh
    and the model group the forward ran under."""
    import threading
    from repro_torch.distributed.context import (axes_ctx, carried,
                                                 current_moe_impl,
                                                 model_size)
    seen = {}

    def body():
        seen["size"], seen["impl"] = model_size(), current_moe_impl()
    with axes_ctx({"data": 1, "model": 3}, "shardmap"), \
            model_group([torch.nn.Module() for _ in range(3)], ()):
        fn = carried(body)
    for target in (body, fn):
        t = threading.Thread(target=target)
        t.start()
        t.join()
        if target is body:
            assert seen == {"size": 1, "impl": "gspmd"}
    assert seen == {"size": 3, "impl": "shardmap"}
    assert model_size() == 1
