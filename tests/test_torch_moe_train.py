"""The port's MoE training against the JAX package's, on the CPU: every
leaf's gradient, one train step and ten steps' losses of qwen2-moe-a2.7b
and llama4-maverick (two superblocks of a dense and an MoE layer) at the
reduced widths, 4 layers, float32.  JAX ``init`` parameters are carried
across by ``models/convert.py::params_from_jax`` and batches drawn with
numpy.

Tolerances (those of ``tests/test_torch_train.py``): gradients and one
train step within 1e-5 of each leaf's largest magnitude; the 10-step loss
curves within 1e-4 relative.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as JParallel
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.distributed.steps import make_train_step as jax_make_train_step
from repro.launch.mesh import make_local_mesh
from repro.models import get_model as jax_get_model
from repro.models.attention import AttnMode as JAttnMode
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer

from repro_torch.configs import ParallelConfig, ShapeConfig, get_config, reduced
from repro_torch.distributed.steps import make_train_step
from repro_torch.models import get_model
from repro_torch.models import attention as TA
from repro_torch.models.convert import jax_tree, params_from_jax, params_to_jax
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer

CPU = "cpu"


def _configs(arch, n_layers):
    return (dataclasses.replace(jreduced(jget(arch)), n_layers=n_layers),
            dataclasses.replace(reduced(get_config(arch)), n_layers=n_layers))


def _walk(a, b, path=""):
    """Pairs of leaves of two nested dicts with the same keys."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _walk(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _close_per_leaf(port: dict, ref: dict, tol=1e-5):
    for path, p, r in _walk(port, ref):
        p = p.detach().numpy() if isinstance(p, torch.Tensor) else \
            np.asarray(p)
        r = np.asarray(r)
        assert p.shape == r.shape, path
        err = np.abs(p - r).max()
        assert err <= tol * np.abs(r).max(), (path, err, np.abs(r).max())


@functools.lru_cache(maxsize=None)
def _jax_params(arch, n_layers, seed=0):
    jcfg, _ = _configs(arch, n_layers)
    params = jax_get_model(jcfg).init(jax.random.key(seed), jcfg)
    return params, jax.tree.map(np.asarray, params)


def _batch(vocab, b=4, s=32, seed=1):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                               dtype=np.int32)
    return {"tokens": tok, "labels": tok}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


MOE = ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("arch", MOE)
def test_moe_gradients_match_jax(arch):
    """Every leaf's gradient, the routers' and experts' included, within
    1e-5 of its largest magnitude of the JAX package's (4 layers: llama4's
    two superblocks of a dense and an MoE layer).  At top-1 (llama4) the
    router's true gradient is 0, its one gate renormalised to exactly 1:
    both packages give rounding noise there, held within 1e-5 of the
    largest gradient of any leaf instead."""
    jcfg, tcfg = _configs(arch, 4)
    params, host = _jax_params(arch, 4)
    batch = _batch(jcfg.vocab_size, s=16)
    jgrads = jax.jit(jax.grad(lambda p: jax_get_model(jcfg).loss_fn(
        p, jcfg, batch, JAttnMode(kind="full"))))(params)
    model = params_from_jax(host, tcfg, CPU).requires_grad_()
    get_model(tcfg).loss_fn(model, tcfg, _torch_batch(batch),
                            TA.AttnMode(kind="full")).backward()
    port = jax_tree({k: p.grad for k, p in model.named_parameters()}, tcfg)
    ref = jax.tree.map(np.asarray, jgrads)
    if tcfg.top_k == 1:
        top = max(np.abs(r).max() for _, r, _ in _walk(ref, ref))
        noise = np.abs(port["blocks"]["moe"].pop("router").numpy()
                       - ref["blocks"]["moe"].pop("router")).max()
        assert noise <= 1e-5 * top
    _close_per_leaf(port, ref)


@pytest.mark.parametrize("arch", MOE)
def test_moe_train_step_matches_jax(arch):
    """One step of each package's train step on an MoE stack: loss, grad
    norm and every leaf after the update within 1e-5."""
    jcfg, tcfg = _configs(arch, 4)
    params, host = _jax_params(arch, 4)
    batch = _batch(jcfg.vocab_size, s=16)
    with make_local_mesh(1, 1) as mesh:
        jb = jax_make_train_step(jcfg, mesh, JParallel(),
                                 JShape("t", "train", 16, 4))
        jnew, _, jm = jb.fn(params, jopt.adamw_init(params), dict(batch))
    model = params_from_jax(host, tcfg, CPU).requires_grad_()
    state = opt.adamw_init(dict(model.named_parameters()))
    tb = make_train_step(tcfg, ParallelConfig(), ShapeConfig("t", "train",
                                                             16, 4))
    _, _, tm = tb.fn(model, state, _torch_batch(batch))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    _close_per_leaf(params_to_jax(model), jax.tree.map(np.asarray, jnew))


@pytest.mark.parametrize("arch", MOE)
def test_moe_ten_step_losses_match_jax(arch):
    jcfg, tcfg = _configs(arch, 4)
    _, host = _jax_params(arch, 4)
    kw = dict(peak_lr=3e-3, warmup_steps=5, total_steps=10)
    jt = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(),
                  JShape("t", "train", 32, 4), jopt.OptimizerConfig(**kw))
    _, jl = jt.fit(jdata.SyntheticCorpus(jcfg.vocab_size, 0).batches(4, 32,
                                                                      10),
                   10, state=jt.init_state(), log_every=0)
    tt = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", 32, 4),
                 opt.OptimizerConfig(**kw), device=CPU)
    _, tl = tt.fit(tdata.SyntheticCorpus(tcfg.vocab_size, 0).batches(4, 32,
                                                                      10),
                   10, state=tt.state_from_jax(host), log_every=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
