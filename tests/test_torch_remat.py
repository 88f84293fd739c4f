"""``remat_mode`` against the JAX package's ``maybe_remat``, on the CPU.

The JAX package checkpoints each layer body (a transformer layer, an MoE
superblock, a Mamba1 layer, a hybrid group, an encoder and a decoder
layer) with ``jax.checkpoint``: ``"none"`` (or ``remat=False``) not at
all, ``"nothing"`` saving nothing, any other mode saving the outputs of
the ``dot_general``s with no batch dimension
(``dots_with_no_batch_dims_saveable``).  The port's ``layer_stack`` does
the same with ``torch.utils.checkpoint``; under ``"dots"`` the products
made inside ``layers.dense``, through which every weight product of a
layer body goes, are kept in the forward and handed back to the
recompute.

Held per family, at the reduced configs, with the JAX parameters carried
across: the products the port saves in one forward, by their element
counts, equal those the JAX checkpoint saves (its jaxpr's no-batch
``dot_general``s inside each ``checkpoint``, times its scan's length);
the backward under ``"dots"`` recomputes none of them (counted by a
``TorchDispatchMode``), where ``"nothing"`` recomputes them; and the
gradients are bit for bit those of ``"none"``.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import get_model as jax_get_model
from repro.models import make_concrete_batch as jax_make_concrete_batch
from repro.models import train_batch_shapes as jax_train_batch_shapes
from repro.models.attention import AttnMode as JAttnMode

from repro_torch.configs import get_config, reduced
from repro_torch.models import get_model, layers
from repro_torch.models.attention import AttnMode
from repro_torch.models.convert import params_from_jax

# a family each: dense, MoE superblocks (llama4: a dense and an MoE layer
# with a shared expert), Mamba1, hybrid groups, encoder-decoder, VLM
ARCHS = ("qwen3-8b", "llama4-maverick-400b-a17b", "falcon-mamba-7b",
         "zamba2-7b", "whisper-medium", "internvl2-1b")
CHECKPOINT = ("checkpoint", "remat", "remat2")
KEPT = layers._kept


def _configs(arch, **kw):
    return (dataclasses.replace(jreduced(jget(arch)), remat=True, **kw),
            dataclasses.replace(reduced(get_config(arch)), remat=True, **kw))


def _jax_saved(jaxpr, mult=1, inside=False, out=None):
    """Element counts of the no-batch dot_generals inside each checkpoint
    of ``jaxpr``, each counted as many times as its scans run it."""
    out = collections.Counter() if out is None else out
    for e in jaxpr.eqns:
        name = e.primitive.name
        m = mult * (e.params.get("length", 1) if name == "scan" else 1)
        if name == "dot_general" and inside:
            (_, _), (lb, _) = e.params["dimension_numbers"]
            if not lb:
                out[int(np.prod(e.outvars[0].aval.shape))] += m
        for p in e.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                    sub = sub.jaxpr
                if hasattr(sub, "eqns"):
                    _jax_saved(sub, m, inside or name in CHECKPOINT, out)
    return out


class _Products(TorchDispatchMode):
    """Counts the products run while it is active: all of them, and those
    made inside ``layers.dense``."""

    def __init__(self):
        super().__init__()
        self.all = self.dense = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in layers._PRODUCTS:
            self.all += 1
            self.dense += layers._weight_product.n > 0
        return func(*args, **(kwargs or {}))


def _tensor(a):
    """A JAX array as a torch tensor of its dtype (bf16 by way of f32)."""
    a = np.asarray(a)
    if a.dtype.name != "bfloat16":
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _run(arch, mode, monkeypatch):
    """One forward and backward of ``arch``'s reduced model under
    ``mode``: (loss and gradients, products saved by element count, the
    backward's products)."""
    jcfg, tcfg = _configs(arch, remat_mode=mode)
    params = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                            "cpu").requires_grad_()
    drawn = jax_make_concrete_batch(jax_train_batch_shapes(jcfg, 2, 16),
                                    np.random.default_rng(1), jcfg.vocab_size)
    batch = {k: _tensor(v) for k, v in drawn.items()}
    saved = collections.Counter()

    def kept(out):
        saved[out.numel()] += 1
        return KEPT(out)
    monkeypatch.setattr(layers, "_kept", kept)
    loss = get_model(tcfg).loss_fn(model, tcfg, batch,
                                   AttnMode(kind="full"))
    with _Products() as backward:
        loss.backward()
    grads = [loss.detach()] + [p.grad for p in model.parameters()]
    return (jcfg, params, batch), grads, saved, backward


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_saves_the_products_jax_saves_and_recomputes_none(
        arch, monkeypatch):
    _, want, _, none = _run(arch, "none", monkeypatch)
    (jcfg, params, batch), grads, saved, dots = _run(arch, "dots",
                                                     monkeypatch)
    _, g_nothing, _, nothing = _run(arch, "nothing", monkeypatch)
    jbatch = {k: np.asarray(jnp.asarray(v.float().numpy()).astype(
        str(v.dtype).removeprefix("torch."))) for k, v in batch.items()}
    jaxpr = jax.make_jaxpr(lambda p: jax_get_model(jcfg).loss_fn(
        p, jcfg, jbatch, JAttnMode(kind="full")))(params)
    assert saved == _jax_saved(jaxpr.jaxpr) and sum(saved.values()) > 0
    assert none.dense == dots.dense == 0 < nothing.dense
    assert nothing.all - dots.all == nothing.dense
    for g in (grads, g_nothing):
        assert all(torch.equal(a, b) for a, b in zip(want, g))


def test_remat_mode_follows_maybe_remat():
    """As the JAX maybe_remat: remat False or "none" checkpoints nothing,
    "nothing" saves nothing, and any other mode, an unknown one too,
    saves the weight products as "dots" does."""
    _, cfg = _configs("qwen3-8b")
    assert layers.remat_mode(dataclasses.replace(cfg, remat=False)) == \
        layers.remat_mode(dataclasses.replace(cfg, remat_mode="none")) == \
        "none"
    assert layers.remat_mode(dataclasses.replace(
        cfg, remat_mode="nothing")) == "nothing"
    assert layers.remat_mode(dataclasses.replace(
        cfg, remat_mode="some-other-mode")) == layers.remat_mode(cfg) == \
        "dots"


def test_an_unknown_mode_saves_what_dots_saves(monkeypatch):
    """An unknown remat_mode: the JAX package checkpoints with
    dots_with_no_batch_dims_saveable, and the port saves the same
    products as under "dots", with the same gradients."""
    (jcfg, params, batch), want, saved, back = _run(
        "falcon-mamba-7b", "dots", monkeypatch)
    _, grads, other, other_back = _run("falcon-mamba-7b", "unknown-mode",
                                       monkeypatch)
    assert other == saved and other_back.all == back.all
    assert all(torch.equal(a, b) for a, b in zip(want, grads))
    jcfg = dataclasses.replace(jcfg, remat_mode="unknown-mode")
    jbatch = {k: np.asarray(jnp.asarray(v.float().numpy()).astype(
        str(v.dtype).removeprefix("torch."))) for k, v in batch.items()}
    jaxpr = jax.make_jaxpr(lambda p: jax_get_model(jcfg).loss_fn(
        p, jcfg, jbatch))(params)
    assert _jax_saved(jaxpr.jaxpr) == saved
