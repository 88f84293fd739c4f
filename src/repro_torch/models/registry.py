"""Uniform model API across families + batch construction helpers.

Every family exposes ``init(gen, cfg[, trainable])`` / ``forward`` /
``loss_fn`` / ``prefill`` / ``decode_step`` / ``cache_init`` with dict
batches, as in the JAX package, so the trainer and the serving engines
treat every arch alike.  The port has every family of the JAX package: the
dense and MoE families (the transformer), the VLM family (the transformer
with stub patch embeddings before the tokens), the SSM family (Mamba1),
the audio family (the encoder-decoder) and the hybrid family (Mamba2
groups with a shared attention block).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models import encdec, hybrid, ssm_lm, transformer, vlm


class ModelApi(NamedTuple):
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    cache_init: Callable


_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": vlm,
             "ssm": ssm_lm, "audio": encdec, "hybrid": hybrid}


def get_model(cfg) -> ModelApi:
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    return ModelApi(mod.init, mod.forward, mod.loss_fn, mod.prefill,
                    mod.decode_step, mod.cache_init)


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: the initialisers, which
    draw on ``gen.device``, then make shapes and dtypes and draw nothing."""

    @property
    def device(self):
        return torch.device("meta")


def meta_model(cfg):
    """``cfg``'s model with its parameters on ``meta``: the shapes and
    dtypes of every tensor, at any width, with no storage."""
    return get_model(cfg).init(_MetaGenerator(), cfg)


def eval_params_shape(cfg) -> dict:
    """The parameters' tree in the JAX layout on ``meta`` tensors, the
    JAX package's ``registry.eval_params_shape``."""
    from repro_torch.models.convert import jax_tree
    return jax_tree(dict(meta_model(cfg).named_parameters()), cfg)


def eval_cache_shape(cfg, batch: int, smax: int) -> dict:
    """The serving cache's tree in the JAX layout on ``meta`` tensors, the
    JAX package's ``registry.eval_cache_shape``: the hybrid's Mamba2
    states nest under ``ssm``, as its JAX cache keeps them."""
    cache = get_model(cfg).cache_init(cfg, batch, smax, device="meta")
    if cfg.family == "hybrid":
        cache = dict(cache)
        cache["ssm"] = {k: cache.pop(k) for k in ("conv", "h")}
    return cache



# ----------------------------------------------------------------------------
# batch builders (the JAX package's, with torch dtypes)
# ----------------------------------------------------------------------------
def train_batch_shapes(cfg, batch: int, seq: int) -> dict[str, Any]:
    return {"tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32), **modal_shapes(cfg, batch)}


def decode_batch_shapes(cfg, batch: int) -> dict[str, Any]:
    return {"tokens": ((batch, 1), torch.int32),
            "positions": ((batch,), torch.int32)}


def prefill_batch_shapes(cfg, batch: int, seq: int) -> dict[str, Any]:
    return {"tokens": ((batch, seq), torch.int32),
            **modal_shapes(cfg, batch)}


def modal_shapes(cfg, batch: int) -> dict[str, Any]:
    """The stub frontends' inputs, bf16 whatever the model dtype, as the
    JAX package's batch builders give them: a VLM's patch embeddings and
    an audio model's frame embeddings."""
    if cfg.family == "vlm":
        return {"prefix_embeds": ((batch, cfg.n_patches, cfg.d_model),
                                  torch.bfloat16)}
    if cfg.family == "audio":
        return {"frames": ((batch, cfg.n_encoder_frames, cfg.d_model),
                           torch.bfloat16)}
    return {}


def make_concrete_batch(shapes, rng: np.random.Generator, vocab: int,
                        device=None) -> dict:
    """Tensors on ``device`` drawn with numpy as the JAX package draws them,
    so one seed gives both packages the same batch."""
    out = {}
    for name, (shape, dtype) in shapes.items():
        if dtype == torch.int32:
            hi = vocab if name in ("tokens", "labels") else \
                max(np.prod(shape), 2)
            a = rng.integers(0, hi, size=shape, dtype=np.int32)
        else:
            a = rng.normal(size=shape).astype(np.float32)
        out[name] = torch.from_numpy(a).to(device=device, dtype=dtype)
    return out
