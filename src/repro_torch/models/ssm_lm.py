"""Falcon-mamba-style attention-free LM: a stack of Mamba1 blocks.

The model is an ``nn.Module`` whose parameter groups are
``nn.ParameterDict``s under the JAX package's names and layouts (each
layer: ``ln`` and the Mamba1 weights of ``ssm.mamba1_init``), frozen like
``transformer.Transformer``.  Layers are an ``nn.ModuleList`` walked in a
Python loop, not a stacked scan; ``cfg.remat`` wraps each layer of a
forward that records gradients in ``torch.utils.checkpoint``, as the
transformer does (the recomputed forward runs the scan again).

The cache keeps the JAX layout: ``conv`` (n_layers, B, K-1, d_inner) in the
cache dtype and ``h`` (n_layers, B, d_inner, N) in f32, so the serving
engines find its batch axis (1) as the JAX engines do.  Its size does not
depend on ``smax``.  ``prefill`` takes each layer's final state from the
same ``ssm_scan`` call that computes its output; ``decode_step`` writes the
new conv window and state into the cache in place and returns it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import ssm
from repro_torch.models.attention import AttnMode
from repro_torch.models.layers import (cross_entropy_loss, embed_apply,
                                       embed_init, frozen, layer_stack,
                                       logits_apply, rms_norm, torch_dtype)


class MambaLM(nn.Module):
    def __init__(self, cfg, embed: dict, final_norm, layers: list):
        super().__init__()
        _check_family(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} layers for a config of "
                             f"{cfg.n_layers}")
        self.cfg = cfg
        self.embed = frozen(embed)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(frozen(p) for p in layers)

    def meta_twin(self) -> "MambaLM":
        """The same structure on the ``meta`` device (shapes and dtypes
        only): what ``cache_batch_axes`` probes."""
        def meta(groups):
            return {k: v.new_empty(v.shape, device="meta")
                    for k, v in groups.items()}
        return MambaLM(self.cfg, meta(self.embed),
                       self.final_norm.new_empty(self.final_norm.shape,
                                                 device="meta"),
                       [meta(layer) for layer in self.layers])


def _check_family(cfg):
    if cfg.family != "ssm" or cfg.ssm_version != 1:
        raise NotImplementedError(
            f"{cfg.name}: the port's ssm_lm runs Mamba1 stacks (falcon-mamba),"
            f" not family {cfg.family!r} with ssm_version {cfg.ssm_version};"
            f" Mamba2 stacks are the hybrid family's (models/hybrid.py)")
    ssm.check_scan_dtype(cfg)


def init(gen, cfg, trainable: bool = False) -> MambaLM:
    """Random parameters on ``gen.device``, drawn one tensor at a time in
    f32 and cast to ``cfg.dtype`` (``A_log`` and ``D`` stay f32);
    ``trainable`` turns their gradients on."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)

    layers = [{"ln": ones(), **ssm.mamba1_init(gen, cfg, dtype)}
              for _ in range(cfg.n_layers)]
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                       cfg.tie_embeddings)
    return MambaLM(cfg, embed, ones(), layers).requires_grad_(trainable)


def _layer(lp, x, cfg):
    return x + ssm.mamba1_apply(lp, rms_norm(x, lp["ln"], cfg.norm_eps), cfg)


def forward(params, cfg, batch, mode: AttnMode = AttnMode()):
    """batch: tokens (B,S).  Returns logits (B, S, V).  ``mode`` is the
    uniform API's and unused: the family has no attention."""
    x = embed_apply(params.embed, batch["tokens"])
    x = layer_stack(_layer, params.layers, x, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_apply(params.embed, x, cfg.tie_embeddings)


def loss_fn(params, cfg, batch, mode: AttnMode = AttnMode()):
    logits = forward(params, cfg, batch, mode)
    mask = batch.get("loss_mask")
    return cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                              None if mask is None else mask[:, 1:])


def cache_init(cfg, batch_size: int, smax: int, dtype=None, device=None):
    """``smax`` is the uniform API's: a Mamba cache has no sequence axis."""
    st = ssm.mamba1_state_init(batch_size, cfg,
                               torch_dtype(dtype or cfg.dtype), device)
    return {k: v.new_zeros((cfg.n_layers,) + v.shape) for k, v in st.items()}


def prefill(params, cfg, batch, smax: int, mode: AttnMode = AttnMode()):
    """Full forward over the prompt; returns (cache, last-token logits)."""
    x = embed_apply(params.embed, batch["tokens"])
    cache = cache_init(cfg, x.shape[0], smax, device=x.device)
    for i, lp in enumerate(params.layers):
        y, st = ssm.mamba1_apply(lp, rms_norm(x, lp["ln"], cfg.norm_eps),
                                 cfg, return_state=True)
        cache["conv"][i] = st["conv"]
        cache["h"][i] = st["h"]
        x = x + y
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return cache, logits_apply(params.embed, x, cfg.tie_embeddings)[:, 0]


def decode_step(params, cfg, batch, cache):
    """batch: tokens (B,1) (``positions``, if given, is unused: the state
    carries the position).  Writes each layer's new conv window and state
    into ``cache`` in place; returns (logits, cache)."""
    x = embed_apply(params.embed, batch["tokens"])
    for i, lp in enumerate(params.layers):
        y, _ = ssm.mamba1_decode(lp, rms_norm(x, lp["ln"], cfg.norm_eps),
                                 {"conv": cache["conv"][i],
                                  "h": cache["h"][i]}, cfg)
        x = x + y
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_apply(params.embed, x, cfg.tie_embeddings)[:, 0], cache
