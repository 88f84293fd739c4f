"""Decoder-only transformer LM, the dense family.

The model is an ``nn.Module`` whose parameter groups are
``nn.ParameterDict``s under the JAX package's names and layouts (``wq``
(d, H, hd), ``wo`` (H, hd, d), ``wg``/``wi`` (d, f), ``embedding`` (V, d),
``lm_head`` (d, V)), so the functions below read like their JAX twins.
Layers are an ``nn.ModuleList`` walked in a Python loop, not a stacked
scan.  Parameters carry no gradient unless the model is built trainable
(``init(..., trainable=True)`` or ``model.requires_grad_()``); serving
keeps them frozen.  ``cfg.remat`` wraps each layer of a forward that
records gradients in ``torch.utils.checkpoint``, the JAX package's
``jax.checkpoint`` of its scan body: it changes memory, not numbers.

The KV cache keeps the JAX layout, ``(n_layers, 1, B, smax, K, hd)`` for
``k`` and ``v`` (the 1 is the JAX superblock period of a dense stack), so
the serving engines locate its batch axis exactly as the JAX engines do.
``decode_step`` writes the new token's keys and values into that cache in
place and returns it.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.attention import AttnMode
from repro_torch.models.layers import (cross_entropy_loss, embed_apply,
                                       embed_init, frozen, logits_apply,
                                       mlp_apply, mlp_init, rms_norm,
                                       torch_dtype)


class Layer(nn.Module):
    """One block: ``attn`` holds its pre-norm ``ln`` and the projections,
    ``mlp`` its pre-norm ``ln`` and the SwiGLU weights."""

    def __init__(self, attn_p: dict, mlp_p: dict):
        super().__init__()
        self.attn = frozen(attn_p)
        self.mlp = frozen(mlp_p)


class Transformer(nn.Module):
    def __init__(self, cfg, embed: dict, final_norm: torch.Tensor,
                 layers: list):
        super().__init__()
        _check_family(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} layers for a config of "
                             f"{cfg.n_layers}")
        self.cfg = cfg
        self.embed = frozen(embed)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(Layer(a, m) for a, m in layers)

    def meta_twin(self) -> "Transformer":
        """The same structure on the ``meta`` device (shapes and dtypes
        only): what ``cache_batch_axes`` probes."""
        def meta(groups):
            return {k: torch.empty_like(v, device="meta")
                    for k, v in groups.items()}
        return Transformer(self.cfg, meta(self.embed),
                           torch.empty_like(self.final_norm, device="meta"),
                           [(meta(layer.attn), meta(layer.mlp))
                            for layer in self.layers])


def _check_family(cfg):
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the MoE family is not ported yet (ROADMAP modules "
            f"item 8, MoE)")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the port's transformer runs the dense family; "
            f"{cfg.family!r} is ROADMAP modules item 8")


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def init(gen: torch.Generator, cfg, trainable: bool = False) -> Transformer:
    """Random parameters on ``gen.device``, drawn one tensor at a time in
    f32 and cast to ``cfg.dtype`` (no f32 copy of the whole model exists);
    ``trainable`` turns their gradients on."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)

    layers = [({"ln": ones(),
                **attn.attn_init(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm,
                                 dtype)},
               {"ln": ones(), **mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)})
              for _ in range(cfg.n_layers)]
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                       cfg.tie_embeddings)
    return Transformer(cfg, embed, ones(), layers).requires_grad_(trainable)


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------
def _attn_sub(p, x, positions, cfg, mode: AttnMode):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = attn.qkv_project(p, h, positions, cfg.rope_theta, cfg.qk_norm,
                               cfg.norm_eps)
    o = attn.attend(q, k, v, causal=True, mode=mode)
    return x + torch.einsum("bshk,hkd->bsd", o, p["wo"]), (k, v)


def _ffn_sub(p, x, cfg):
    return x + mlp_apply(p, rms_norm(x, p["ln"], cfg.norm_eps))


def _embed_input(params, tokens):
    x = embed_apply(params.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return x, positions


def _layer(layer, x, positions, cfg, mode):
    x, _ = _attn_sub(layer.attn, x, positions, cfg, mode)
    return _ffn_sub(layer.mlp, x, cfg)


def forward(params, cfg, batch, mode: AttnMode = AttnMode()):
    """batch: tokens (B,S).  Returns logits (B, S, V)."""
    x, positions = _embed_input(params, batch["tokens"])
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params.layers:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, layer, x, positions, cfg, mode, use_reentrant=False)
        else:
            x = _layer(layer, x, positions, cfg, mode)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_apply(params.embed, x, cfg.tie_embeddings)


def loss_fn(params, cfg, batch, mode: AttnMode = AttnMode()):
    logits = forward(params, cfg, batch, mode)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    return cross_entropy_loss(logits[:, :-1], labels[:, 1:],
                              None if mask is None else mask[:, 1:])


# ----------------------------------------------------------------------------
# prefill / decode
# ----------------------------------------------------------------------------
def cache_init(cfg, batch_size: int, smax: int, dtype=None, device=None):
    dtype = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, 1, batch_size, smax, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(params, cfg, batch, smax: int, mode: AttnMode = AttnMode()):
    """Full forward over the prompt; returns (cache, last-token logits)."""
    x, positions = _embed_input(params, batch["tokens"])
    cache = cache_init(cfg, x.shape[0], smax, device=x.device)
    s = x.shape[1]
    for i, layer in enumerate(params.layers):
        x, (k, v) = _attn_sub(layer.attn, x, positions, cfg, mode)
        cache["k"][i, 0, :, :s] = k
        cache["v"][i, 0, :, :s] = v
        x = _ffn_sub(layer.mlp, x, cfg)
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return cache, logits_apply(params.embed, x, cfg.tie_embeddings)[:, 0]


def decode_step(params, cfg, batch, cache):
    """batch: tokens (B,1), positions (B,) write index.  Writes the new
    keys/values into ``cache`` in place; returns (logits, cache)."""
    tokens, positions = batch["tokens"], batch["positions"]
    x = embed_apply(params.embed, tokens)
    pos2d = positions[:, None]
    for i, layer in enumerate(params.layers):
        ap = layer.attn
        h = rms_norm(x, ap["ln"], cfg.norm_eps)
        q, k, v = attn.qkv_project(ap, h, pos2d, cfg.rope_theta, cfg.qk_norm,
                                   cfg.norm_eps)
        ck, cv = attn.cache_update(cache["k"][i, 0], cache["v"][i, 0], k, v,
                                   positions)
        o = attn.attend_decode(q, ck, cv, positions + 1)
        x = x + torch.einsum("bshk,hkd->bsd", o, ap["wo"])
        x = _ffn_sub(layer.mlp, x, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_apply(params.embed, x, cfg.tie_embeddings)[:, 0], cache
