"""Decoder-only transformer LM, the dense and MoE families, and the VLM
family's backbone (``models/vlm.py``: a batch's ``prefix_embeds``, the stub
patch embeddings, go before its tokens).

The model is an ``nn.Module`` whose parameter groups are
``nn.ParameterDict``s under the JAX package's names and layouts (``wq``
(d, H, hd), ``wo`` (H, hd, d), ``wg``/``wi`` (d, f), ``embedding`` (V, d),
``lm_head`` (d, V); an MoE layer's ``router`` (d, E), ``wg``/``wi``
(E, d, f), ``wo`` (E, f, d), ``shared`` and ``shared_gate``), so the
functions below read like their JAX twins.  Layers are an
``nn.ModuleList`` walked in a Python loop, not a stacked scan.  Layer i
holds ``attn`` and one FFN group under the JAX name of its stack
(:func:`ffn_group`): ``mlp`` in the dense family; ``moe`` on an MoE layer
(``cfg.is_moe_layer(i)``: the last of each superblock of
``moe_layer_period`` layers) and ``mlp_dense`` (width ``d_ff_dense or
d_ff``) on the others.  Parameters carry no gradient unless the model is
built trainable (``init(..., trainable=True)`` or
``model.requires_grad_()``); serving keeps them frozen.  In a forward
that records gradients, ``cfg.remat`` and ``cfg.remat_mode`` checkpoint
each layer as the JAX package's ``maybe_remat`` does its scan body
(``layers.layer_stack``; "dots", the default, keeps the weight products
of ``layers.dense`` and recomputes the rest): it changes memory and the
backward's work, not numbers.

The KV cache keeps the JAX layout, ``(n_super, period, B, smax, K, hd)``
for ``k`` and ``v``, layer i at superblock ``i // period``, slot
``i % period`` (a dense stack is period 1), so the serving engines locate
its batch axis exactly as the JAX engines do.  ``decode_step`` writes the
new token's keys and values into that cache in place and returns it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import AttnMode
from repro_torch.models.layers import (cross_entropy_loss, dense, each,
                                       embed_apply, embed_init, frozen,
                                       layer_stack,
                                       logits_apply, meta_groups, mlp_apply,
                                       mlp_init, rms_norm, rope_sincos,
                                       torch_dtype)


def ffn_group(cfg, i: int) -> str:
    """The JAX name of the stack that holds layer i's FFN."""
    if cfg.is_moe_layer(i):
        return "moe"
    return "mlp_dense" if cfg.n_experts else "mlp"


def superblock_slot(cfg, i: int) -> tuple[int, int]:
    """Layer i's (superblock, slot) in the JAX stacks and the KV cache."""
    return divmod(i, cfg.moe_layer_period)


class Layer(nn.Module):
    """One block: ``attn`` holds its pre-norm ``ln`` and the projections;
    the FFN group, under the name ``group``, its pre-norm ``ln`` and the
    SwiGLU or MoE weights."""

    def __init__(self, attn_p: dict, ffn_p: dict, group: str):
        super().__init__()
        self.attn = frozen(attn_p)
        self.group = group
        setattr(self, group, frozen(ffn_p))

    @property
    def ffn(self) -> nn.ParameterDict:
        return getattr(self, self.group)


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
        self.layers = nn.ModuleList(Layer(a, f, ffn_group(cfg, i))
                                    for i, (a, f) in enumerate(layers))

    def meta_twin(self) -> "Transformer":
        """The same structure on the ``meta`` device (shapes and dtypes
        only): what ``cache_batch_axes`` probes."""
        return Transformer(self.cfg, meta_groups(self.embed),
                           torch.empty_like(self.final_norm, device="meta"),
                           [(meta_groups(layer.attn), meta_groups(layer.ffn))
                            for layer in self.layers])


def _check_family(cfg):
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the port's transformer runs the dense, MoE and "
            f"VLM families, not {cfg.family!r} (registry.get_model gives "
            f"each family its module)")
    if (cfg.family == "moe") != bool(cfg.n_experts):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with "
                         f"{cfg.n_experts} experts")
    if cfg.n_layers % cfg.moe_layer_period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"superblocks of {cfg.moe_layer_period}")


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def init(gen: torch.Generator, cfg, trainable: bool = False) -> Transformer:
    """Random parameters on ``gen.device``, drawn one tensor (an expert
    stack: one expert) at a time in f32 and cast to ``cfg.dtype`` (no f32
    copy of the whole model exists; an MoE layer's ``router`` and
    ``shared_gate`` stay f32); ``trainable`` turns their gradients on."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)

    def ffn(i):
        group = ffn_group(cfg, i)
        if group == "moe":
            return {"ln": ones(), **moe_mod.moe_init(gen, cfg, dtype)}
        width = (cfg.d_ff_dense or cfg.d_ff) if group == "mlp_dense" \
            else cfg.d_ff
        return {"ln": ones(), **mlp_init(gen, cfg.d_model, width, dtype)}

    layers = [({"ln": ones(),
                **attn.attn_init(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm,
                                 dtype)}, ffn(i))
              for i in range(cfg.n_layers)]
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                       cfg.tie_embeddings)
    return Transformer(cfg, embed, ones(), layers).requires_grad_(trainable)


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------
def _attn_sub(p, x, positions, cfg, mode: AttnMode):
    """The attention block, once a model rank where its heads are split;
    returns x and each share's (k, v) (``attention.over_heads``)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    rope = rope_sincos(positions, cfg.head_dim, cfg.rope_theta)

    def share(s):
        q, k, v = attn.qkv_project(s.p, h, positions, cfg.rope_theta,
                                   cfg.qk_norm, cfg.norm_eps, rope)
        o = attn.attend(q, k, v, causal=True, mode=mode)
        return dense(o, s.p["wo"], 2), (k, v)
    out, kvs = attn.over_heads(p, share)
    return x + out, kvs


def _ffn_sub(layer, x, cfg):
    p = layer.ffn
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if layer.group == "moe":
        return x + moe_mod.moe_ffn(p, h, cfg)
    return x + mlp_apply(p, h)


def _embed_input(params, batch):
    """The token embeddings after the batch's ``prefix_embeds`` (B,P,d), if
    it has them, cast to the model dtype; positions count from the
    prefix's first row."""
    x = embed_apply(params.embed, batch["tokens"])
    prefix = batch.get("prefix_embeds")
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return x, positions


def _layer(layer, x, cfg, positions, mode):
    x, _ = _attn_sub(layer.attn, x, positions, cfg, mode)
    return _ffn_sub(layer, x, cfg)


def forward(params, cfg, batch, mode: AttnMode = AttnMode()):
    """batch: tokens (B,S) [+ prefix_embeds (B,P,d)].  Returns logits
    (B, P + S, V)."""
    x, positions = _embed_input(params, batch)
    x = layer_stack(_layer, params.layers, x, cfg, positions, mode)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_apply(params.embed, x, cfg.tie_embeddings)


def loss_fn(params, cfg, batch, mode: AttnMode = AttnMode()):
    logits = forward(params, cfg, batch, mode)
    prefix = batch.get("prefix_embeds")
    if prefix is not None:
        logits = each(lambda z: z[:, prefix.shape[1]:], logits)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    return cross_entropy_loss(each(lambda z: z[:, :-1], logits),
                              labels[:, 1:],
                              None if mask is None else mask[:, 1:])


# ----------------------------------------------------------------------------
# prefill / decode
# ----------------------------------------------------------------------------
def cache_init(cfg, batch_size: int, smax: int, dtype=None, device=None,
               params=None):
    """Zero ``k``/``v``; with ``params`` (a pass's lead slice) held one
    block a model rank where its ``wk`` is split (``attention.kv_zeros``)."""
    dtype = torch_dtype(dtype or cfg.dtype)
    period = cfg.moe_layer_period
    shape = (cfg.n_layers // period, period, batch_size, smax,
             cfg.n_kv_heads, cfg.head_dim)
    wk = None if params is None else params.layers[0].attn["wk"]
    return {"k": attn.kv_zeros(shape, dtype, device, wk),
            "v": attn.kv_zeros(shape, dtype, device, wk)}


def prefill(params, cfg, batch, smax: int, mode: AttnMode = AttnMode()):
    """Full forward over the prompt (after its ``prefix_embeds``, if any);
    returns (cache, last-token logits)."""
    x, positions = _embed_input(params, batch)
    cache = cache_init(cfg, x.shape[0], smax, device=x.device, params=params)
    s = x.shape[1]
    for i, layer in enumerate(params.layers):
        x, kvs = _attn_sub(layer.attn, x, positions, cfg, mode)
        sb, j = superblock_slot(cfg, i)
        attn.store_kv((cache["k"], cache["v"]), (sb, j, slice(None),
                                                  slice(None, s)), kvs)
        x = _ffn_sub(layer, x, cfg)
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return cache, each(lambda z: z[:, 0], logits_apply(
        params.embed, x, cfg.tie_embeddings))


def decode_step(params, cfg, batch, cache):
    """batch: tokens (B,1), positions (B,) write index.  Writes the new
    keys/values into ``cache`` in place; returns (logits, cache)."""
    tokens, positions = batch["tokens"], batch["positions"]
    x = embed_apply(params.embed, tokens)
    pos2d = positions[:, None]
    rope = rope_sincos(pos2d, cfg.head_dim, cfg.rope_theta)
    for i, layer in enumerate(params.layers):
        ap = layer.attn
        h = rms_norm(x, ap["ln"], cfg.norm_eps)
        sb, j = superblock_slot(cfg, i)

        def share(s):
            q, k, v = attn.qkv_project(s.p, h, pos2d, cfg.rope_theta,
                                       cfg.qk_norm, cfg.norm_eps, rope)
            ck, cv = attn.cache_update(s.of(cache["k"])[sb, j],
                                       s.of(cache["v"])[sb, j], k, v,
                                       positions)
            o = attn.attend_decode(q, ck, cv, positions + 1)
            return dense(o, s.p["wo"], 2), None
        x = x + attn.over_heads(ap, share)[0]
        x = _ffn_sub(layer, x, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return each(lambda z: z[:, 0], logits_apply(
        params.embed, x, cfg.tie_embeddings)), cache
