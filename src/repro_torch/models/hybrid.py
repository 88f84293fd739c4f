"""Zamba2-style hybrid, the twin of the JAX package's ``models/hybrid.py``:
a stack of Mamba2 blocks with ONE shared attention+MLP transformer block
(single weight copy) applied every ``cfg.shared_attn_period`` blocks.

Layout: n_layers = G groups x P layers (P = shared_attn_period).  Each group
starts with the shared block's application (its own KV cache slot),
followed by P Mamba2 blocks.  The model is an ``nn.Module`` whose parameter
groups are ``nn.ParameterDict``s under the JAX package's names: ``shared``
(``ln1``, ``attn``, ``ln2``, ``mlp``) and ``layers``, an ``nn.ModuleList``
of G groups, each an ``nn.ModuleList`` of P layers (``ln`` and the Mamba2
weights of ``ssm.mamba2_init``), walked in Python loops where the JAX
package scans.  ``cfg.remat`` and ``cfg.remat_mode`` checkpoint each
group of a forward that records gradients, as the JAX package's
``maybe_remat`` wraps its group body (``layers.layer_stack``): it changes
memory and the backward's work, not numbers.

The cache is flat, as the serving engines take it (the JAX cache nests the
Mamba2 state under ``ssm``): ``k`` and ``v`` (G, B, smax, K, hd), the
shared block's keys and values of each group, in the cache dtype; ``conv``
(G, P, B, K-1, d_inner + 2N) in the cache dtype and ``h`` (G, P, B, nh,
head_dim, N) in f32, each Mamba2 layer's state.  The batch axis is 1 of
``k``/``v`` and 2 of ``conv``/``h``, as in the JAX layout
(``ssm/conv``, ``ssm/h``).  ``prefill`` takes each Mamba2 layer's final
state from the same ``ssm_scan`` call that computes its output;
``decode_step`` writes the new keys, values, conv windows and states into
the cache in place and returns it.

Inside a model group that splits the shared block's heads and ff columns
over ``model`` (``attention.over_heads``, ``layers.mlp_apply``), that
block runs once a model rank, its ``k``/``v`` cache held one block a rank
where the spec splits K; the JAX rules give the Mamba2 weights no
``model`` split, so the Mamba2 layers run whole, once a data rank.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.attention import AttnMode
from repro_torch.models.layers import (cross_entropy_loss, dense, each,
                                       embed_apply, embed_init, frozen,
                                       layer_stack,
                                       logits_apply, meta_groups, mlp_apply,
                                       mlp_init, rms_norm, rope_sincos,
                                       torch_dtype)


def _groups(cfg):
    p = cfg.shared_attn_period
    if p <= 0 or cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"groups of shared_attn_period {p}")
    return cfg.n_layers // p, p


def _check_family(cfg):
    if cfg.family != "hybrid" or cfg.ssm_version != 2:
        raise NotImplementedError(
            f"{cfg.name}: models/hybrid.py runs Mamba2 stacks with a shared "
            f"attention block (zamba2), not family {cfg.family!r} with "
            f"ssm_version {cfg.ssm_version}")
    ssm.check_scan_dtype(cfg)
    _groups(cfg)


class HybridLM(nn.Module):
    def __init__(self, cfg, embed: dict, final_norm, shared: dict,
                 layers: list):
        super().__init__()
        _check_family(cfg)
        g, p = _groups(cfg)
        if len(layers) != g or any(len(group) != p for group in layers):
            raise ValueError(f"groups of {[len(x) for x in layers]} layers "
                             f"for a config of {g} x {p}")
        self.cfg = cfg
        self.embed = frozen(embed)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.shared = frozen(shared)
        self.layers = nn.ModuleList(
            nn.ModuleList(frozen(lp) for lp in group) for group in layers)

    def meta_twin(self) -> "HybridLM":
        """The same structure on the ``meta`` device (shapes and dtypes
        only): what ``cache_batch_axes`` probes."""
        return HybridLM(self.cfg, meta_groups(self.embed),
                        torch.empty_like(self.final_norm, device="meta"),
                        meta_groups(self.shared),
                        [[meta_groups(lp) for lp in group]
                         for group in self.layers])


def init(gen, cfg, trainable: bool = False) -> HybridLM:
    """Random parameters on ``gen.device``, drawn one tensor at a time in
    f32 and cast to ``cfg.dtype`` (Mamba2's ``A_log``, ``D`` and
    ``dt_bias`` stay f32); ``trainable`` turns their gradients on."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    g, p = _groups(cfg)

    def ones():
        return torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)

    layers = [[{"ln": ones(), **ssm.mamba2_init(gen, cfg, dtype)}
               for _ in range(p)] for _ in range(g)]
    shared = {
        "ln1": ones(),
        "attn": attn.attn_init(gen, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim, False, dtype),
        "ln2": ones(),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                       cfg.tie_embeddings)
    return HybridLM(cfg, embed, ones(), shared,
                    layers).requires_grad_(trainable)


def _shared_block(shared, x, positions, cfg, mode, cache=None,
                  write_pos=None):
    """The shared attention+MLP block.  Without ``cache``: causal attention
    over x's tokens, returning each head share's keys and values
    (``attention.over_heads``); with ``cache`` (a group's (k, v) slot,
    whole or one block a model rank): one token a sequence written at
    ``write_pos`` and attended against the cache."""
    h = rms_norm(x, shared["ln1"], cfg.norm_eps)
    rope = rope_sincos(positions, cfg.head_dim, cfg.rope_theta)

    def share(s):
        q, k, v = attn.qkv_project(s.p, h, positions, cfg.rope_theta, False,
                                   cfg.norm_eps, rope)
        if cache is None:
            o = attn.attend(q, k, v, causal=True, mode=mode)
        else:
            ck, cv = attn.cache_update(s.of(cache[0]), s.of(cache[1]), k, v,
                                       write_pos)
            o = attn.attend_decode(q, ck, cv, write_pos + 1)
        return dense(o, s.p["wo"], 2), (k, v)
    out, kvs = attn.over_heads(shared["attn"], share)
    x = x + out
    h = rms_norm(x, shared["ln2"], cfg.norm_eps)
    return x + mlp_apply(shared["mlp"], h), kvs


def _mamba_layer(lp, x, cfg):
    return x + ssm.mamba2_apply(lp, rms_norm(x, lp["ln"], cfg.norm_eps), cfg)


def _group_fwd(glayers, x, cfg, shared, positions, mode):
    x, _ = _shared_block(shared, x, positions, cfg, mode)
    for lp in glayers:
        x = _mamba_layer(lp, x, cfg)
    return x


def _embed(params, tokens):
    x = embed_apply(params.embed, tokens)
    b, s, _ = x.shape
    return x, torch.arange(s, device=x.device)[None, :].expand(b, s)


def forward(params, cfg, batch, mode: AttnMode = AttnMode()):
    """batch: tokens (B,S).  Returns logits (B, S, V)."""
    x, positions = _embed(params, batch["tokens"])
    x = layer_stack(_group_fwd, params.layers, x, cfg, params.shared,
                    positions, mode)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_apply(params.embed, x, cfg.tie_embeddings)


def loss_fn(params, cfg, batch, mode: AttnMode = AttnMode()):
    logits = forward(params, cfg, batch, mode)
    mask = batch.get("loss_mask")
    return cross_entropy_loss(each(lambda z: z[:, :-1], logits),
                              batch["labels"][:, 1:],
                              None if mask is None else mask[:, 1:])


# ----------------------------------------------------------------------------
# cache: per-group shared-attention KV + per-layer Mamba2 state
# ----------------------------------------------------------------------------
def cache_init(cfg, batch_size: int, smax: int, dtype=None, device=None,
               params=None):
    """Zero caches; with ``params`` (a pass's lead slice) ``k``/``v`` held
    one block a model rank where the shared ``wk`` is split
    (``attention.kv_zeros``)."""
    dtype = torch_dtype(dtype or cfg.dtype)
    g, p = _groups(cfg)
    kv = (g, batch_size, smax, cfg.n_kv_heads, cfg.head_dim)
    st = ssm.mamba2_state_init(batch_size, cfg, dtype, device)
    wk = None if params is None else params.shared["attn"]["wk"]
    return {"k": attn.kv_zeros(kv, dtype, device, wk),
            "v": attn.kv_zeros(kv, dtype, device, wk),
            **{k: t.new_zeros((g, p) + t.shape) for k, t in st.items()}}


def prefill(params, cfg, batch, smax: int, mode: AttnMode = AttnMode()):
    """Full forward over the prompt; returns (cache, last-token logits)."""
    x, positions = _embed(params, batch["tokens"])
    s = x.shape[1]
    cache = cache_init(cfg, x.shape[0], smax, device=x.device, params=params)
    for g, glayers in enumerate(params.layers):
        x, kvs = _shared_block(params.shared, x, positions, cfg, mode)
        attn.store_kv((cache["k"], cache["v"]), (g, slice(None),
                                                  slice(None, s)), kvs)
        for p, lp in enumerate(glayers):
            y, st = ssm.mamba2_apply(lp, rms_norm(x, lp["ln"], cfg.norm_eps),
                                     cfg, return_state=True)
            cache["conv"][g, p] = st["conv"]
            cache["h"][g, p] = st["h"]
            x = x + y
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return cache, each(lambda z: z[:, 0], logits_apply(
        params.embed, x, cfg.tie_embeddings))


def decode_step(params, cfg, batch, cache):
    """batch: tokens (B,1), positions (B,) write index.  Writes the new
    keys, values, conv windows and states into ``cache`` in place; returns
    (logits, cache)."""
    tokens, positions = batch["tokens"], batch["positions"]
    x = embed_apply(params.embed, tokens)
    for g, glayers in enumerate(params.layers):
        x, _ = _shared_block(params.shared, x, positions[:, None], cfg,
                             AttnMode(), cache=(_at(cache["k"], g),
                                                _at(cache["v"], g)),
                             write_pos=positions)
        for p, lp in enumerate(glayers):
            y, _ = ssm.mamba2_decode(lp, rms_norm(x, lp["ln"], cfg.norm_eps),
                                     {"conv": cache["conv"][g, p],
                                      "h": cache["h"][g, p]}, cfg)
            x = x + y
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return each(lambda z: z[:, 0], logits_apply(
        params.embed, x, cfg.tie_embeddings)), cache


def _at(leaf, g: int):
    """Group g's slot of a cache leaf, whole or one block a model rank."""
    return each(lambda t: t[g], leaf)
