"""Jamba (AI21-Jamba2-Mini): a hybrid of Mamba1 and attention mixers with
dense and expert FFNs, composed from the port's own blocks.

Layer i is ``x = x + mixer(rms(x))`` then ``x = x + ffn(rms(x))``.  The
mixer is GQA attention where ``cfg.is_attn_layer(i)`` (``i % 8 == 4``),
with no positional encoding (``attention.qkv_project(rotary=False)``),
and a Mamba1 block elsewhere (``ssm.mamba1_apply``, its block carrying
learned RMS norms on dt, B and C: ``dt_norm``, ``B_norm``, ``C_norm``).
The FFN is the dropless expert layer where ``cfg.is_moe_layer(i)``
(``i % 2 == 1``: ``moe.moe_ffn_dropless``, the published routing over
``cfg.n_router_experts``, the ``cfg.n_experts`` held from
``cfg.first_expert``), and a SwiGLU MLP of width ``d_ff`` elsewhere.  A
final RMS norm and the untied head follow.

Each layer holds two parameter groups, ``mixer`` (its pre-norm ``ln`` and
the attention or Mamba1 weights) and ``ffn`` (its pre-norm ``ln`` and the
router and expert stacks, ``router`` (d, R) f32, ``wg``/``wi`` (E, d, f),
``wo`` (E, f, d), or the MLP's ``wg``/``wi``/``wo``).  The family is the
port's own: the JAX package has no Jamba, and nothing here is converted
to or from its layout.

The one slot cache holds both kinds of state, each with its batch axis at
1: ``conv`` (n_mamba, B, K-1, d_inner) and ``h`` (n_mamba, B, d_inner, N)
f32 for the Mamba layers in order, ``k`` and ``v`` (n_attn, B, K, smax,
hd) for the attention layers in order: each kv head's keys contiguous, so
that decode's products read the cache in place
(``attention.attend_decode_heads``).  ``decode_step`` writes the new
conv windows, states, keys and values into it in place, its shapes depend
on the batch alone (attention reads the whole padded cache, masked by
``positions + 1``), and nothing is read back to the host (the expert
layer's group ends stay on the device): the serving engine may capture it
as a CUDA graph (``DECODE_GRAPH``).

Each expert layer's issue runs in a ``moe`` span (attributes ``layer``,
``tokens``) of the thread's flight recorder, in prefill and in an eager
decode step; a captured decode step records it once, at capture.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.attention import AttnMode
from repro_torch.models.layers import (cross_entropy_loss, dense,
                                       dense_init, each, embed_apply,
                                       embed_init, frozen, layer_stack,
                                       logits_apply, meta_groups, mlp_apply,
                                       mlp_init, rms_norm, torch_dtype)
from repro_torch.models.moe import expert_init, moe_ffn_dropless
from repro_torch.obs.spans import current_recorder

# decode_step may be captured once and replayed (models/registry.py)
DECODE_GRAPH = True


class Layer(nn.Module):
    """Layer ``index``: its ``mixer`` and ``ffn`` groups, and which kinds
    they are (``attention``, ``experts``)."""

    def __init__(self, mixer: dict, ffn: dict, index: int, cfg):
        super().__init__()
        self.index = index
        self.attention = cfg.is_attn_layer(index)
        self.experts = cfg.is_moe_layer(index)
        self.mixer = frozen(mixer)
        self.ffn = frozen(ffn)


class JambaLM(nn.Module):
    def __init__(self, cfg, embed: dict, final_norm, layers: list):
        super().__init__()
        _check_family(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} layers for a config of "
                             f"{cfg.n_layers}")
        self.cfg = cfg
        self.embed = frozen(embed)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(Layer(m, f, i, cfg)
                                    for i, (m, f) in enumerate(layers))

    def meta_twin(self) -> "JambaLM":
        """The same structure on the ``meta`` device (shapes and dtypes
        only): what ``cache_batch_axes`` probes."""
        return JambaLM(self.cfg, meta_groups(self.embed),
                       torch.empty_like(self.final_norm, device="meta"),
                       [(meta_groups(layer.mixer), meta_groups(layer.ffn))
                        for layer in self.layers])


def _check_family(cfg):
    if cfg.family != "jamba" or cfg.ssm_version != 1 or \
            not hasattr(cfg, "is_attn_layer"):
        raise NotImplementedError(
            f"{cfg.name}: models/jamba.py runs a JambaConfig (Mamba1 and "
            f"attention mixers), not family {cfg.family!r}")
    ssm.check_scan_dtype(cfg)


def _split(cfg) -> tuple:
    """(Mamba layers, attention layers): the cache's two stacks."""
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    return cfg.n_layers - n_attn, n_attn


def init(gen, cfg, trainable: bool = False) -> JambaLM:
    """Random parameters on ``gen.device``, drawn one tensor (an expert
    stack: one expert) at a time in f32 and cast to ``cfg.dtype`` (the
    router, ``A_log`` and ``D`` stay f32); ``trainable`` turns their
    gradients on."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model

    def ones():
        return torch.ones((d,), dtype=dtype, device=gen.device)

    def mixer(i):
        if cfg.is_attn_layer(i):
            return {"ln": ones(), **attn.attn_init(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, False,
                dtype)}
        return {"ln": ones(), **ssm.mamba1_init(gen, cfg, dtype),
                **{name: torch.ones((n,), dtype=dtype, device=gen.device)
                   for name, n in (("dt_norm", cfg.dt_rank),
                                   ("B_norm", cfg.ssm_state),
                                   ("C_norm", cfg.ssm_state))}}

    def ffn(i):
        if not cfg.is_moe_layer(i):
            return {"ln": ones(), **mlp_init(gen, d, cfg.d_ff, dtype)}
        e, f = cfg.n_experts, cfg.d_ff
        return {"ln": ones(),
                "router": dense_init(gen, (d, cfg.n_router_experts),
                                     torch.float32),
                "wg": expert_init(gen, e, (d, f), dtype),
                "wi": expert_init(gen, e, (d, f), dtype),
                "wo": expert_init(gen, e, (f, d), dtype)}

    layers = [(mixer(i), ffn(i)) for i in range(cfg.n_layers)]
    embed = embed_init(gen, cfg.vocab_size, d, dtype, False)
    return JambaLM(cfg, embed, ones(), layers).requires_grad_(trainable)


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------
def _qkv(p, h, cfg):
    return attn.qkv_project(p, h, None, cfg.rope_theta, False, cfg.norm_eps,
                            rotary=False)


def _ffn(layer, x, cfg):
    p = layer.ffn
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if not layer.experts:
        return x + mlp_apply(p, h)
    with current_recorder().span("moe", layer=layer.index,
                                 tokens=h.shape[0] * h.shape[1]):
        return x + moe_ffn_dropless(p, h, cfg)


def _layer(layer, x, cfg, mode):
    p = layer.mixer
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if layer.attention:
        q, k, v = _qkv(p, h, cfg)
        x = x + dense(attn.attend(q, k, v, causal=True, mode=mode),
                      p["wo"], 2)
    else:
        x = x + ssm.mamba1_apply(p, h, cfg)
    return _ffn(layer, x, cfg)


def forward(params, cfg, batch, mode: AttnMode = AttnMode()):
    """batch: tokens (B,S).  Returns logits (B, S, V)."""
    x = embed_apply(params.embed, batch["tokens"])
    x = layer_stack(_layer, params.layers, x, cfg, mode)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_apply(params.embed, x, False)


def loss_fn(params, cfg, batch, mode: AttnMode = AttnMode()):
    logits = forward(params, cfg, batch, mode)
    mask = batch.get("loss_mask")
    return cross_entropy_loss(each(lambda z: z[:, :-1], logits),
                              batch["labels"][:, 1:],
                              None if mask is None else mask[:, 1:])


# ----------------------------------------------------------------------------
# prefill / decode
# ----------------------------------------------------------------------------
def cache_init(cfg, batch_size: int, smax: int, dtype=None, device=None,
               params=None):
    """Zero Mamba states and KV cache (``params`` is the uniform API's)."""
    dtype = torch_dtype(dtype or cfg.dtype)
    n_mamba, n_attn = _split(cfg)
    st = ssm.mamba1_state_init(batch_size, cfg, dtype, device)
    kv = (n_attn, batch_size, cfg.n_kv_heads, smax, cfg.head_dim)
    return {"conv": st["conv"].new_zeros((n_mamba,) + st["conv"].shape),
            "h": st["h"].new_zeros((n_mamba,) + st["h"].shape),
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


def prefill(params, cfg, batch, smax: int, mode: AttnMode = AttnMode()):
    """Full forward over the prompt; returns (cache, last-token logits)."""
    x = embed_apply(params.embed, batch["tokens"])
    s = x.shape[1]
    cache = cache_init(cfg, x.shape[0], smax, device=x.device)
    m = a = 0
    for layer in params.layers:
        p = layer.mixer
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        if layer.attention:
            q, k, v = _qkv(p, h, cfg)
            cache["k"][a, :, :, :s] = k.transpose(1, 2)
            cache["v"][a, :, :, :s] = v.transpose(1, 2)
            a += 1
            x = x + dense(attn.attend(q, k, v, causal=True, mode=mode),
                          p["wo"], 2)
        else:
            y, st = ssm.mamba1_apply(p, h, cfg, return_state=True)
            cache["conv"][m] = st["conv"]
            cache["h"][m] = st["h"]
            m += 1
            x = x + y
        x = _ffn(layer, x, cfg)
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return cache, each(lambda z: z[:, 0], logits_apply(params.embed, x,
                                                       False))


def decode_step(params, cfg, batch, cache):
    """batch: tokens (B,1), positions (B,) write index.  Writes the new conv
    windows, states, keys and values into ``cache`` in place; returns
    (logits, cache)."""
    tokens, positions = batch["tokens"], batch["positions"]
    x = embed_apply(params.embed, tokens)
    m = a = 0
    for layer in params.layers:
        p = layer.mixer
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        if layer.attention:
            q, k, v = _qkv(p, h, cfg)
            ck, cv = attn.cache_update_heads(cache["k"][a], cache["v"][a],
                                             k, v, positions)
            a += 1
            o = attn.attend_decode_heads(q, ck, cv, positions + 1)
            x = x + dense(o, p["wo"], 2)
        else:
            y, _ = ssm.mamba1_decode(p, h, {"conv": cache["conv"][m],
                                            "h": cache["h"][m]}, cfg)
            m += 1
            x = x + y
        x = _ffn(layer, x, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return each(lambda z: z[:, 0], logits_apply(params.embed, x,
                                                 False)), cache
