"""Shared layers: norms, rotary embeddings, SwiGLU MLP, embedding, loss.

Parameter groups are mappings of name to tensor (an ``nn.ParameterDict`` in
a model, a plain dict in the tests) under the JAX package's names and
layouts, so each function reads like its JAX twin.  Initialisers draw from
a ``torch.Generator`` on its own device, one tensor at a time, in f32, and
cast to the model dtype.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


def torch_dtype(name) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def frozen(groups: dict) -> nn.ParameterDict:
    """A parameter group under its JAX names, carrying no gradient: what
    serving holds.  A nested group (an MoE layer's ``shared`` MLP) becomes
    a nested ``ParameterDict``.  Training turns gradients on for the whole
    model (``init(..., trainable=True)`` or ``model.requires_grad_()``)."""
    return nn.ParameterDict({
        k: frozen(v) if isinstance(v, dict)
        else nn.Parameter(v, requires_grad=False)
        for k, v in groups.items()})


def meta_groups(groups) -> dict:
    """A parameter group's tensors as ``meta`` tensors of the same shapes
    and dtypes (nested groups as nested dicts): what a model's
    ``meta_twin`` is built from."""
    return {k: meta_groups(v) if isinstance(v, nn.ParameterDict)
            else torch.empty_like(v, device="meta")
            for k, v in groups.items()}


def layer_stack(fn, layers, x, cfg, *args):
    """``x = fn(layer, x, cfg, *args)`` over ``layers``.  Where ``cfg.remat``
    asks and gradients are recorded, each layer runs under
    ``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` of its
    scan body: it changes memory, not numbers."""
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            x = torch.utils.checkpoint.checkpoint(fn, layer, x, cfg, *args,
                                                  use_reentrant=False)
        else:
            x = fn(layer, x, cfg, *args)
    return x


def truncated_normal_init(gen: torch.Generator, shape, scale: float,
                          dtype) -> torch.Tensor:
    """Truncated normal on [-2, 2] times scale / sqrt(shape[0])."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (scale / math.sqrt(max(fan_in, 1)))).to(dtype)


def dense_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Normal times 1/sqrt(fan_in), fan_in the product of every dim but the
    last."""
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (t * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    """Computed in f32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


# ----------------------------------------------------------------------------
# Rotary position embeddings (rotate-half / NeoX convention)
# ----------------------------------------------------------------------------
def rope_sincos(positions, head_dim: int, theta: float):
    """positions: (...,) int -> sin, cos of shape (..., head_dim/2), f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x, sin, cos):
    """x: (..., S, n_heads, head_dim); sin/cos: (..., S, head_dim/2).
    Computed against f32 sin/cos, cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s = sin[..., None, :]                  # broadcast over the heads axis
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def sinusoidal_positions(n_pos: int, d_model: int, device=None):
    """Classic transformer sin/cos absolute position table (no params),
    (n_pos, d_model) f32: computed in numpy float64 and stored in f32 as
    the JAX package's, so both tables hold the same bits.  Callers cast it
    to the model dtype.  One table per (n_pos, d_model, device) is kept and
    shared (decode reads it every step): read it, never write into it."""
    return _sinusoid_table(n_pos, d_model, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=8)
def _sinusoid_table(n_pos: int, d_model: int, device: torch.device):
    pos = np.arange(n_pos)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    angle = pos / np.power(10000.0, dim / d_model)
    table = np.zeros((n_pos, d_model), np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return torch.from_numpy(table).to(device)


# ----------------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
    return {"wg": dense_init(gen, (d_model, d_ff), dtype),
            "wi": dense_init(gen, (d_model, d_ff), dtype),
            "wo": dense_init(gen, (d_ff, d_model), dtype)}


def mlp_apply(p, x):
    g = F.silu(x @ p["wg"])
    u = x @ p["wi"]
    return (g * u) @ p["wo"]


# ----------------------------------------------------------------------------
# Embedding + LM head + loss
# ----------------------------------------------------------------------------
def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype,
               tie: bool) -> dict:
    p = {"embedding": truncated_normal_init(gen, (vocab, d_model), 1.0,
                                            dtype)}
    if not tie:
        p["lm_head"] = dense_init(gen, (d_model, vocab), dtype)
    return p


def embed_apply(p, tokens):
    return F.embedding(tokens, p["embedding"])


def logits_apply(p, x, tie: bool):
    if tie:
        return x @ p["embedding"].T
    return x @ p["lm_head"]


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token-level CE. logits (..., V) any float dtype; stable in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
