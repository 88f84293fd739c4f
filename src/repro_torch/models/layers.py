"""Shared layers: norms, rotary embeddings, SwiGLU MLP, embedding, loss.

Parameter groups are mappings of name to tensor (an ``nn.ParameterDict`` in
a model, a plain dict in the tests) under the JAX package's names and
layouts, so each function reads like its JAX twin.  Initialisers draw from
a ``torch.Generator`` on its own device, one tensor at a time, in f32, and
cast to the model dtype.

Inside a data rank's pass whose model group splits a weight over
``model`` (``distributed/context.py``), the MLP, the embedding, the
logits and the loss take each model rank's share as the JAX rules lay it
out: the MLP's ``wg``/``wi`` column-parallel and ``wo`` row-parallel, then
the sum; the embedding vocabulary-parallel (each rank looks up the tokens
in its rows, zeros for the others, then the sum); the logits one piece a
rank, a list (:func:`each` maps over them); the cross entropy over those
pieces (:func:`vocab_parallel_loss`).  No rank holds logits of the whole
vocabulary.
"""
from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed.context import (carried, is_split, model_max,
                                             model_sum, over_model, twins)


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


# ----------------------------------------------------------------------------
# Rematerialisation: cfg.remat and cfg.remat_mode, as the JAX maybe_remat
# ----------------------------------------------------------------------------
# the aten products a matrix product reaches: torch.mm in dense(), bmm in
# the batched products (attention, the scan's backward, the experts)
_PRODUCTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                       torch.ops.aten.addmm.default))


class _Thread(threading.local):
    n = 0           # dense() calls open on this thread
    frame = None    # the "dots" layer body running on this thread: (its
    #                 kept products, replaying?, the next one to replay)


_weight_product = _Thread()


def _kept(out):
    """What a "dots" body keeps of a product: its output detached (the same
    storage, none of its autograd history) and its version."""
    return out.detach(), out._version


class _Replay(TorchDispatchMode):
    """Around the ``torch.mm`` of a dense() call when the backward
    recomputes a "dots" body: the product returns the output kept in the
    forward instead of running.  Autograd, above this mode, still records
    the product and saves its inputs, so the recompute saves what the
    forward saved."""

    def __init__(self, kept):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is not torch.ops.aten.mm.default:
            # the recompute's own bookkeeping (the saved inputs' detach)
            return func(*args, **(kwargs or {}))
        out, version = self.kept
        if out._version != version:
            raise RuntimeError("a dense() output kept for the recompute was "
                               "written in place")
        return out.detach()


def dense(x, w, dims: int = 1):
    """``x`` times the weight ``w``, contracting x's last ``dims`` dims
    with w's first ``dims`` (``bsd,de->bse``; ``bsd,dhk->bshk``;
    ``bshk,hkd->bsd`` with ``dims=2``), as one ``torch.mm``: a product with
    no batch dimension, the JAX ``dot_general`` that
    ``dots_with_no_batch_dims_saveable`` saves.  Every weight product of a
    layer body goes through here: in a "dots" body (``layer_stack``) the
    forward keeps its output and the backward's recompute is handed it
    back (``_Replay``) instead of running it again."""
    lead, tail = x.shape[:x.dim() - dims], w.shape[dims:]
    x2 = x.reshape(-1, math.prod(x.shape[x.dim() - dims:]))
    w2 = w.reshape(x2.shape[1], -1)
    frame = _weight_product.frame
    _weight_product.n += 1
    try:
        if frame is None:
            out = torch.mm(x2, w2)
        elif frame[1]:
            kept, _, at = frame
            with _Replay(kept[at[0]]):
                out = torch.mm(x2, w2)
            at[0] += 1
        else:
            out = torch.mm(x2, w2)
            frame[0].append(_kept(out))
    finally:
        _weight_product.n -= 1
    return out.view(*lead, *tail)


def _keeping_weight_products(fn):
    """``fn`` as a "dots" checkpoint's body: its first call (the forward)
    keeps every dense() product, each later call (the backward's
    recompute) is handed them back in the same order."""
    kept, calls = [], [0]

    def body(*args):
        calls[0] += 1
        outer = _weight_product.frame
        _weight_product.frame = (kept, calls[0] > 1, [0])
        try:
            return fn(*args)
        finally:
            _weight_product.frame = outer
    return body


def remat_mode(cfg) -> str:
    """What a layer body of ``cfg`` keeps for its backward, as the JAX
    ``maybe_remat`` reads ``cfg``: "none" (``cfg.remat`` False or
    ``remat_mode`` "none": no checkpoint, everything kept), "nothing"
    (recomputed whole) or "dots" (any other ``remat_mode``: the weight
    products' outputs kept, the rest recomputed)."""
    mode = getattr(cfg, "remat_mode", "dots")
    if not cfg.remat or mode == "none":
        return "none"
    return "nothing" if mode == "nothing" else "dots"


def layer_stack(fn, layers, x, cfg, *args):
    """``x = fn(layer, x, cfg, *args)`` over ``layers``.  Where gradients
    are recorded, each layer runs under ``torch.utils.checkpoint`` as
    ``remat_mode(cfg)`` says, the JAX package's ``maybe_remat`` of its
    scan body: it changes memory and what the backward recomputes, not
    numbers.  Under "dots" only the recompute's dense() products pass a
    dispatch mode; ``torch.utils.checkpoint``'s selective policies put
    one around every op of the body, and its Python cost a step outweighed
    the products it spared."""
    mode = remat_mode(cfg) if torch.is_grad_enabled() else "none"
    for layer in layers:
        if mode == "none":
            x = fn(layer, x, cfg, *args)
            continue
        body = fn if mode == "nothing" else _keeping_weight_products(fn)
        # the recompute may run on the autograd engine's thread: it takes
        # the mesh and the model group of the forward's
        x = torch.utils.checkpoint.checkpoint(carried(body), layer, x, cfg,
                                              *args, use_reentrant=False)
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
    """SwiGLU; where ``wg``'s spec splits its columns over ``model``, each
    rank's columns and its rows of ``wo``, the partial outputs summed."""
    if is_split(p["wg"]):
        return model_sum(over_model(lambda m, q: _mlp(q, x), twins(p)))
    return _mlp(p, x)


def _mlp(p, x):
    g = F.silu(dense(x, p["wg"]))
    u = dense(x, p["wi"])
    return dense(g * u, p["wo"])


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
    """The tokens' rows; vocabulary-parallel where the embedding's spec
    splits its rows over ``model``: each rank's rows give its tokens and
    zeros elsewhere, and the sum has exactly one term that is not zero."""
    if not is_split(p["embedding"]):
        return F.embedding(tokens, p["embedding"])

    def part(m, q):
        w = q["embedding"]
        local = tokens - m * w.shape[0]
        mine = (local >= 0) & (local < w.shape[0])
        e = F.embedding(torch.where(mine, local, 0), w)
        return torch.where(mine[..., None], e, e.new_zeros(()))
    return model_sum(over_model(part, twins(p)))


def logits_apply(p, x, tie: bool):
    """(..., V) logits; where the head's spec splits the vocabulary over
    ``model``, a list of each rank's (..., V / m) piece."""
    w = p["embedding"] if tie else p["lm_head"]
    if is_split(w):
        return over_model(lambda m, q: _logits(q, x, tie), twins(p))
    return _logits(p, x, tie)


def _logits(p, x, tie: bool):
    if tie:
        return x @ p["embedding"].T
    return x @ p["lm_head"]


def each(fn, logits):
    """``fn`` of the logits, or of each rank's piece of them."""
    if isinstance(logits, list):
        return [None if z is None else fn(z) for z in logits]
    return fn(logits)


def vocab_parallel_loss(pieces: list, labels, mask=None):
    """:func:`cross_entropy_loss` of logits held one vocabulary piece a
    model rank (rank m's ids ``[m V/m, (m+1) V/m)``): the max and the sum
    of exponentials in f32 across the ranks, and the label's logit from
    the rank that owns it."""
    labels = labels.long()
    top = model_max(over_model(lambda m, z: z.float().amax(-1),
                               pieces)).detach()
    total = model_sum(over_model(lambda m, z: torch.exp(
        z.float() - top[..., None]).sum(-1), pieces))

    def label_logit(m, z):
        n = z.shape[-1]
        local = labels - m * n
        mine = (local >= 0) & (local < n)
        ll = torch.gather(z, -1, torch.where(mine, local, 0)[..., None])
        return torch.where(mine, ll[..., 0].float(), 0.0)
    nll = top + torch.log(total) - model_sum(over_model(label_logit,
                                                        pieces))
    return _mean_nll(nll, mask)


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token-level CE. logits (..., V) any float dtype; stable in f32.
    A list of vocabulary pieces goes to :func:`vocab_parallel_loss`."""
    if isinstance(logits, list):
        return vocab_parallel_loss(logits, labels, mask)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return _mean_nll(lse - ll, mask)


def _mean_nll(nll, mask):
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
