"""Whisper-style encoder-decoder, the audio family: the twin of the JAX
package's ``src/repro/models/encdec.py``.  The conv/log-mel frontend is a
STUB, as there: ``batch["frames"]`` carries precomputed frame embeddings
(B, n_encoder_frames, d_model).  Sinusoidal absolute positions are added
to the frames and to the decoder's tokens (the decoder's self-attention
also applies RoPE, as the JAX twin's ``qkv_project`` does).  Decoder
layers: causal self-attention (KV cache), cross-attention over the
encoder's output (its keys and values computed once, at prefill) and an
MLP.

The model is an ``nn.Module`` whose parameter groups are
``nn.ParameterDict``s under the JAX package's names and layouts:
``encoder`` layers of ``ln1``, ``attn`` (``wq``/``wk``/``wv`` (d, H, hd),
``wo`` (H, hd, d)), ``ln2``, ``mlp``; ``decoder`` layers of ``ln1``,
``self``, ``ln2``, ``cross``, ``ln3``, ``mlp``; ``enc_norm`` and
``final_norm``.  Both stacks are ``nn.ModuleList``s walked in a Python
loop; ``cfg.remat`` and ``cfg.remat_mode`` checkpoint each layer of a
forward that records gradients, as the transformer does
(``layers.layer_stack``).

On a CUDA tensor every non-causal attention (the encoder's self-attention,
prefill's cross-attention over the frames) and the decoder's causal
self-attention go through the ``flash_attention`` kernel (``attend``);
decode attends one token against the caches in plain PyTorch
(``attend_decode``).  The cache keeps the JAX layout: ``k``/``v`` (L, B,
smax, K, hd) and ``xk``/``xv`` (L, B, n_encoder_frames, H, hd), the batch
on axis 1 of each; ``decode_step`` writes the new token's keys and values
into ``k``/``v`` in place and returns the cache.  The JAX ``prefill``
computes the cross keys and values twice, for the layer and for the
cache; this one computes them once (the same numbers).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.attention import AttnMode
from repro_torch.models.layers import (cross_entropy_loss, dense,
                                       embed_apply, embed_init, frozen,
                                       layer_stack,
                                       logits_apply, meta_groups, mlp_apply,
                                       mlp_init, rms_norm,
                                       sinusoidal_positions, torch_dtype)


class EncDec(nn.Module):
    def __init__(self, cfg, embed: dict, enc_norm, final_norm,
                 encoder: list, decoder: list):
        super().__init__()
        _check_family(cfg)
        if len(encoder) != cfg.n_encoder_layers or \
                len(decoder) != cfg.n_layers:
            raise ValueError(f"{len(encoder)} + {len(decoder)} layers for a "
                             f"config of {cfg.n_encoder_layers} + "
                             f"{cfg.n_layers}")
        self.cfg = cfg
        self.embed = frozen(embed)
        self.enc_norm = nn.Parameter(enc_norm, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.encoder = nn.ModuleList(frozen(p) for p in encoder)
        self.decoder = nn.ModuleList(frozen(p) for p in decoder)

    def meta_twin(self) -> "EncDec":
        """The same structure on the ``meta`` device (shapes and dtypes
        only): what ``cache_batch_axes`` probes."""
        return EncDec(self.cfg, meta_groups(self.embed),
                      torch.empty_like(self.enc_norm, device="meta"),
                      torch.empty_like(self.final_norm, device="meta"),
                      [meta_groups(p) for p in self.encoder],
                      [meta_groups(p) for p in self.decoder])


def _check_family(cfg):
    if cfg.family != "audio":
        raise NotImplementedError(
            f"{cfg.name}: models/encdec.py runs the audio family, not "
            f"{cfg.family!r}")


def init(gen: torch.Generator, cfg, trainable: bool = False) -> EncDec:
    """Random parameters on ``gen.device``, drawn one tensor at a time in
    f32 and cast to ``cfg.dtype``; ``trainable`` turns their gradients
    on."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim

    def ones():
        return torch.ones((d,), dtype=dtype, device=gen.device)

    def enc_layer():
        return {"ln1": ones(),
                "attn": attn.attn_init(gen, d, h, h, hd, False, dtype),
                "ln2": ones(), "mlp": mlp_init(gen, d, cfg.d_ff, dtype)}

    def dec_layer():
        return {"ln1": ones(),
                "self": attn.attn_init(gen, d, h, cfg.n_kv_heads, hd, False,
                                       dtype),
                "ln2": ones(),
                "cross": attn.attn_init(gen, d, h, h, hd, False, dtype),
                "ln3": ones(), "mlp": mlp_init(gen, d, cfg.d_ff, dtype)}

    embed = embed_init(gen, cfg.vocab_size, d, dtype, cfg.tie_embeddings)
    encoder = [enc_layer() for _ in range(cfg.n_encoder_layers)]
    decoder = [dec_layer() for _ in range(cfg.n_layers)]
    return EncDec(cfg, embed, ones(), ones(), encoder,
                  decoder).requires_grad_(trainable)


def _posenc(x):
    pe = sinusoidal_positions(x.shape[1], x.shape[2], x.device)
    return x + pe.to(x.dtype)[None]


def _heads(x, w):
    """(B,S,d) x (d,H,hd) -> (B,S,H,hd)."""
    return dense(x, w)


def _out(o, w):
    """(B,S,H,hd) x (H,hd,d) -> (B,S,d)."""
    return dense(o, w, 2)


def _enc_layer(lp, x, cfg, mode):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a = lp["attn"]
    o = attn.attend(_heads(h, a["wq"]), _heads(h, a["wk"]),
                    _heads(h, a["wv"]), causal=False, mode=mode)
    x = x + _out(o, a["wo"])
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h)


def encode(params, cfg, frames, mode: AttnMode = AttnMode()):
    """frames (B,F,d) -> the encoder's output (B,F,d) in the model dtype."""
    x = _posenc(frames.to(torch_dtype(cfg.dtype)))
    x = layer_stack(_enc_layer, params.encoder, x, cfg, mode)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def _cross_kv(lp, enc_out):
    c = lp["cross"]
    return _heads(enc_out, c["wk"]), _heads(enc_out, c["wv"])


def _dec_layer(lp, x, enc_out, cfg, mode):
    """One decoder layer over a whole sequence (forward and prefill):
    returns x and the layer's self (k, v) and cross (k, v)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    b, s, _ = h.shape
    pos = torch.arange(s, device=h.device)[None, :].expand(b, s)
    q, k, v = attn.qkv_project(lp["self"], h, pos, cfg.rope_theta, False,
                               cfg.norm_eps)
    o = attn.attend(q, k, v, causal=True, mode=mode)
    x = x + _out(o, lp["self"]["wo"])
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    ek, ev = _cross_kv(lp, enc_out)
    o = attn.attend(_heads(h, lp["cross"]["wq"]), ek, ev, causal=False,
                    mode=mode)
    x = x + _out(o, lp["cross"]["wo"])
    h = rms_norm(x, lp["ln3"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h), (k, v), (ek, ev)


def _dec_layer_x(lp, x, cfg, enc_out, mode):
    return _dec_layer(lp, x, enc_out, cfg, mode)[0]


def forward(params, cfg, batch, mode: AttnMode = AttnMode()):
    """batch: frames (B,F,d), tokens (B,S) -> logits (B,S,V)."""
    enc_out = encode(params, cfg, batch["frames"], mode)
    x = _posenc(embed_apply(params.embed, batch["tokens"]))
    x = layer_stack(_dec_layer_x, params.decoder, x, cfg, enc_out, mode)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_apply(params.embed, x, cfg.tie_embeddings)


def loss_fn(params, cfg, batch, mode: AttnMode = AttnMode()):
    logits = forward(params, cfg, batch, mode)
    mask = batch.get("loss_mask")
    return cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                              None if mask is None else mask[:, 1:])


def cache_init(cfg, batch_size: int, smax: int, dtype=None, device=None):
    dtype = torch_dtype(dtype or cfg.dtype)
    L = cfg.n_layers
    self_shape = (L, batch_size, smax, cfg.n_kv_heads, cfg.head_dim)
    cross_shape = (L, batch_size, cfg.n_encoder_frames, cfg.n_heads,
                   cfg.head_dim)
    return {"k": torch.zeros(self_shape, dtype=dtype, device=device),
            "v": torch.zeros(self_shape, dtype=dtype, device=device),
            "xk": torch.zeros(cross_shape, dtype=dtype, device=device),
            "xv": torch.zeros(cross_shape, dtype=dtype, device=device)}


def prefill(params, cfg, batch, smax: int, mode: AttnMode = AttnMode()):
    """Encode the frames, run the decoder over the prompt; returns (cache,
    last-token logits)."""
    enc_out = encode(params, cfg, batch["frames"], mode)
    x = _posenc(embed_apply(params.embed, batch["tokens"]))
    b, s, _ = x.shape
    cache = cache_init(cfg, b, smax, device=x.device)
    for i, lp in enumerate(params.decoder):
        x, (k, v), (ek, ev) = _dec_layer(lp, x, enc_out, cfg, mode)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        cache["xk"][i] = ek
        cache["xv"][i] = ev
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return cache, logits_apply(params.embed, x, cfg.tie_embeddings)[:, 0]


def decode_step(params, cfg, batch, cache):
    """batch: tokens (B,1), positions (B,) write index.  The position table
    has ``smax`` rows, as the JAX twin's.  Writes the new keys/values into
    ``cache`` in place; returns (logits, cache)."""
    tokens, positions = batch["tokens"], batch["positions"]
    x = embed_apply(params.embed, tokens)
    pe = sinusoidal_positions(cache["k"].shape[2], cfg.d_model, x.device)
    x = x + pe[positions][:, None].to(x.dtype)
    lengths = torch.full((x.shape[0],), cache["xk"].shape[2],
                         dtype=torch.int64, device=x.device)
    for i, lp in enumerate(params.decoder):
        sp = lp["self"]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(sp, h, positions[:, None], cfg.rope_theta,
                                   False, cfg.norm_eps)
        ck, cv = attn.cache_update(cache["k"][i], cache["v"][i], k, v,
                                   positions)
        x = x + _out(attn.attend_decode(q, ck, cv, positions + 1), sp["wo"])
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        o = attn.attend_decode(_heads(h, lp["cross"]["wq"]), cache["xk"][i],
                               cache["xv"][i], lengths)
        x = x + _out(o, lp["cross"]["wo"])
        h = rms_norm(x, lp["ln3"], cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_apply(params.embed, x, cfg.tie_embeddings)[:, 0], cache
