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

Inside a model group that splits the heads over ``model``
(``attention.over_heads``), each attention (the encoder's, the decoder's
self- and cross-attention) runs once a model rank on its heads and each
MLP on its ff columns; the self cache ``k``/``v`` and the cross cache
``xk``/``xv`` are held one block a rank where their specs split the heads.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.attention import AttnMode
from repro_torch.models.layers import (cross_entropy_loss, dense, each,
                                       embed_apply, embed_init, frozen,
                                       layer_stack,
                                       logits_apply, meta_groups, mlp_apply,
                                       mlp_init, rms_norm, rope_sincos,
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

    def share(s):
        a = s.p
        o = attn.attend(_heads(h, a["wq"]), _heads(h, a["wk"]),
                        _heads(h, a["wv"]), causal=False, mode=mode)
        return _out(o, a["wo"]), None
    x = x + attn.over_heads(lp["attn"], share)[0]
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h)


def encode(params, cfg, frames, mode: AttnMode = AttnMode()):
    """frames (B,F,d) -> the encoder's output (B,F,d) in the model dtype."""
    x = _posenc(frames.to(torch_dtype(cfg.dtype)))
    x = layer_stack(_enc_layer, params.encoder, x, cfg, mode)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def _cross_kv(c, enc_out):
    return _heads(enc_out, c["wk"]), _heads(enc_out, c["wv"])


def _dec_layer(lp, x, enc_out, cfg, mode):
    """One decoder layer over a whole sequence (forward and prefill):
    returns x and each head share's self (k, v) and cross (k, v)
    (``attention.over_heads``)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    b, s, _ = h.shape
    pos = torch.arange(s, device=h.device)[None, :].expand(b, s)
    rope = rope_sincos(pos, cfg.head_dim, cfg.rope_theta)

    def self_share(sh):
        q, k, v = attn.qkv_project(sh.p, h, pos, cfg.rope_theta, False,
                                   cfg.norm_eps, rope)
        o = attn.attend(q, k, v, causal=True, mode=mode)
        return _out(o, sh.p["wo"]), (k, v)
    out, kvs = attn.over_heads(lp["self"], self_share)
    x = x + out
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)

    def cross_share(sh):
        ek, ev = _cross_kv(sh.p, enc_out)
        o = attn.attend(_heads(h, sh.p["wq"]), ek, ev, causal=False,
                        mode=mode)
        return _out(o, sh.p["wo"]), (ek, ev)
    out, xkvs = attn.over_heads(lp["cross"], cross_share)
    x = x + out
    h = rms_norm(x, lp["ln3"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h), kvs, xkvs


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
    return cross_entropy_loss(each(lambda z: z[:, :-1], logits),
                              batch["labels"][:, 1:],
                              None if mask is None else mask[:, 1:])


def cache_init(cfg, batch_size: int, smax: int, dtype=None, device=None,
               params=None):
    """Zero caches; with ``params`` (a pass's lead slice) ``k``/``v`` and
    ``xk``/``xv`` held one block a model rank where the self and cross
    ``wk`` are split (``attention.kv_zeros``)."""
    dtype = torch_dtype(dtype or cfg.dtype)
    L = cfg.n_layers
    self_shape = (L, batch_size, smax, cfg.n_kv_heads, cfg.head_dim)
    cross_shape = (L, batch_size, cfg.n_encoder_frames, cfg.n_heads,
                   cfg.head_dim)
    wk, xwk = (None, None) if params is None else (
        params.decoder[0]["self"]["wk"], params.decoder[0]["cross"]["wk"])
    return {"k": attn.kv_zeros(self_shape, dtype, device, wk),
            "v": attn.kv_zeros(self_shape, dtype, device, wk),
            "xk": attn.kv_zeros(cross_shape, dtype, device, xwk),
            "xv": attn.kv_zeros(cross_shape, dtype, device, xwk)}


def prefill(params, cfg, batch, smax: int, mode: AttnMode = AttnMode()):
    """Encode the frames, run the decoder over the prompt; returns (cache,
    last-token logits)."""
    enc_out = encode(params, cfg, batch["frames"], mode)
    x = _posenc(embed_apply(params.embed, batch["tokens"]))
    b, s, _ = x.shape
    cache = cache_init(cfg, b, smax, device=x.device, params=params)
    for i, lp in enumerate(params.decoder):
        x, kvs, xkvs = _dec_layer(lp, x, enc_out, cfg, mode)
        attn.store_kv((cache["k"], cache["v"]), (i, slice(None),
                                                  slice(None, s)), kvs)
        attn.store_kv((cache["xk"], cache["xv"]), (i,), xkvs)
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return cache, each(lambda z: z[:, 0], logits_apply(
        params.embed, x, cfg.tie_embeddings))


def decode_step(params, cfg, batch, cache):
    """batch: tokens (B,1), positions (B,) write index.  The position table
    has ``smax`` rows, as the JAX twin's.  Writes the new keys/values into
    ``cache`` in place; returns (logits, cache)."""
    tokens, positions = batch["tokens"], batch["positions"]
    x = embed_apply(params.embed, tokens)
    k0, xk0 = (c[0] if isinstance(c, list) else c
               for c in (cache["k"], cache["xk"]))
    pe = sinusoidal_positions(k0.shape[2], cfg.d_model, x.device)
    x = x + pe[positions][:, None].to(x.dtype)
    lengths = torch.full((x.shape[0],), xk0.shape[2],
                         dtype=torch.int64, device=x.device)
    rope = rope_sincos(positions[:, None], cfg.head_dim, cfg.rope_theta)
    for i, lp in enumerate(params.decoder):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)

        def self_share(s):
            q, k, v = attn.qkv_project(s.p, h, positions[:, None],
                                       cfg.rope_theta, False, cfg.norm_eps,
                                       rope)
            ck, cv = attn.cache_update(s.of(cache["k"])[i],
                                       s.of(cache["v"])[i], k, v, positions)
            return _out(attn.attend_decode(q, ck, cv, positions + 1),
                        s.p["wo"]), None
        x = x + attn.over_heads(lp["self"], self_share)[0]
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)

        def cross_share(s):
            o = attn.attend_decode(_heads(h, s.p["wq"]), s.of(cache["xk"])[i],
                                   s.of(cache["xv"])[i], lengths)
            return _out(o, s.p["wo"]), None
        x = x + attn.over_heads(lp["cross"], cross_share)[0]
        h = rms_norm(x, lp["ln3"], cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return each(lambda z: z[:, 0], logits_apply(
        params.embed, x, cfg.tie_embeddings)), cache
