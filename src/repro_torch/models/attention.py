"""Attention: GQA with RoPE (or none: ``qkv_project(rotary=False)``) and
optional qk-norm.

Three execution paths, mathematically identical:
  * ``attend_full``      — naive softmax attention (small seq / oracle)
  * ``attend_blockwise`` — flash-style online softmax over KV blocks in plain
                           PyTorch (the JAX package's prefill default)
  * kernels/flash_attention — the CUDA kernel, which ``attend`` launches for
                           every prefill and forward on a CUDA tensor

On a CUDA tensor ``attend`` goes through the kernel's autograd Function
(``FlashAttention``): forward through the kernel, backward through autograd
of the plain path below.  On any other device it takes that plain path:
the JAX package's dispatch (full up to ``q_block`` rows, blockwise beyond),
so the CPU tests compare like with like; ``cache_batch_axes`` probes on the
``meta`` device through the same path.

The decode path attends one new token against a padded KV cache with
per-batch lengths, in plain PyTorch (the JAX package computes it outside any
Pallas kernel too): ``attend_decode`` over the JAX layout (B, Smax, K, hd),
``attend_decode_heads`` over the port-own Jamba family's (B, K, Smax, hd).

Inside a model group that splits ``wq``'s heads over ``model``
(``distributed/context.py``), :func:`over_heads` runs an attention
layer once a model rank on its :class:`HeadShare`: rank m's q heads
``[m H/m', (m+1) H/m')`` and ``wo`` rows, and the kv heads those q heads
read under GQA's grouping: its own block of ``wk``/``wv`` where their spec
splits K, else those heads sliced from the replicated weights.  The
partial outputs are summed.  A cache leaf whose spec splits K is held one
block a rank (a list, :func:`kv_zeros`); any other is whole, and each
rank reads and writes its kv heads in it (:meth:`HeadShare.of`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch

from repro_torch.distributed.context import (is_split, model_size,
                                             model_sum, over_model, twins)
from repro_torch.kernels.flash_attention.ops import FlashAttention
from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                       rms_norm, rope_sincos)

NEG_INF = -1e30


def attn_init(gen, d_model, n_heads, n_kv_heads, head_dim, qk_norm, dtype):
    p = {"wq": dense_init(gen, (d_model, n_heads, head_dim), dtype),
         "wk": dense_init(gen, (d_model, n_kv_heads, head_dim), dtype),
         "wv": dense_init(gen, (d_model, n_kv_heads, head_dim), dtype),
         "wo": dense_init(gen, (n_heads, head_dim, d_model), dtype)}
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype, device=gen.device)
    return p


def qkv_project(p, x, positions, theta, qk_norm, norm_eps, rope=None, *,
                rotary: bool = True):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,K,hd) with RoPE applied.
    ``rope``: the (sin, cos) tables of ``positions``
    (``layers.rope_sincos``), where the caller built them once for all of
    a layer's head shares.  ``rotary=False`` leaves q and k unrotated (a
    model without positional encoding, Jamba's attention layers);
    ``positions`` and ``theta`` are then unused."""
    q = dense(x, p["wq"])
    k = dense(x, p["wk"])
    v = dense(x, p["wv"])
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    if not rotary:
        return q, k, v
    sin, cos = rope_sincos(positions, q.shape[-1], theta) if rope is None \
        else rope
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _group(q, n_kv):
    """(B,S,H,hd) -> (B,S,K,G,hd)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def attend_full(q, k, v, *, causal=True, kv_valid=None):
    """Naive attention. q (B,Sq,H,hd), k/v (B,Sk,K,hd)."""
    n_kv = k.shape[2]
    qg = _group(q, n_kv)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    sq, sk = q.shape[1], k.shape[1]
    if causal:
        # query i may attend key j iff j <= i + (Sk - Sq)  (aligned suffixes)
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kj = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(kj > qi, NEG_INF)
    if kv_valid is not None:  # (B, Sk) bool
        scores = scores.masked_fill(~kv_valid[:, None, None, None, :],
                                    NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(q.shape)


def _pick_block(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    b = min(n, target)
    while n % b:
        b -= 1
    return b


def attend_blockwise(q, k, v, *, causal=True, q_block=512, kv_block=512):
    """Flash-style online-softmax attention in plain PyTorch: a loop over
    KV blocks per query block carrying (m, l, acc) in f32.  KV blocks wholly
    above the causal diagonal are skipped; their weights are exactly 0, so
    the result is that of the full masked sweep."""
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    q_block = _pick_block(sq, q_block)
    kv_block = _pick_block(sk, kv_block)
    tq, tk = sq // q_block, sk // kv_block
    scale = hd ** -0.5
    qg = _group(q, n_kv).reshape(b, tq, q_block, n_kv, g, hd)
    kb = k.reshape(b, tk, kv_block, n_kv, hd)
    vb = v.reshape(b, tk, kv_block, n_kv, hd)
    offset = sk - sq  # suffix alignment for causal masking
    dev = q.device
    outs = []
    for i in range(tq):
        qi = qg[:, i]
        m = torch.full((b, n_kv, g, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, n_kv, g, q_block), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((b, n_kv, g, q_block, hd), dtype=torch.float32,
                          device=dev)
        rows = i * q_block + torch.arange(q_block, device=dev)[:, None] \
            + offset
        for j in range(tk):
            if causal and j * kv_block > i * q_block + q_block - 1 + offset:
                break
            s = torch.einsum("bqkgd,btkd->bkgqt", qi,
                             kb[:, j]).float() * scale
            if causal:
                cols = j * kv_block + torch.arange(kv_block,
                                                   device=dev)[None, :]
                s = s.masked_fill(cols > rows, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            vj = vb[:, j]
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(vj.dtype), vj).float()
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        # (b,k,g,q,d) -> (b,q,k,g,d) -> (b,q,h,d)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_block, h, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def attend_decode(q, k_cache, v_cache, lengths):
    """q (B,1,H,hd) new-token queries vs padded cache (B,Smax,K,hd).
    lengths (B,) = number of valid cache entries (including the new token)."""
    n_kv = k_cache.shape[2]
    b, _, h, hd = q.shape
    qg = q.reshape(b, n_kv, h // n_kv, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache).float() * scale
    valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] \
        < lengths[:, None]                                      # (B,Smax)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", w, v_cache)
    return out.reshape(b, 1, h, hd)


def attend_decode_heads(q, k_cache, v_cache, lengths):
    """:func:`attend_decode` over caches laid out (B, K, Smax, hd), each
    kv head's keys of a sequence contiguous: the batched products take the
    (sequence, kv head) blocks as they lie, where the (B, Smax, K, hd)
    layout has them copied whole a step first."""
    b, _, h, hd = q.shape
    n_kv = k_cache.shape[1]
    qg = q.reshape(b, n_kv, h // n_kv, hd)
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k_cache).float() \
        * hd ** -0.5
    valid = torch.arange(k_cache.shape[2], device=q.device)[None, :] \
        < lengths[:, None]                                      # (B,Smax)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgt,bktd->bkgd", w, v_cache)
    return out.reshape(b, 1, h, hd)


def cache_update_heads(k_cache, v_cache, k_new, v_new, positions):
    """:func:`cache_update` into caches laid out (B, K, Smax, hd)."""
    bidx = torch.arange(k_new.shape[0], device=k_cache.device)
    pos = positions.long()
    k_cache[bidx, :, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, :, pos] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def cache_update(k_cache, v_cache, k_new, v_new, positions):
    """Write one token per sequence at ``positions`` (B,), IN PLACE: only
    row ``(b, positions[b])`` of each sequence changes.  Returns the caches
    (the JAX twin returns updated copies)."""
    bidx = torch.arange(k_new.shape[0], device=k_cache.device)
    pos = positions.long()
    k_cache[bidx, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, pos] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


@dataclasses.dataclass(frozen=True)
class AttnMode:
    """How the attention core executes off the card, and which plain path
    the kernel's backward differentiates on it (on the card every prefill
    and forward goes through the kernel)."""
    kind: str = "blockwise"   # full | blockwise
    q_block: int = 512
    kv_block: int = 512


def attend(q, k, v, *, causal, mode: AttnMode):
    plain = functools.partial(attend_plain, mode=mode)
    if q.is_cuda:
        return FlashAttention.apply(q, k, v, causal, plain)
    return plain(q, k, v, causal=causal)


def attend_plain(q, k, v, *, causal, mode: AttnMode):
    """The JAX package's ``attend``: full attention up to ``q_block`` query
    rows, blockwise beyond."""
    if mode.kind == "full" or q.shape[1] <= mode.q_block:
        return attend_full(q, k, v, causal=causal)
    return attend_blockwise(q, k, v, causal=causal, q_block=mode.q_block,
                            kv_block=mode.kv_block)


# ----------------------------------------------------------------------------
# heads split over the model ranks
# ----------------------------------------------------------------------------
class HeadShare(NamedTuple):
    """One model rank's share of an attention layer: ``p`` its projections
    (``wq``/``wo`` of its q heads, ``wk``/``wv`` of the kv heads they read,
    the norms), its rank ``m`` and ``kv``, the slice of the whole cache's
    kv heads it reads (None: the layer is not split, all of them)."""
    p: Any
    m: int
    kv: slice | None

    def of(self, cache):
        """The rank's part of a cache leaf: its own block where the cache
        is held one block a rank, else a view of its kv heads."""
        if isinstance(cache, list):
            return cache[self.m]
        return cache if self.kv is None else cache[..., self.kv, :]


def head_shares(p) -> list:
    """Each model rank's :class:`HeadShare` of the layer ``p`` (the lead's
    group); one share of the whole layer where ``wq``'s spec does not
    split its heads."""
    if not is_split(p["wq"]):
        return [HeadShare(p, 0, None)]
    groups = twins(p)
    own = is_split(p["wk"])
    shares = []
    for m, q in enumerate(groups):
        h = q["wq"].shape[-2]
        if own:
            k = q["wk"].shape[-2]
            shares.append(HeadShare(q, m, slice(m * k, (m + 1) * k)))
            continue
        g = h * len(groups) // q["wk"].shape[-2]     # q heads a kv head
        if h % g and g % h:
            raise NotImplementedError(
                f"{h} q heads a rank over kv groups of {g}: a rank's heads "
                f"would read parts of several groups")
        lo = m * h // g
        kv = slice(lo, lo + max(h // g, 1))
        shares.append(HeadShare({**dict(q.items()), "wk": q["wk"][:, kv],
                                 "wv": q["wv"][:, kv]}, m, kv))
    return shares


def over_heads(p, fn) -> tuple:
    """``fn(share) -> (partial output, extra)`` on each rank's share of the
    layer ``p``: (the partial outputs summed, [(share, extra)] of each
    rank computed)."""
    shares = head_shares(p)
    if len(shares) == 1:
        out, extra = fn(shares[0])
        return out, [(shares[0], extra)]
    res = over_model(lambda m, s: fn(s), shares)
    return (model_sum([r and r[0] for r in res]),
            [(s, r[1]) for s, r in zip(shares, res) if r is not None])


def store_kv(cache: tuple, idx: tuple, kvs: list):
    """Write each share's keys and values (``over_heads``' extras) at
    ``idx`` of the ``(k, v)`` cache leaves: into its own block, or into its
    kv heads of the whole leaf."""
    for share, new in kvs:
        for c, t in zip(cache, new):
            share.of(c)[idx] = t


def kv_zeros(shape, dtype, device, wk=None):
    """A zero cache leaf of ``shape`` (..., K, hd): one block of K a model
    rank (a list; None for a rank a dry run does not compute) where the
    lead's ``wk`` is split over ``model``, else whole."""
    if wk is None or not is_split(wk):
        return torch.zeros(shape, dtype=dtype, device=device)
    n = model_size()
    block = tuple(shape[:-2]) + (shape[-2] // n, shape[-1])
    return over_model(lambda m, _: torch.zeros(block, dtype=dtype,
                                               device=device), range(n))
