"""Oracle: naive softmax attention (the torch twin of the JAX package's
``flash_attention/ref.py``)."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True):
    """q (B,H,Sq,hd); k/v (B,K,Sk,hd), H = K*group.  Scores are formed in
    the inputs' dtype and then taken to f32, as the JAX einsum does."""
    sq, hd = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (hd ** -0.5)
    if causal:
        sk = k.shape[2]
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v).to(q.dtype)
