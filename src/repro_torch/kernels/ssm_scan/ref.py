"""Oracle: the sequential selective scan over time (the torch twin of the
JAX package's ``ssm_scan/ref.py``), with its state in f32, bf16 or f16."""
from __future__ import annotations

import torch


def mul_add(a, h, b):
    """``a * h + b`` with the roundings the JAX package's arithmetic has in
    the dtype of ``h``: in float16 one rounding (XLA's CPU backend computes
    an f16 fusion in f32 and rounds what it stores; an f16 product is exact
    in f32, so only the sum is rounded, to f32 and then to f16), in any
    other dtype one rounding an operation."""
    if h.dtype != torch.float16:
        return a * h + b
    return (a.float() * h.float() + b.float()).half()


def ssm_scan_ref(dt, A, Bm, Cm, x, *, return_state: bool = False,
                 state_dtype: torch.dtype = torch.float32):
    """dt, x (B,S,D); A (D,N); Bm, Cm (B,S,N) -> y (B,S,D) f32, and with
    ``return_state`` also the state after the last step, (B,D,N) f32.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,  y_t = <h_t, C_t>.

    With ``state_dtype`` bfloat16 or float16 the decay and the input are
    computed in f32 and rounded to it, the state is carried in it, C is
    rounded to it and y is summed in f32: the roundings of the JAX
    package's ``ssm_scan_dtype``.  The state's update rounds as
    :func:`mul_add` does: in bf16 after the product and again after the
    sum, in f16 once.  The state returned is then that state, held in f32.
    """
    dt, x, Bm, Cm, A = (t.float() for t in (dt, x, Bm, Cm, A))
    low = state_dtype != torch.float32
    if low:
        Cm = Cm.to(state_dtype).float()
    b, s, d = dt.shape
    h = torch.zeros((b, d, A.shape[1]), dtype=state_dtype, device=dt.device)
    ys = torch.empty((b, s, d), dtype=torch.float32, device=dt.device)
    for t in range(s):
        decay = torch.exp(dt[:, t, :, None] * A)                 # (B,D,N)
        inp = (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        if low:
            decay, inp = decay.to(state_dtype), inp.to(state_dtype)
        h = mul_add(decay, h, inp)
        ys[:, t] = (h.float() * Cm[:, t, None, :]).sum(-1)
    return (ys, h.float()) if return_state else ys
