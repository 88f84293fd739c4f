"""Oracle: the sequential selective scan over time (the torch twin of the
JAX package's ``ssm_scan/ref.py``), with its state in f32 or in bf16."""
from __future__ import annotations

import torch


def ssm_scan_ref(dt, A, Bm, Cm, x, *, return_state: bool = False,
                 state_dtype: torch.dtype = torch.float32):
    """dt, x (B,S,D); A (D,N); Bm, Cm (B,S,N) -> y (B,S,D) f32, and with
    ``return_state`` also the state after the last step, (B,D,N) f32.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,  y_t = <h_t, C_t>.

    With ``state_dtype`` bfloat16 the decay and the input are computed in
    f32 and rounded to bf16, the state is bf16 (rounded after the product
    and again after the sum, as bf16 ``a * h + b`` rounds op by op), C is
    rounded to bf16 and y is summed in f32: the roundings of the JAX
    package's ``ssm_scan_dtype="bfloat16"``.  The state returned is then
    that bf16 state, held in f32.
    """
    dt, x, Bm, Cm, A = (t.float() for t in (dt, x, Bm, Cm, A))
    bf16 = state_dtype == torch.bfloat16
    if bf16:
        Cm = Cm.bfloat16().float()
    b, s, d = dt.shape
    h = torch.zeros((b, d, A.shape[1]), dtype=state_dtype, device=dt.device)
    ys = torch.empty((b, s, d), dtype=torch.float32, device=dt.device)
    for t in range(s):
        decay = torch.exp(dt[:, t, :, None] * A)                 # (B,D,N)
        inp = (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        if bf16:
            decay, inp = decay.bfloat16(), inp.bfloat16()
        h = decay * h + inp
        ys[:, t] = (h.float() * Cm[:, t, None, :]).sum(-1)
    return (ys, h.float()) if return_state else ys
