"""Oracle: the sequential selective scan in f32 over time (the torch twin
of the JAX package's ``ssm_scan/ref.py``)."""
from __future__ import annotations

import torch


def ssm_scan_ref(dt, A, Bm, Cm, x, *, return_state: bool = False):
    """dt, x (B,S,D); A (D,N); Bm, Cm (B,S,N) -> y (B,S,D) f32, and with
    ``return_state`` also the state after the last step, (B,D,N) f32.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,  y_t = <h_t, C_t>.
    """
    dt, x, Bm, Cm, A = (t.float() for t in (dt, x, Bm, Cm, A))
    b, s, d = dt.shape
    h = torch.zeros((b, d, A.shape[1]), dtype=torch.float32, device=dt.device)
    ys = torch.empty((b, s, d), dtype=torch.float32, device=dt.device)
    for t in range(s):
        decay = torch.exp(dt[:, t, :, None] * A)                 # (B,D,N)
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys[:, t] = (h * Cm[:, t, None, :]).sum(-1)
    return (ys, h) if return_state else ys
