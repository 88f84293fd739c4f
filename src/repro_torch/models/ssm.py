"""State-space blocks: Mamba1 (falcon-mamba).  Mamba2 comes with the hybrid
family (ROADMAP modules item 8).

Prefill and serving (no gradient recorded): the selective scan goes
straight to the ``ssm_scan`` wrapper (the CUDA kernel on the card, its
plain version on the CPU), which never builds the (B, S, d_inner, N) decay
and input tensors that the JAX package's chunked associative scan builds.
Its final state comes out of the same call, for a prefill to hand to
decode.  Training (gradients recorded): the scan goes through
``SSMScan``, the same forward, with the backward of the JAX package's
chunked scan (``ssm_scan_chunked``).  Decode path: O(1) recurrent step
with (conv_state, h) carried in the cache.

The config knobs that change only how the JAX package computes the same
function (``fused_ssm_y``, ``unroll_scans``, ``ssm_chunk``) are ignored
here: the chunk length is ``ops.SCAN_CHUNK``.  ``ssm_scan_dtype`` other
than float32 changes the numbers and is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import SSMScan, ssm_scan
from repro_torch.models.layers import dense_init


def check_scan_dtype(cfg):
    if cfg.ssm_scan_dtype != "float32":
        raise NotImplementedError(
            f"{cfg.name}: ssm_scan_dtype={cfg.ssm_scan_dtype!r} is not ported "
            f"yet (ROADMAP kernel item 4, scan state in bf16); the port's "
            f"scan runs in float32")


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B,S,C), w (K,C), b (C) -> (B,S,C).

    A cross-correlation over the left-padded sequence, as JAX's
    ``conv_general_dilated``: ``w`` (K, C) becomes PyTorch's (C, 1, K)
    without a flip."""
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))                 # (B,C,S+K-1)
    out = F.conv1d(xp, w.t()[:, None, :], b, groups=c)
    return out.transpose(1, 2).contiguous()


def _conv_step(conv_state, x_new, w, b):
    """conv_state (B,K-1,C), x_new (B,C) -> (y (B,C), new_state)."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # (B,K,C)
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return y, window[:, 1:, :]


# ============================================================================
# Mamba1 (falcon-mamba-7b)
# ============================================================================
def mamba1_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, di, st, dtr, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                         cfg.dt_rank, cfg.ssm_conv)
    dev = gen.device
    A = torch.arange(1, st + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype),
        "conv_w": dense_init(gen, (k, di), dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (di, dtr + 2 * st), dtype),
        "dt_proj": dense_init(gen, (dtr, di), dtype),
        "dt_bias": torch.full((di,), -2.0, dtype=dtype, device=dev),
        "A_log": torch.log(A),                                    # f32
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype),
    }


def _mamba1_ssm_inputs(p, x_conv, cfg):
    """The scan's inputs: dt (B,S,di) f32, A (di,N) f32, and Bm, Cm
    (B,S,N), column slices of ``x_db`` in the model dtype.  (The JAX twin
    returns the materialised decay and input instead.)"""
    check_scan_dtype(cfg)
    dtr, st = cfg.dt_rank, cfg.ssm_state
    x_db = torch.einsum("bsc,ce->bse", x_conv, p["x_proj"])
    dt, Bm, Cm = x_db.split([dtr, st, st], dim=-1)
    dt = F.softplus(torch.einsum("bsr,rc->bsc", dt, p["dt_proj"]).float()
                    + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])
    return dt, A, Bm, Cm


def mamba1_apply(p, x, cfg, *, return_state: bool = False):
    """x (B,S,d) -> (B,S,d).  With ``return_state`` also the state after the
    last token, dict(conv (B,K-1,di), h (B,di,N) f32), as a prefill
    hands it to decode (no gradient flows through that call's scan)."""
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    x_in, z = xz.chunk(2, dim=-1)
    x_conv = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt, A, Bm, Cm = _mamba1_ssm_inputs(p, x_conv, cfg)
    if return_state:
        y, h = ssm_scan(dt, A, Bm, Cm, x_conv, return_state=True)
    elif torch.is_grad_enabled():
        y = SSMScan.apply(dt, A, Bm, Cm, x_conv)
    else:
        y = ssm_scan(dt, A, Bm, Cm, x_conv)
    y = y + p["D"] * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = torch.einsum("bsc,cd->bsd", y, p["out_proj"])
    if not return_state:
        return out
    km1 = cfg.ssm_conv - 1
    xp = F.pad(x_in, (0, 0, max(km1 - x_in.shape[1], 0), 0))
    return out, {"conv": xp[:, xp.shape[1] - km1:], "h": h}


def mamba1_decode(p, x, state, cfg):
    """x (B,1,d); state dict(conv (B,K-1,di), h (B,di,N)) -> (y, state).
    Writes the new conv window and h into ``state``'s tensors IN PLACE (the
    JAX twin returns new ones) and returns them."""
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])[:, 0]
    x_in, z = xz.chunk(2, dim=-1)
    xc, conv_state = _conv_step(state["conv"], x_in, p["conv_w"],
                                p["conv_b"])
    x_conv = F.silu(xc)
    dt, A, Bm, Cm = _mamba1_ssm_inputs(p, x_conv[:, None, :], cfg)
    a = torch.exp(dt[:, 0, :, None] * A)
    b = (dt[:, 0] * x_conv.float())[..., None] * Bm[:, 0].float()[:, None, :]
    h = a * state["h"] + b
    y = torch.einsum("bcn,bn->bc", h, Cm[:, 0].float())
    y = y + p["D"] * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = torch.einsum("bc,cd->bd", y, p["out_proj"])[:, None, :]
    state["conv"].copy_(conv_state)
    state["h"].copy_(h)
    return out, state


def mamba1_state_init(batch, cfg, dtype, device=None):
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


# ----------------------------------------------------------------------------
# Sequential-scan oracle (the tests hold the JAX chunked scan against it)
# ----------------------------------------------------------------------------
def reference_scan(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t over axis 1; returns every h_t."""
    hs = torch.empty_like(b)
    h = h0
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs

