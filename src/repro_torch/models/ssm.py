"""State-space blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2's blocks,
``models/hybrid.py``).

Prefill and serving (no gradient recorded): the selective scan goes
straight to the ``ssm_scan`` wrapper (the CUDA kernel on the card, its
plain version on the CPU), which never builds the (B, S, d_inner, N) decay
and input tensors that the JAX package's chunked associative scan builds.
Its final state comes out of the same call, for a prefill to hand to
decode.  Training (gradients recorded): the scan goes through
``SSMScan``, the same forward, with the backward of the JAX package's
chunked scan (``ssm_scan_chunked``).  Decode path: O(1) recurrent step
with (conv_state, h) carried in the cache.

Mamba2 is the same recurrence over D = n_heads * head_dim channels with a
decay per head: a head's dt and A = -exp(A_log) repeated over its
head_dim channels (``_mamba2_channels``), so it goes through the same
wrapper and kernel (N 64 at zamba2: the ``ssm_scan64`` build).  The JAX
twin materialises (B, S, n_heads, head_dim, N) instead.

The config knobs that change only how the JAX package computes the same
function (``fused_ssm_y``, ``unroll_scans``) are ignored here.
``ssm_scan_dtype`` is honoured (``scan_mode``): at "bfloat16" or
"float16" the scan carries its state in that dtype (the kernel's mode of
it, and the same roundings in the plain version and in the training
backward), and only then is ``ssm_chunk`` read: the backward's chunked
scan takes the JAX package's chunk, because where the chunks end decides
where such a state is rounded.  An f32 state's backward takes
``ops.SCAN_CHUNK``.  "float64" is the f32 mode: the JAX package never
enables x64, so ``astype(float64)`` gives it f32 arrays.  As in the JAX
package, a prefill with a bf16 or f16 state computes its output from that
scan and hands decode the f32 state of the unrounded inputs (a second
launch, in f32), and decode runs in f32.  Any other name raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan.ops import SCAN_CHUNK, SSMScan, ssm_scan
from repro_torch.models.layers import dense, dense_init, rms_norm

# cfg.ssm_scan_dtype -> the dtype the scan carries its state in; float64
# as the JAX package computes it, without x64: in f32
SCAN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16, "float64": torch.float32}


def check_scan_dtype(cfg):
    if cfg.ssm_scan_dtype not in SCAN_DTYPES:
        raise NotImplementedError(
            f"{cfg.name}: ssm_scan_dtype={cfg.ssm_scan_dtype!r} is not "
            f"ported; no config of the JAX package sets it, and the port's "
            f"scan carries its state in one of {sorted(SCAN_DTYPES)}")


def scan_mode(cfg) -> tuple:
    """(state dtype, chunk of the training backward's chunked scan) for
    ``cfg.ssm_scan_dtype``: bf16 or f16 with ``cfg.ssm_chunk``, or f32
    with ``ops.SCAN_CHUNK``."""
    check_scan_dtype(cfg)
    sdt = SCAN_DTYPES[cfg.ssm_scan_dtype]
    return sdt, SCAN_CHUNK if sdt == torch.float32 else cfg.ssm_chunk


def _scan(cfg, dt, A, Bm, Cm, x, return_state: bool):
    """The selective scan of a Mamba layer's forward in ``cfg``'s mode: the
    wrapper, or ``SSMScan`` where gradients are recorded.  With
    ``return_state`` (a prefill, no gradient) also the final state in
    f32: under a bf16 or f16 state that of a second, f32 launch on the
    same unrounded inputs, as the JAX prefill's second pass computes it."""
    sdt, chunk = scan_mode(cfg)
    if return_state:
        if sdt == torch.float32:
            return ssm_scan(dt, A, Bm, Cm, x, return_state=True)
        y = ssm_scan(dt, A, Bm, Cm, x, state_dtype=sdt)
        return y, ssm_scan(dt, A, Bm, Cm, x, return_state=True)[1]
    if torch.is_grad_enabled():
        return SSMScan.apply(dt, A, Bm, Cm, x, sdt, chunk)
    return ssm_scan(dt, A, Bm, Cm, x, state_dtype=sdt)


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
    x_db = dense(x_conv, p["x_proj"])
    dt, Bm, Cm = x_db.split([dtr, st, st], dim=-1)
    dt = F.softplus(dense(dt, p["dt_proj"]).float()
                    + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])
    return dt, A, Bm, Cm


def mamba1_apply(p, x, cfg, *, return_state: bool = False):
    """x (B,S,d) -> (B,S,d).  With ``return_state`` also the state after the
    last token, dict(conv (B,K-1,di), h (B,di,N) f32), as a prefill
    hands it to decode (no gradient flows through that call's scan)."""
    xz = dense(x, p["in_proj"])
    x_in, z = xz.chunk(2, dim=-1)
    x_conv = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    dt, A, Bm, Cm = _mamba1_ssm_inputs(p, x_conv, cfg)
    y = _scan(cfg, dt, A, Bm, Cm, x_conv, return_state)
    if return_state:
        y, h = y
    y = y + p["D"] * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = dense(y, p["out_proj"])
    if not return_state:
        return out
    km1 = cfg.ssm_conv - 1
    xp = F.pad(x_in, (0, 0, max(km1 - x_in.shape[1], 0), 0))
    return out, {"conv": xp[:, xp.shape[1] - km1:], "h": h}


def mamba1_decode(p, x, state, cfg):
    """x (B,1,d); state dict(conv (B,K-1,di), h (B,di,N)) -> (y, state).
    Writes the new conv window and h into ``state``'s tensors IN PLACE (the
    JAX twin returns new ones) and returns them."""
    xz = dense(x, p["in_proj"])[:, 0]
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
    out = dense(y, p["out_proj"])[:, None, :]
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


# ============================================================================
# Mamba2 (zamba2-7b)
# ============================================================================
def mamba2_init(gen: torch.Generator, cfg, dtype) -> dict:
    d, di, st, nh, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.ssm_heads, cfg.ssm_conv)
    dev = gen.device
    conv_ch = di + 2 * st
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * st + nh), dtype),
        "conv_w": dense_init(gen, (k, conv_ch), dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((nh,), -2.0, dtype=torch.float32, device=dev),
        "norm_w": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype),
    }


def _mamba2_split(p, x, cfg):
    di, st = cfg.d_inner, cfg.ssm_state
    zxbcdt = dense(x, p["in_proj"])
    return zxbcdt.split([di, di + 2 * st, cfg.ssm_heads], dim=-1)


def _mamba2_ssm(p, xbc_conv, dt, cfg):
    """The scan's inputs per head: dt (B,S,nh) f32 after its softplus, A
    (nh,) f32, and x (B,S,D), Bm, Cm (B,S,N), column slices of
    ``xbc_conv`` in the model dtype.  (The JAX twin returns the
    materialised decay and input instead.)"""
    check_scan_dtype(cfg)
    di, st = cfg.d_inner, cfg.ssm_state
    xh, Bm, Cm = xbc_conv.split([di, st, st], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    return dt, -torch.exp(p["A_log"]), xh, Bm, Cm


def _mamba2_channels(dt, A, cfg):
    """Each head's dt (B,S,nh) and A (nh,) repeated over its head_dim
    channels: dt (B,S,D) and A (D,N), f32 and contiguous, as the scan
    takes them."""
    hd = cfg.ssm_head_dim
    return (dt.repeat_interleave(hd, dim=-1),
            A.repeat_interleave(hd)[:, None].expand(-1, cfg.ssm_state)
            .contiguous())


def _mamba2_out(p, y, xh, z, x, cfg):
    """D skip, gate, the gated RMS norm and out_proj after the scan."""
    y = y + p["D"].repeat_interleave(cfg.ssm_head_dim) * xh.float()
    y = rms_norm(y * F.silu(z.float()), p["norm_w"], cfg.norm_eps)
    return dense(y.to(x.dtype), p["out_proj"])


def mamba2_apply(p, x, cfg, *, return_state: bool = False):
    """x (B,S,d) -> (B,S,d).  With ``return_state`` also the state after the
    last token, dict(conv (B,K-1,d_inner+2N), h (B,nh,head_dim,N) f32), as
    a prefill hands it to decode: the scan's own final state (the JAX
    prefill scans a second time for it; so does this one under a bf16 or
    f16 state, ``_scan``)."""
    b = x.shape[0]
    z, xbc, dt = _mamba2_split(p, x, cfg)
    xbc_conv = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    dt, A, xh, Bm, Cm = _mamba2_ssm(p, xbc_conv, dt, cfg)
    dt, A = _mamba2_channels(dt, A, cfg)
    y = _scan(cfg, dt, A, Bm, Cm, xh, return_state)
    if return_state:
        y, h = y
    out = _mamba2_out(p, y, xh, z, x, cfg)
    if not return_state:
        return out
    km1 = cfg.ssm_conv - 1
    xp = F.pad(xbc, (0, 0, max(km1 - xbc.shape[1], 0), 0))
    return out, {"conv": xp[:, xp.shape[1] - km1:],
                 "h": h.view(b, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state)}


def mamba2_decode(p, x, state, cfg):
    """x (B,1,d); state dict(conv (B,K-1,d_inner+2N), h (B,nh,head_dim,N))
    -> (y, state).  Writes the new conv window and h into ``state``'s
    tensors IN PLACE (the JAX twin returns new ones) and returns them."""
    b = x.shape[0]
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _mamba2_split(p, x, cfg)
    xc, conv_state = _conv_step(state["conv"], xbc[:, 0], p["conv_w"],
                                p["conv_b"])
    dt, A, xh, Bm, Cm = _mamba2_ssm(p, F.silu(xc)[:, None, :], dt, cfg)
    a = torch.exp(dt[:, 0] * A)                                   # (B,nh)
    xheads = xh[:, 0].float().view(b, nh, hd)
    bx = (dt[:, 0, :, None] * xheads)[..., None] \
        * Bm[:, 0].float()[:, None, None, :]
    h = a[..., None, None] * state["h"] + bx
    y = torch.einsum("bhdn,bn->bhd", h, Cm[:, 0].float()).reshape(b, 1, -1)
    out = _mamba2_out(p, y, xh, z, x, cfg)
    state["conv"].copy_(conv_state)
    state["h"].copy_(h)
    return out, state


def mamba2_state_init(batch, cfg, dtype, device=None):
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                             cfg.d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32,
                         device=device),
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

