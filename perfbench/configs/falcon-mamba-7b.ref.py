"""Plain reference of falcon-mamba-7b as the port runs it: its weights, made
from the seed, and its forward pass in float32.

Imports nothing of the program.  The forward follows the port's Mamba1
block (``configs/falcon-mamba-7b.json`` says under ``assumed`` where that
block departs from the published one): per layer, an RMS norm, ``in_proj`` to x and z, a causal
depthwise conv of width 4 and SiLU, ``x_proj`` to dt, B and C, ``dt_proj``
and softplus with the dt bias, the selective scan

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,   y_t = C_t . h_t,
    A = -exp(A_log),

then ``y + D x``, the gate ``silu(z)``, ``out_proj`` and the residual; a
final RMS norm and the head (the embedding's transpose where tied).

Everything is computed in float32 with TF32 off, from the bfloat16 weights
upcast one layer at a time.  The sequences' tokens are packed for the
products, the conv masks each sequence's start, and the scan runs step by
step over the batch of sequences, longest first, so each step touches only
the sequences that are that long.  ``quant="fp8"`` is the control: every
product's operands rounded to float8 e4m3 (activations by a scale a row,
weights by a scale an output column) and multiplied in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LAYER_KEYS = ("ln", "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
              "dt_bias", "A_log", "D", "out_proj")
SCAN_BLOCK = 64          # steps whose decays are computed at once
E4M3_MAX = 448.0


def sizes(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "di": cfg["intermediate_size"],
            "n": cfg["state_size"], "r": cfg["time_step_rank"],
            "k": cfg["conv_kernel"], "layers": cfg["num_hidden_layers"],
            "vocab": cfg["vocab_size"]}


def make_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The model's weights from ``seed``, on ``device``, in a few large
    calls: each kind of layer weight for all layers at once.  ``layers``
    maps each name to an (L, ...) tensor."""
    z = sizes(cfg)
    d, di, n, r, k, L = z["d"], z["di"], z["n"], z["r"], z["k"], z["layers"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape, fan_in):
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return t.mul_(1.0 / math.sqrt(fan_in))

    a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
    # the time-step initialisation: dt log-uniform in [min, max], floored,
    # and the bias its inverse softplus, so the channels' memories range
    # from a few steps to thousands
    lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
    dt = torch.exp(lo + (hi - lo) * torch.rand(
        (L, di), generator=gen, dtype=torch.float32, device=device))
    dt = dt.clamp_min(cfg["time_step_floor"])
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    layers = {
        "ln": torch.ones((L, d), dtype=dtype, device=device),
        "in_proj": normal((L, d, 2 * di), d),
        "conv_w": normal((L, k, di), k),
        "conv_b": torch.zeros((L, di), dtype=dtype, device=device),
        "x_proj": normal((L, di, r + 2 * n), di),
        "dt_proj": normal((L, r, di), r),
        "dt_bias": dt_bias.to(dtype),
        "A_log": a.expand(L, di, n).contiguous(),
        "D": torch.ones((L, di), dtype=torch.float32, device=device),
        "out_proj": normal((L, di, d), di),
    }
    emb = torch.randn((z["vocab"], d), generator=gen, dtype=dtype,
                      device=device).mul_(cfg["initializer_range"])
    w = {"embedding": emb,
         "final_norm": torch.ones((d,), dtype=dtype, device=device),
         "layers": layers}
    if not cfg["tie_word_embeddings"]:
        w["lm_head"] = normal((d, z["vocab"]), d)
    return w


# ---------------------------------------------------------------------------
def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _fp8(x, dim):
    """Round to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(x, w, quant):
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _conv(x, w, b, pos):
    """Causal depthwise conv over packed sequences: ``pos`` is each token's
    position inside its own sequence, so no tap reaches the previous
    sequence."""
    k = w.shape[0]
    out = x * w[k - 1] + b
    for j in range(1, k):
        shifted = torch.zeros_like(x)
        shifted[j:] = x[:-j]
        shifted[pos < j] = 0
        out = out + shifted * w[k - 1 - j]
    return out


def _scan(dt, dtx, Bm, Cm, A, lengths):
    """The selective scan over (B, T, ...) batches of sequences sorted
    longest first; returns y (B, T, D)."""
    b, t, di = dt.shape
    y = torch.zeros((b, t, di), dtype=torch.float32, device=dt.device)
    h = torch.zeros((b, di, A.shape[1]), dtype=torch.float32,
                    device=dt.device)
    active = [int((lengths > s).sum()) for s in range(t)]
    for s0 in range(0, t, SCAN_BLOCK):
        s1 = min(s0 + SCAN_BLOCK, t)
        m = active[s0]
        a = torch.exp(dt[:m, s0:s1, :, None] * A)            # (m, S, D, N)
        u = dtx[:m, s0:s1, :, None] * Bm[:m, s0:s1, None, :]
        hs = torch.empty_like(a)
        for j in range(s1 - s0):
            mj = active[s0 + j]
            prev = h[:mj] if j == 0 else hs[:mj, j - 1]
            torch.addcmul(u[:mj, j], a[:mj, j], prev, out=hs[:mj, j])
        y[:m, s0:s1] = torch.einsum("bsdn,bsn->bsd", hs, Cm[:m, s0:s1])
        # the sequences that reach the next block carry their last state;
        # the rest have ended (their padded steps in hs are never read)
        h[:active[s1 - 1]] = hs[:active[s1 - 1], -1]
        del a, u, hs
    return y


@torch.no_grad()
def logits_at(weights: dict, cfg: dict, seqs: list, wanted: list,
              quant: str | None = None) -> list:
    """Float32 logits of each sequence (int64 token tensors) at the
    positions ``wanted[i]`` (an index tensor into sequence i)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(weights, cfg, seqs, wanted, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _logits_at(weights, cfg, seqs, wanted, quant):
    z = sizes(cfg)
    eps = cfg["layer_norm_epsilon"]
    dev = weights["embedding"].device
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    lens = torch.tensor([len(seqs[i]) for i in order])
    tmax = int(lens[0])
    offs = torch.cumsum(lens, 0) - lens
    tokens = torch.cat([seqs[i].to(dev) for i in order])
    pos = torch.cat([torch.arange(int(n), device=dev) for n in lens])
    row = torch.repeat_interleave(torch.arange(len(order), device=dev),
                                  lens.to(dev))
    x = weights["embedding"][tokens].float()                 # (T, d)
    lay = weights["layers"]
    for li in range(z["layers"]):
        p = {k: lay[k][li].float() for k in LAYER_KEYS}
        h = _rms(x, p["ln"], eps)
        xz = _mm(h, p["in_proj"], quant)
        xi, zg = xz[:, :z["di"]], xz[:, z["di"]:]
        xc = F.silu(_conv(xi, p["conv_w"], p["conv_b"], pos))
        xdb = _mm(xc, p["x_proj"], quant)
        dtr, Bm, Cm = xdb.split([z["r"], z["n"], z["n"]], dim=-1)
        dt = F.softplus(_mm(dtr.contiguous(), p["dt_proj"], quant)
                        + p["dt_bias"])
        A = -torch.exp(p["A_log"])

        def padded(v):
            out = torch.zeros((len(order), tmax) + v.shape[1:],
                              dtype=v.dtype, device=dev)
            out[row, pos] = v
            return out
        y = _scan(padded(dt), padded(dt * xc), padded(Bm), padded(Cm), A,
                  lens)[row, pos]
        y = (y + p["D"] * xc) * F.silu(zg)
        x = x + _mm(y, p["out_proj"], quant)
        del p, h, xz, xi, zg, xc, xdb, dtr, Bm, Cm, dt, y
    head = weights["embedding"].float().t() if cfg["tie_word_embeddings"] \
        else weights["lm_head"].float()
    out = [None] * len(seqs)
    for j, i in enumerate(order):
        at = int(offs[j]) + wanted[i].to(dev)
        out[i] = _mm(_rms(x[at], weights["final_norm"].float(), eps), head,
                     quant)
    return out


def served_gaps(weights: dict, cfg: dict, prompts: list, served: list,
                quant: str | None = None) -> list:
    """For each request (prompt, tokens served), the gap by which each
    served token's reference logit lies below the reference's best at its
    position.  With ``quant`` (the control), the token judged at each
    position is the one the lower precision puts first, and the gap is
    still the float32 reference's."""
    seqs, wanted = [], []
    for p, s in zip(prompts, served, strict=True):
        p = torch.as_tensor(p, dtype=torch.int64)
        s = torch.as_tensor(s, dtype=torch.int64)
        seqs.append(torch.cat([p, s[:-1]]))
        wanted.append(torch.arange(len(p) - 1, len(p) - 1 + len(s)))
    ref = logits_at(weights, cfg, seqs, wanted)
    picks = [torch.as_tensor(s, dtype=torch.int64) for s in served]
    if quant is not None:
        low = logits_at(weights, cfg, seqs, wanted, quant)
        picks = [lg.argmax(-1).cpu() for lg in low]
    gaps = []
    for lg, tok in zip(ref, picks, strict=True):
        tok = tok.to(lg.device)
        gaps.append((lg.max(-1).values
                     - lg.gather(-1, tok[:, None])[:, 0]).cpu())
    return gaps
