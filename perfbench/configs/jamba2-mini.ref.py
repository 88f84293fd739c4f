"""Plain reference of AI21-Jamba2-Mini as one chip of its deployment runs it
(``configs/jamba2-mini.json``): its weights, made from the seed, and its
forward pass in float32.

Imports nothing but ``torch``.  Layer i is ``x + mixer(rms(x))`` then
``x + ffn(rms(x))``:

* the mixer is attention where ``i % attn_layer_period ==
  attn_layer_offset``: GQA with no positional encoding, causal
  ``softmax(q k^T / sqrt(hd)) v``; elsewhere a Mamba1 block: ``in_proj``
  to x and z, a causal depthwise conv with bias and SiLU, ``x_proj`` to
  dt, B and C, each through an RMS norm with a learned weight, ``dt_proj``
  and softplus with the dt bias, the selective scan

      h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,   y_t = C_t . h_t,
      A = -exp(A_log),

  then ``y + D x``, the gate ``silu(z)`` and ``out_proj``;
* the FFN is the expert layer where ``i % expert_layer_period ==
  expert_layer_offset``: a float32 softmax over all
  ``published_num_experts`` router outputs, the top ``num_experts_per_tok``
  (ties to the lower index), the gates as the softmax gave them; each pair
  routed to a held expert (``held_experts``, ``[lo, hi)``) adds its
  expert's SwiGLU output times its gate, every other pair adds nothing;
  elsewhere a SwiGLU MLP;

a final RMS norm and the untied head.  ``weights["moe"]`` holds the held
experts only; the router has all the published outputs.

Everything is computed in float32 with TF32 off.  A product with a
bfloat16 weight, which bfloat16 holds exactly, runs as three products of
the float32 activation's exact bfloat16 parts with float32 sums and
output (``_mm``): float32's precision at the tensor cores' speed.  To
fit beside the weights on the card the sequences go in groups of at most
``GROUP_TOKENS`` tokens (longest first), packed for the products, whose
rows go ``ROW_BLOCK`` at a time; the conv masks each sequence's start;
attention runs a sequence at a time over blocks of ``Q_BLOCK`` queries;
the scan runs over the group's sequences a block of steps at a time, in
chunks of ``SCAN_CHUNK`` steps scanned at once and then joined
(``_scan``).
``quant="fp8"`` is the control: every weight product's operands rounded to
float8 e4m3 (activations by a scale a row, weights by a scale an output
column) and multiplied in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GROUP_TOKENS = 48_000    # tokens of the sequences run through together
ROW_BLOCK = 8192         # rows of one product
Q_BLOCK = 512            # queries of one attention block
SCAN_ELEMS = 1 << 27     # elements of one (m, S, D, N) block of the scan
SCAN_CHUNK = 32          # steps of a chunk, scanned from zero at once
E4M3_MAX = 448.0


def sizes(cfg: dict) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "di": cfg["mamba_expand"] * d, "n": cfg["mamba_d_state"],
            "r": cfg["mamba_dt_rank"], "k": cfg["mamba_d_conv"],
            "f": cfg["intermediate_size"], "layers": cfg["num_hidden_layers"],
            "vocab": cfg["vocab_size"], "heads": h,
            "kv": cfg["num_key_value_heads"], "hd": d // h,
            "experts": cfg["num_experts"],
            "router": cfg["published_num_experts"],
            "top_k": cfg["num_experts_per_tok"]}


def is_attention(cfg: dict, i: int) -> bool:
    return i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]


def is_moe(cfg: dict, i: int) -> bool:
    return i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]


def layer_slots(cfg: dict) -> list:
    """Each layer's (mixer kind, index in its stack, FFN kind, index)."""
    seen = {"mamba": 0, "attn": 0, "mlp": 0, "moe": 0}
    out = []
    for i in range(cfg["num_hidden_layers"]):
        mixer = "attn" if is_attention(cfg, i) else "mamba"
        ffn = "moe" if is_moe(cfg, i) else "mlp"
        out.append((mixer, seen[mixer], ffn, seen[ffn]))
        seen[mixer] += 1
        seen[ffn] += 1
    return out


def make_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The model's weights from ``seed``, on ``device``, in a few large
    calls: each kind of weight for all the layers of its kind at once.
    ``mamba``, ``attn``, ``mlp`` and ``moe`` map each name to a tensor
    stacked over those layers, in layer order."""
    z = sizes(cfg)
    d, di, n, r, k, f = z["d"], z["di"], z["n"], z["r"], z["k"], z["f"]
    slots = layer_slots(cfg)
    count = {kind: sum(1 for s in slots if kind in (s[0], s[2]))
             for kind in ("mamba", "attn", "mlp", "moe")}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape, fan_in, dt=dtype):
        t = torch.randn(shape, generator=gen, dtype=dt, device=device)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    L = count["mamba"]
    lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
    dt = torch.exp(lo + (hi - lo) * torch.rand(
        (L, di), generator=gen, dtype=torch.float32, device=device))
    dt = dt.clamp_min(cfg["time_step_floor"])
    a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
    mamba = {
        "ln": ones(L, d), "in_proj": normal((L, d, 2 * di), d),
        "conv_w": normal((L, k, di), k),
        "conv_b": torch.zeros((L, di), dtype=dtype, device=device),
        "x_proj": normal((L, di, r + 2 * n), di),
        "dt_norm": ones(L, r), "B_norm": ones(L, n), "C_norm": ones(L, n),
        "dt_proj": normal((L, r, di), r),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
        "A_log": a.expand(L, di, n).contiguous(),
        "D": torch.ones((L, di), dtype=torch.float32, device=device),
        "out_proj": normal((L, di, d), di)}
    A, h, kv, hd = count["attn"], z["heads"], z["kv"], z["hd"]
    attn = {"ln": ones(A, d), "wq": normal((A, d, h, hd), d),
            "wk": normal((A, d, kv, hd), d), "wv": normal((A, d, kv, hd), d),
            "wo": normal((A, h, hd, d), h * hd)}
    M = count["mlp"]
    mlp = {"ln": ones(M, d), "wg": normal((M, d, f), d),
           "wi": normal((M, d, f), d), "wo": normal((M, f, d), f)}
    X, e = count["moe"], z["experts"]
    moe = {"ln": ones(X, d),
           "router": normal((X, d, z["router"]), d, torch.float32),
           "wg": normal((X, e, d, f), d), "wi": normal((X, e, d, f), d),
           "wo": normal((X, e, f, d), f)}
    return {"embedding": torch.randn((z["vocab"], d), generator=gen,
                                     dtype=dtype, device=device),
            "lm_head": normal((d, z["vocab"]), d),
            "final_norm": ones(d),
            "mamba": mamba, "attn": attn, "mlp": mlp, "moe": moe}


# ---------------------------------------------------------------------------
def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _fp8(x, dim):
    """Round to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _split3(x):
    """A float32 tensor as three bfloat16 ones, each what the ones before
    it left over, whose sum is ``x`` to float32's own precision (3 x 8
    significand bits against its 24)."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def _mm_exact(a, w):
    """A bfloat16 ``a`` times a bfloat16 ``w``, summed and returned in
    float32: on the card the tensor cores' product with float32 output."""
    if a.is_cuda:
        return torch.mm(a, w, out_dtype=torch.float32)
    return a.float() @ w.float()


def _mm(x, w, quant):
    """x (T, a) float32 times w (a, b), ``ROW_BLOCK`` rows at a time.  A
    bfloat16 ``w`` (every weight but the router) is exact in bfloat16, so
    the product runs as ``x``'s three bfloat16 parts (``_split3``) times
    ``w``, each product and their sum in float32: the float32 product to
    float32's precision, on the tensor cores.  A float32 ``w``, and the
    control's operands, are multiplied in float32."""
    if quant == "fp8":
        w = _fp8(w.float(), 0)
    out = x.new_empty((x.shape[0], w.shape[1]))
    for r0 in range(0, x.shape[0], ROW_BLOCK):
        xb = x[r0:r0 + ROW_BLOCK]
        if quant == "fp8":
            out[r0:r0 + ROW_BLOCK] = _fp8(xb, -1) @ w
        elif w.dtype == torch.bfloat16:
            hi, mid, lo = _split3(xb)
            out[r0:r0 + ROW_BLOCK] = (_mm_exact(hi, w) + _mm_exact(mid, w)
                                      + _mm_exact(lo, w))
        else:
            out[r0:r0 + ROW_BLOCK] = xb @ w
    return out


def _swiglu(x, wg, wi, wo, quant):
    out = x.new_empty((x.shape[0], wo.shape[1]))
    for r0 in range(0, x.shape[0], ROW_BLOCK):
        xb = x[r0:r0 + ROW_BLOCK]
        out[r0:r0 + ROW_BLOCK] = _mm(F.silu(_mm(xb, wg, quant))
                                     * _mm(xb, wi, quant), wo, quant)
    return out


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


def _scan(dt, dtx, Bm, Cm, A, offs, lens):
    """The selective scan over packed sequences sorted longest first
    (sequence j's tokens at ``offs[j]`` on, ``lens[j]`` of them); returns y
    (T, D) packed.

    The steps go a block at a time: for the ``m`` sequences still running
    at its first step, as many steps as keep a (m, S, D, N) tensor within
    ``SCAN_ELEMS`` elements, cut into chunks of ``SCAN_CHUNK`` steps (a
    sequence that ends inside the block repeats its last row; those steps
    are never read back).  Inside the block, every chunk is scanned from a
    zero state at once, a step of all chunks a launch; the state entering
    each chunk is then carried across the chunks, a chunk a launch; last,
    each step adds its chunk's entering state times the decay from the
    chunk's start to the step, the cumulative product of the steps'
    decays.  No step divides by a decay, so none can overflow."""
    T, di = dt.shape
    n = A.shape[1]
    L = SCAN_CHUNK
    dev = dt.device
    y = torch.empty((T, di), dtype=torch.float32, device=dev)
    h = torch.zeros((len(lens), di, n), dtype=torch.float32, device=dev)
    tmax = int(lens[0])
    offs_d, lens_d = offs.to(dev), lens.to(dev)
    s0 = 0
    while s0 < tmax:
        m = int((lens > s0).sum())
        chunks = max(1, min(SCAN_ELEMS // (m * L * di * n),
                            -(-(tmax - s0) // L)))
        S = chunks * L
        real = min(S, tmax - s0)                 # steps that exist
        steps = torch.arange(s0, s0 + S, device=dev)
        valid = steps[None, :] < lens_d[:m, None]                 # (m, S)
        rows = offs_d[:m, None] + torch.minimum(steps[None, :],
                                                lens_d[:m, None] - 1)
        shape = (m, chunks, L, di, n)
        a = (dt[rows][..., None] * A).view(shape).exp_()    # decays
        hs = (dtx[rows][..., None] * Bm[rows][:, :, None, :]).view(shape)
        for j in range(1, L):       # each chunk from a zero state
            hs[:, :, j].addcmul_(a[:, :, j], hs[:, :, j - 1])
        decay = a.cumprod_(2)       # chunk start to each step
        enter = torch.empty((m, chunks, di, n), dtype=torch.float32,
                            device=dev)
        cur = h[:m]
        for c in range(chunks):
            enter[:, c] = cur
            cur = torch.addcmul(hs[:, c, -1], decay[:, c, -1], cur)
        hs.addcmul_(decay, enter[:, :, None])
        del a, decay, enter
        hs = hs.view(m, S, di, n)
        y[rows[valid]] = torch.einsum("bsdn,bsn->bsd", hs, Cm[rows])[valid]
        # the sequences that reach the next block carry their last state
        h[:m] = hs[:, real - 1]
        del hs
        s0 += real
    return y


def _mamba(p, x, pos, offs, lens, z, eps, quant):
    di, n, r = z["di"], z["n"], z["r"]
    h = _rms(x, p["ln"], eps)
    xc = F.silu(_conv(_mm(h, p["in_proj"][:, :di], quant), p["conv_w"],
                      p["conv_b"], pos))
    xdb = _mm(xc, p["x_proj"], quant)
    dtr, Bm, Cm = xdb.split([r, n, n], dim=-1)
    dtr = _rms(dtr, p["dt_norm"], eps)
    Bm = _rms(Bm, p["B_norm"], eps)
    Cm = _rms(Cm, p["C_norm"], eps)
    dt = F.softplus(_mm(dtr, p["dt_proj"], quant) + p["dt_bias"])
    y = _scan(dt, dt * xc, Bm, Cm, -torch.exp(p["A_log"]), offs, lens)
    del dt, xdb, dtr, Bm, Cm
    y = (y + p["D"] * xc) * F.silu(_mm(h, p["in_proj"][:, di:], quant))
    return _mm(y, p["out_proj"], quant)


def _attention(p, x, offs, lens, z, eps, quant):
    hq, kv, hd, d = z["heads"], z["kv"], z["hd"], z["d"]
    g = hq // kv
    h = _rms(x, p["ln"], eps)
    q = _mm(h, p["wq"].reshape(d, -1), quant).view(-1, kv, g, hd)
    k = _mm(h, p["wk"].reshape(d, -1), quant).view(-1, kv, hd)
    v = _mm(h, p["wv"].reshape(d, -1), quant).view(-1, kv, hd)
    o = torch.empty_like(q)
    for o0, n in zip(offs.tolist(), lens.tolist(), strict=True):
        ks, vs = k[o0:o0 + n], v[o0:o0 + n]
        for q0 in range(0, n, Q_BLOCK):
            q1 = min(q0 + Q_BLOCK, n)
            s = torch.einsum("qkgd,tkd->kgqt", q[o0 + q0:o0 + q1],
                             ks[:q1]) / math.sqrt(hd)
            causal = torch.arange(q1, device=x.device)[None, :] > \
                torch.arange(q0, q1, device=x.device)[:, None]
            s.masked_fill_(causal, float("-inf"))
            o[o0 + q0:o0 + q1] = torch.einsum(
                "kgqt,tkd->qkgd", torch.softmax(s, dim=-1), vs[:q1])
            del s
    return _mm(o.reshape(-1, hq * hd), p["wo"].reshape(hq * hd, d), quant)


def _experts(p, x, z, eps, lo, quant):
    """The held experts' part of the expert layer: for each pair routed to
    expert ``lo + e`` of the ``p["wg"].shape[0]`` held, its gate times the
    expert's SwiGLU output; the other pairs add nothing."""
    h = _rms(x, p["ln"].float(), eps)
    gates = torch.softmax(_mm(h, p["router"].float(), quant), dim=-1)
    top = torch.sort(gates, dim=-1, descending=True,
                     stable=True).indices[:, :z["top_k"]]
    out = torch.zeros_like(x)
    for e in range(p["wg"].shape[0]):
        tok, j = torch.nonzero(top == lo + e, as_tuple=True)
        if tok.numel():
            y = _swiglu(h[tok], p["wg"][e], p["wi"][e], p["wo"][e], quant)
            out.index_add_(0, tok, y * gates[tok, lo + e][:, None])
    return out


@torch.no_grad()
def logits_at(weights: dict, cfg: dict, seqs: list, wanted: list,
              quant: str | None = None) -> list:
    """Float32 logits of each sequence (int64 token tensors) at the
    positions ``wanted[i]`` (an index tensor into sequence i)."""
    mm = torch.backends.cuda.matmul
    tf32 = (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
        groups, cur = [], []
        for i in order:
            if cur and sum(len(seqs[j]) for j in cur) + len(seqs[i]) > \
                    GROUP_TOKENS:
                groups.append(cur)
                cur = []
            cur.append(i)
        groups.append(cur)
        out = [None] * len(seqs)
        for grp in groups:
            got = _logits_at(weights, cfg, [seqs[i] for i in grp],
                             [wanted[i] for i in grp], quant)
            for i, lg in zip(grp, got, strict=True):
                out[i] = lg
        return out
    finally:
        (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = tf32


def _logits_at(weights, cfg, seqs, wanted, quant):
    """One group of sequences, sorted longest first."""
    z = sizes(cfg)
    eps = cfg["rms_norm_eps"]
    lo = cfg["held_experts"][0]
    dev = weights["embedding"].device
    lens = torch.tensor([len(s) for s in seqs])
    offs = torch.cumsum(lens, 0) - lens
    tokens = torch.cat([s.to(dev) for s in seqs])
    pos = torch.cat([torch.arange(int(n), device=dev) for n in lens])
    x = weights["embedding"][tokens].float()                 # (T, d)
    for mixer, mi, ffn, fi in layer_slots(cfg):
        p = {k: v[mi] for k, v in weights[mixer].items()}
        if mixer == "attn":
            x = x + _attention(p, x, offs, lens, z, eps, quant)
        else:
            x = x + _mamba(p, x, pos, offs, lens, z, eps, quant)
        del p
        if ffn == "moe":
            # the experts one at a time (``_experts``)
            x = x + _experts({k: v[fi] for k, v in weights[ffn].items()}, x,
                             z, eps, lo, quant)
            continue
        p = {k: v[fi] for k, v in weights[ffn].items()}
        x = x + _swiglu(_rms(x, p["ln"], eps), p["wg"], p["wi"], p["wo"],
                        quant)
        del p
    head = weights["lm_head"]
    out = []
    for o0, want in zip(offs.tolist(), wanted, strict=True):
        at = o0 + want.to(dev)
        out.append(_mm(_rms(x[at], weights["final_norm"].float(), eps),
                       head, quant))
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
