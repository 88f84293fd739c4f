"""Operation and byte counts of AI21-Jamba2-Mini as one chip of its
deployment serves it (``configs/jamba2-mini.json``), from the
configuration's shapes; the peaks are ``counts``'s.  Kept with the
benchmark, not read from the program.

Model FLOPs count each multiply-add of a weight product as 2, and what a
token needs, not what the program recomputes.  The expert layers' work
depends on the routing: it is counted from the pairs the program reports
it routed to the held experts (``serve_moe_pairs_held``), each pair one
expert's SwiGLU, ``3 d f`` multiply-adds.  Attention's own products
(``q k^T`` and ``p v``) are ``4 hd H`` FLOPs a (query, key) pair it
attends; a causal prompt of S tokens has ``S (S + 1) / 2`` such pairs a
layer, a decode step at position p has ``p + 1``.  Norms, gates, the
conv and the router's softmax are left out (a few FLOPs a channel against
thousands); the scan is counted as ``counts.ssm_scan_flops``.
"""
from __future__ import annotations

from yardstick.counts import (DTYPE_BYTES, H100_BF16_FLOPS, bound_seconds,
                              ssm_scan_bound_s)


def sizes(cfg: dict) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    n_layers = cfg["num_hidden_layers"]
    attn = sum(1 for i in range(n_layers)
               if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"])
    moe = sum(1 for i in range(n_layers)
              if i % cfg["expert_layer_period"] == cfg["expert_layer_offset"])
    return {"d": d, "di": cfg["mamba_expand"] * d, "n": cfg["mamba_d_state"],
            "r": cfg["mamba_dt_rank"], "k": cfg["mamba_d_conv"],
            "f": cfg["intermediate_size"], "heads": h,
            "kv": cfg["num_key_value_heads"], "hd": d // h,
            "vocab": cfg["vocab_size"], "held": cfg["num_experts"],
            "router": cfg["published_num_experts"],
            "top_k": cfg["num_experts_per_tok"],
            "mamba_layers": n_layers - attn, "attn_layers": attn,
            "moe_layers": moe, "mlp_layers": n_layers - moe}


def mamba_flops_per_token(cfg: dict) -> int:
    """in_proj (d x 2di), x_proj (di x (r + 2N)), dt_proj (r x di),
    out_proj (di x d), the conv (2 k di) and the scan (7N + 1 a channel)."""
    z = sizes(cfg)
    d, di, n, r, k = z["d"], z["di"], z["n"], z["r"], z["k"]
    weights = d * 2 * di + di * (r + 2 * n) + r * di + di * d
    return 2 * weights + 2 * k * di + di * (7 * n + 1)


def attn_proj_flops_per_token(cfg: dict) -> int:
    """wq (d x H hd), wk and wv (d x K hd), wo (H hd x d)."""
    z = sizes(cfg)
    return 2 * z["d"] * z["hd"] * (2 * z["heads"] + 2 * z["kv"])


def flash_attention_flops(cfg: dict, s: int) -> int:
    """One causal attention layer's own products over a prompt of ``s``:
    4 hd H a (query, key) pair, S (S + 1) / 2 pairs."""
    z = sizes(cfg)
    return 4 * z["hd"] * z["heads"] * s * (s + 1) // 2


def mlp_flops_per_token(cfg: dict) -> int:
    z = sizes(cfg)
    return 2 * 3 * z["d"] * z["f"]


def expert_pair_flops(cfg: dict) -> int:
    """One (token, expert) pair through its expert's SwiGLU."""
    return mlp_flops_per_token(cfg)


def router_flops_per_token(cfg: dict) -> int:
    z = sizes(cfg)
    return 2 * z["d"] * z["router"]


def dense_flops_per_token(cfg: dict) -> int:
    """Every layer's work on one token but the experts' and attention's own
    products: the Mamba layers, the attention projections, the dense MLPs
    and the routers."""
    z = sizes(cfg)
    return (z["mamba_layers"] * mamba_flops_per_token(cfg)
            + z["attn_layers"] * attn_proj_flops_per_token(cfg)
            + z["mlp_layers"] * mlp_flops_per_token(cfg)
            + z["moe_layers"] * router_flops_per_token(cfg))


def head_flops(cfg: dict) -> int:
    z = sizes(cfg)
    return 2 * z["d"] * z["vocab"]


def prefill_flops(cfg: dict, prompt_len: int, pairs: int) -> int:
    """A prompt's prefill: every token through every layer, its held
    ``pairs`` through their experts, causal attention, and the head at the
    last position."""
    z = sizes(cfg)
    return (prompt_len * dense_flops_per_token(cfg)
            + pairs * expert_pair_flops(cfg)
            + z["attn_layers"] * flash_attention_flops(cfg, prompt_len)
            + head_flops(cfg))


def decode_flops(cfg: dict, position: int, pairs: float) -> float:
    """One generated token fed back at ``position`` (it attends position
    + 1 keys), with ``pairs`` held pairs over the expert layers."""
    z = sizes(cfg)
    return (dense_flops_per_token(cfg) + pairs * expert_pair_flops(cfg)
            + z["attn_layers"] * 4 * z["hd"] * z["heads"] * (position + 1)
            + head_flops(cfg))


def request_flops(cfg: dict, prompt_len: int, new_tokens: int,
                  pairs: int) -> float:
    """A served request: its prefill with ``pairs`` held pairs and
    ``new_tokens - 1`` decode steps, each with the prefill's held pairs a
    token (the decode steps' routing is not counted by the program)."""
    per_token = pairs / max(prompt_len, 1)
    total = prefill_flops(cfg, prompt_len, pairs)
    for j in range(max(new_tokens - 1, 0)):
        total += decode_flops(cfg, prompt_len + j, per_token)
    return total


def held_expert_bytes(cfg: dict) -> int:
    """One expert layer's held expert weights (wg, wi: d x f; wo: f x d)
    in the model's dtype."""
    z = sizes(cfg)
    return 3 * z["held"] * z["d"] * z["f"] * DTYPE_BYTES[cfg["torch_dtype"]]


def expert_product_bound_s(cfg: dict, pairs: float) -> float:
    """One of an expert layer's three grouped products over ``pairs`` held
    pairs: its FLOPs at the bf16 peak, or its held experts' weight bytes
    at the HBM bandwidth, the larger."""
    z = sizes(cfg)
    return bound_seconds(2 * pairs * z["d"] * z["f"],
                         held_expert_bytes(cfg) / 3, H100_BF16_FLOPS)


def flash_attention_bound_s(cfg: dict, s: int) -> float:
    """One prefill launch: the products' FLOPs at the bf16 peak (the bytes
    of q, k, v and o, 2 (H + K) hd S in bf16, bound it only below ~250
    tokens)."""
    z = sizes(cfg)
    nbytes = 2 * (2 * z["heads"] + 2 * z["kv"]) * z["hd"] * s
    return bound_seconds(flash_attention_flops(cfg, s), nbytes,
                         H100_BF16_FLOPS)


def ssm_scan_bound(cfg: dict, s: int) -> float:
    """The shared ``ssm_scan`` at a prefill of ``s``: d_inner = mamba_expand
    x hidden_size channels, dt and y float32, x, B and C in the model
    dtype, the final state returned."""
    z = sizes(cfg)
    md = cfg["torch_dtype"]
    return ssm_scan_bound_s(1, s, z["di"], z["n"], dt="float32", x=md,
                            bc=md, y="float32", state=True)
