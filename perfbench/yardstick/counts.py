"""The benchmark's own operation and byte counts, and the peaks they are
divided by.  Kept here, and not read from the program, so that a change to
the program cannot move the yardstick.

Peaks are NVIDIA's data sheet for the H100 SXM part (dense rates, no
sparsity, at its full 700 W power limit): 989 TFLOP/s in bf16 and fp16 on
the tensor cores, 67 TFLOP/s in float32 outside them, and 3.35 TB/s of HBM.
A card may run below 700 W; every result line carries the card's
``power.limit`` beside these shares.

Bytes are counted as each input byte read once and each output byte written
once, from shapes; where the work depends on the data, what these inputs
need and not the most they could (the valid rows of a padded table).

``ssm_scan``'s bound does not use the rate of exponentials (16 a clock per
SM at the boost clock) that earlier notes of this repository divide by: that
rate is a throughput of the special-function units taken from the CUDA
programming guide's table, not a published peak of the card, and it depends
on the clock the card actually holds.  The scan is bounded here by its bytes
and by its float32 operations at the data-sheet peaks, like every other
kernel.
"""
from __future__ import annotations

H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
               "int64": 8}


def bound_seconds(flops: float, nbytes: float, flops_per_s: float) -> float:
    """The least time the card could take: the larger of the operations
    over the compute peak and the bytes over the memory bandwidth."""
    return max(flops / flops_per_s, nbytes / H100_HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# radix_partition: n bucket ids in, each row's destination and the B counts
# out (no arithmetic worth a bound: it is bounded by its bytes)
# ---------------------------------------------------------------------------
def radix_partition_bytes(n_rows: int, n_buckets: int) -> int:
    """int32 ids read (4 n), int32 destinations written (4 n), int32
    histogram written (4 B)."""
    return 8 * n_rows + 4 * n_buckets


# ---------------------------------------------------------------------------
# ssm_scan: the selective scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
# y_t = C_t . h_t over (batch, steps, channels D, states N)
# ---------------------------------------------------------------------------
def ssm_scan_flops(b: int, s: int, d: int, n: int) -> int:
    """Per (step, channel, state): dt*A, exp, the fused a*h + b (2), the
    input's product with B, and C's fused multiply-add into y (2): 7; per
    (step, channel): dt*x once: 1."""
    return b * s * d * (7 * n + 1)


def ssm_scan_bytes(b: int, s: int, d: int, n: int, *, dt: str = "float32",
                   x: str = "bfloat16", bc: str = "bfloat16",
                   y: str = "float32", state: bool = True) -> int:
    """dt and x (B,S,D) read, A (D,N) f32 read, B and C (B,S,N) read, y
    (B,S,D) written, and the final state (B,D,N) f32 written where the call
    returns it (a prefill does)."""
    sz = DTYPE_BYTES
    return (b * s * d * (sz[dt] + sz[x] + sz[y]) + 2 * b * s * n * sz[bc]
            + d * n * 4 + (b * d * n * 4 if state else 0))


def ssm_scan_bound_s(b: int, s: int, d: int, n: int, **dtypes) -> float:
    return bound_seconds(ssm_scan_flops(b, s, d, n),
                         ssm_scan_bytes(b, s, d, n, **dtypes),
                         H100_F32_FLOPS)


# ---------------------------------------------------------------------------
# a Mamba1 language model (falcon-mamba): model FLOPs of serving, counted
# from the configuration's shapes; nothing recomputed is counted
# ---------------------------------------------------------------------------
def mamba1_sizes(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    di = cfg["intermediate_size"]
    return {"d": d, "di": di, "n": cfg["state_size"],
            "r": cfg["time_step_rank"], "k": cfg["conv_kernel"],
            "layers": cfg["num_hidden_layers"], "vocab": cfg["vocab_size"]}


def mamba1_layer_flops_per_token(cfg: dict) -> int:
    """One token through one layer: the four weight products (in_proj d x
    2di, x_proj di x (r + 2N), dt_proj r x di, out_proj di x d) at 2 FLOPs a
    multiply-add, the depthwise conv (2 k di) and the scan (7N + 1 a
    channel).  Norms and gates are left out: they are elementwise, a few
    FLOPs a channel against thousands."""
    z = mamba1_sizes(cfg)
    d, di, n, r, k = z["d"], z["di"], z["n"], z["r"], z["k"]
    weights = d * 2 * di + di * (r + 2 * n) + r * di + di * d
    return 2 * weights + 2 * k * di + di * (7 * n + 1)


def mamba1_logits_flops(cfg: dict) -> int:
    """The head over the vocabulary for one position."""
    z = mamba1_sizes(cfg)
    return 2 * z["d"] * z["vocab"]


def mamba1_prefill_flops(cfg: dict, prompt_len: int) -> int:
    """Every prompt token through every layer, and the head at the last
    position (which yields the first generated token)."""
    z = mamba1_sizes(cfg)
    return (prompt_len * z["layers"] * mamba1_layer_flops_per_token(cfg)
            + mamba1_logits_flops(cfg))


def mamba1_decode_flops(cfg: dict) -> int:
    """One generated token fed back through every layer and the head."""
    z = mamba1_sizes(cfg)
    return (z["layers"] * mamba1_layer_flops_per_token(cfg)
            + mamba1_logits_flops(cfg))


def mamba1_request_flops(cfg: dict, prompt_len: int, new_tokens: int) -> int:
    """A served request: its prefill and ``new_tokens - 1`` decode steps
    (the first token comes from the prefill's logits)."""
    return (mamba1_prefill_flops(cfg, prompt_len)
            + max(new_tokens - 1, 0) * mamba1_decode_flops(cfg))


def mamba1_params(cfg: dict, tied: bool) -> int:
    """Parameters of the model as served (for the record only)."""
    z = mamba1_sizes(cfg)
    d, di, n, r, k = z["d"], z["di"], z["n"], z["r"], z["k"]
    layer = (d + d * 2 * di + k * di + di + di * (r + 2 * n) + r * di + di
             + di * n + di + di * d)
    head = 0 if tied else d * z["vocab"]
    return z["layers"] * layer + z["vocab"] * d + head + d

