"""Config dataclasses for models, input shapes and parallelism.

Every assigned architecture gets one module in this package exporting CONFIG
(a ModelConfig with the exact published dimensions). ``reduced()`` derives a
tiny same-family config for CPU smoke tests; the full configs are exercised
only via the AOT dry-run (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default: d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_layer_period: int = 1               # every k-th layer is MoE (llama4: 2)
    d_ff_dense: Optional[int] = None        # d_ff of non-MoE layers (llama4: 16384)
    capacity_factor: float = 1.25

    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1                    # 1 = mamba1 (falcon-mamba), 2 = mamba2
    ssm_head_dim: int = 64                  # mamba2 head dim

    # --- hybrid (zamba2): one *shared* attn+MLP block applied every k SSM blocks ---
    shared_attn_period: int = 0

    # --- encoder-decoder (whisper) ---
    n_encoder_layers: int = 0
    n_encoder_frames: int = 0               # stubbed frontend sequence length

    # --- VLM (internvl2) ---
    n_patches: int = 0                      # stubbed patch embeddings prepended

    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 0                     # 0 = full attention; >0 = chunked flash-style
    ssm_chunk: int = 128                    # seq chunk for the selective-scan train path
    unroll_scans: bool = False              # analysis mode: fully unroll all scans so
                                            # cost_analysis counts every iteration
    # --- perf knobs (see EXPERIMENTS.md §Perf) ---
    fused_ssm_y: bool = False               # fuse the C-contraction into the chunk
                                            # scan: never materialize (S, d_inner, N)
    causal_skip: bool = False               # skip fully-masked causal attn blocks
    remat_mode: str = "dots"                # dots | nothing | none
    ssm_scan_dtype: str = "float32"         # bfloat16 halves the scan's HBM
                                            # traffic (TPU kernel keeps f32 acc)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.n_kv_heads == 0

    # ---------- derived quantities ----------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        # interleaved: layers (period-1, 2*period-1, ...) are MoE when period>1;
        # period == 1 means every layer.
        return (i % self.moe_layer_period) == (self.moe_layer_period - 1)

    @property
    def n_moe_layers(self) -> int:
        return sum(self.is_moe_layer(i) for i in range(self.n_layers))

    # ---------- parameter counting (exact, mirrors models/*.py init) ----------
    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim
        nh, nkv = self.n_heads, self.n_kv_heads

        def attn_params(dm, heads, kv, hdim, with_qk_norm):
            p = dm * heads * hdim + 2 * dm * kv * hdim + heads * hdim * dm
            if with_qk_norm:
                p += 2 * hdim
            return p

        def mlp_params(dm, ff):
            return 3 * dm * ff  # gate, up, down (SwiGLU)

        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        total += d  # final norm

        if self.family in ("dense", "moe", "vlm"):
            for i in range(self.n_layers):
                total += 2 * d  # pre-norms
                total += attn_params(d, nh, nkv, hd, self.qk_norm)
                if self.is_moe_layer(i):
                    total += d * self.n_experts            # router
                    total += self.n_experts * mlp_params(d, self.d_ff)
                    total += self.n_shared_experts * mlp_params(d, self.d_ff)
                    if self.n_shared_experts:
                        total += d * 1                      # shared gate
                else:
                    total += mlp_params(d, self.d_ff_dense or self.d_ff)
        elif self.family == "ssm":
            for _ in range(self.n_layers):
                total += d  # pre-norm
                total += self._mamba1_params()
        elif self.family == "hybrid":
            for _ in range(self.n_layers):
                total += d
                total += self._mamba2_params()
            # one shared transformer block (single copy)
            total += 2 * d + attn_params(d, nh, nkv, hd, False) + mlp_params(d, self.d_ff)
        elif self.family == "audio":
            # encoder layers (self-attn, MHA) + decoder layers (self + cross)
            for _ in range(self.n_encoder_layers):
                total += 2 * d + attn_params(d, nh, nh, hd, False) + mlp_params(d, self.d_ff)
            for _ in range(self.n_layers):
                total += 3 * d  # pre-norms (self, cross, mlp)
                total += attn_params(d, nh, nkv, hd, False)       # self
                total += attn_params(d, nh, nh, hd, False)        # cross
                total += mlp_params(d, self.d_ff)
            total += d  # encoder final norm
        else:
            raise ValueError(self.family)
        return total

    def _mamba1_params(self) -> int:
        d, di, st, dtr = self.d_model, self.d_inner, self.ssm_state, self.dt_rank
        p = d * 2 * di                        # in_proj (x, z)
        p += self.ssm_conv * di + di          # depthwise conv + bias
        p += di * (dtr + 2 * st)              # x_proj -> dt, B, C
        p += dtr * di + di                    # dt_proj
        p += di * st                          # A_log
        p += di                               # D
        p += di * d                           # out_proj
        return p

    def _mamba2_params(self) -> int:
        d, di, st = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_heads
        # in_proj -> z, x, B, C, dt  (grouped B/C: one group)
        p = d * (2 * di + 2 * st + nh)
        p += self.ssm_conv * (di + 2 * st) + (di + 2 * st)   # conv over x,B,C
        p += nh + nh + nh                     # A_log, D, dt_bias (per head)
        p += di                               # gated rmsnorm weight
        p += di * d                           # out_proj
        return p

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.param_count()
        per_expert = 3 * self.d_model * self.d_ff
        inactive = self.n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# Sub-quadratic state: only SSM/hybrid archs run the 500k-decode shape.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in LONG_CONTEXT_FAMILIES
    return True


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a step is sharded onto the mesh (see distributed/sharding.py)."""
    fsdp: bool = True            # shard params/opt-state over 'data'
    tensor_parallel: bool = True # shard heads/ff/experts over 'model'
    sequence_parallel: bool = False  # shard long-prefill activations over 'model'
    pipeline_stages: int = 1     # >1: pod axis becomes a pipeline axis
    grad_compression: str = "none"  # none | int8
    remat_policy: str = "minimal"   # none | minimal | full
    microbatches: int = 1
    attn_block: int = 512           # q/kv tile for blockwise attention
    moe_impl: str = "gspmd"         # gspmd | shardmap (local-expert EP)
    dp_axes: tuple = ("pod", "data")  # axes used for data parallelism (present subset)
    fsdp_axes: tuple = ("data",)      # axes params/opt-state shard over (ZeRO-3)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests. Preserves structure
    (GQA grouping, MoE routing, hybrid period, enc-dec) at toy sizes."""
    nh = 4
    nkv = max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads else 0
    if cfg.n_kv_heads == cfg.n_heads:  # MHA archs stay MHA
        nkv = nh
    kw = dict(
        name=cfg.name + "-reduced",
        family=cfg.family,
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 4),
        d_model=64,
        n_heads=nh,
        n_kv_heads=nkv,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta,
        tie_embeddings=cfg.tie_embeddings,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_conv=cfg.ssm_conv,
        ssm_expand=cfg.ssm_expand,
        ssm_version=cfg.ssm_version,
        ssm_head_dim=16,
        ssm_chunk=8,
        shared_attn_period=2 if cfg.shared_attn_period else 0,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        n_encoder_frames=16 if cfg.n_encoder_frames else 0,
        n_patches=8 if cfg.n_patches else 0,
        dtype="float32",
        remat=False,
        scan_layers=cfg.scan_layers,
    )
    if cfg.n_experts:
        kw.update(
            n_experts=4,
            n_shared_experts=min(cfg.n_shared_experts, 1),
            top_k=min(cfg.top_k, 2),
            moe_layer_period=cfg.moe_layer_period,
            capacity_factor=4.0,
            d_ff_dense=128 if cfg.d_ff_dense else None,
        )
    if cfg.family == "hybrid":
        kw["n_layers"] = 4  # 2 groups x 2 layers with period 2
    return ModelConfig(**kw)
