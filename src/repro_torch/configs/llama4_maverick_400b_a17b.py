"""llama4-maverick-400b-a17b [moe]: interleaved MoE (every 2nd layer),
128 routed experts top-1 + 1 shared expert; dense layers d_ff=16384.
~400B total / ~17B active. [hf:meta-llama/Llama-4-*; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128, rope_theta=5e5,
    n_experts=128, n_shared_experts=1, top_k=1,
    moe_layer_period=2, d_ff_dense=16384,
)
