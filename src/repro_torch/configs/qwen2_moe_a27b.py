"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + 4 shared experts
(d_ff 1408 each; released shared-intermediate 5632 = 4x1408), all layers MoE.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=151936, head_dim=128, rope_theta=1e6,
    n_experts=60, n_shared_experts=4, top_k=4, moe_layer_period=1,
)
