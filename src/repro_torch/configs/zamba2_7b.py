"""zamba2-7b [hybrid]: 81 Mamba2 blocks + one shared attention/MLP block
applied every 9 blocks (single weight copy). [arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_version=2, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    shared_attn_period=9, rope_theta=1e4, ssm_chunk=1024,
)
