"""internvl2-1b [vlm]: InternViT frontend STUB (patch embeddings provided by
input_specs) + qwen2-0.5b-style LM backbone. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151655, head_dim=64, rope_theta=1e6,
    n_patches=256, tie_embeddings=True,
)
