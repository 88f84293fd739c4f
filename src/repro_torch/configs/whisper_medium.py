"""whisper-medium [audio]: enc-dec; conv/log-mel frontend STUB (input_specs
provides frame embeddings (B, 1500, d)). 24 enc + 24 dec layers.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865, head_dim=64, rope_theta=1e4,
    n_encoder_layers=24, n_encoder_frames=1500, tie_embeddings=True,
)
