"""AI21-Jamba2-Mini [jamba]: 32 layers of Mamba1 mixers (dt/B/C norms) and,
at ``i % 8 == 4``, GQA attention without positional encoding; a SwiGLU MLP
at even layers and 16 routed experts, top-2, at odd ones.
[https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/config.json]

``CONFIG`` is one chip's share of a deployment that splits each expert
layer's 16 experts over 2 chips (expert parallel 2) and replicates the rest:
the router keeps its 16 outputs and its top-2, and this chip holds experts
``[first_expert, first_expert + n_experts)`` = [0, 8).  Every width is the
published one.  ``REDUCED`` is its twin at the CPU tests' widths, one whole
period of 8 layers, the same 16-way router and 8 held experts.

Jamba's fields live on :class:`JambaConfig`, so ``ModelConfig``'s stay the
JAX package's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class JambaConfig(ModelConfig):
    attn_layer_period: int = 8
    attn_layer_offset: int = 4
    expert_layer_period: int = 2
    expert_layer_offset: int = 1
    n_router_experts: int = 16      # the router's outputs, all experts
    first_expert: int = 0           # the first expert held here

    def is_attn_layer(self, i: int) -> bool:
        return i % self.attn_layer_period == self.attn_layer_offset

    def is_moe_layer(self, i: int) -> bool:
        return i % self.expert_layer_period == self.expert_layer_offset

    def param_count(self) -> int:
        """Parameters held on this chip (the held experts only)."""
        d, hd, st = self.d_model, self.head_dim, self.ssm_state
        total = 2 * self.vocab_size * d + d
        for i in range(self.n_layers):
            total += 2 * d
            if self.is_attn_layer(i):
                total += 2 * d * (self.n_heads + self.n_kv_heads) * hd
            else:
                # Mamba1 and its dt, B and C norms
                total += self._mamba1_params() + self.dt_rank + 2 * st
            if self.is_moe_layer(i):
                total += d * self.n_router_experts \
                    + self.n_experts * 3 * d * self.d_ff
            else:
                total += 3 * d * self.d_ff
        return total


CONFIG = JambaConfig(
    name="jamba2-mini", family="jamba",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128, norm_eps=1e-6, tie_embeddings=False,
    n_experts=8, top_k=2,
    ssm_state=16, ssm_version=1, ssm_expand=2, ssm_conv=4,
)

REDUCED = dataclasses.replace(
    CONFIG, name="jamba2-mini-reduced", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, dtype="float32")
