"""Weights carried across from the JAX package.

The JAX transformer stores its layers stacked for ``lax.scan``: attention
leaves under ``blocks["attn"]`` with leading ``(n_super, period)`` axes,
MLP leaves under ``blocks["mlp"]`` with a leading ``(n_super,)`` axis
(``src/repro/models/transformer.py::init``).  The JAX SSM LM stacks its
Mamba1 layers under ``layers`` on a leading ``(n_layers,)`` axis
(``src/repro/models/ssm_lm.py::init``).  The port keeps every tensor's own
layout, so conversion unstacks those axes and copies.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import torch_dtype
from repro_torch.models.ssm_lm import MambaLM
from repro_torch.models.transformer import Transformer

# Mamba1 leaves that stay f32 in a bf16 model (``ssm.mamba1_init``)
F32_LEAVES = ("A_log", "D")


def params_from_jax(tree: dict, cfg, device=None, dtype=None):
    """``tree``: the JAX ``init`` params as nested dicts of numpy arrays
    under the JAX key paths.  Returns the port's model on ``device``, in
    ``dtype`` (default: the arrays' own dtype; ``A_log`` and ``D`` of a
    Mamba1 layer stay f32)."""
    dt = None if dtype is None else torch_dtype(dtype)

    def t(a, keep_f32=False) -> torch.Tensor:
        x = torch.from_numpy(np.array(a)).to(device)   # a writable copy
        return x if dt is None or keep_f32 else x.to(dt)

    embed = {k: t(a) for k, a in tree["embed"].items()}
    if cfg.family == "ssm":
        stack = tree["layers"]
        n = {np.shape(a)[0] for a in stack.values()}
        if n != {cfg.n_layers}:
            raise ValueError(f"Mamba1 stack of {sorted(n)} layers for "
                             f"{cfg.n_layers}")
        layers = [{k: t(a[i], k in F32_LEAVES) for k, a in stack.items()}
                  for i in range(cfg.n_layers)]
        return MambaLM(cfg, embed, t(tree["final_norm"]), layers)
    blocks = tree["blocks"]
    if set(blocks) != {"attn", "mlp"}:
        raise NotImplementedError(
            f"blocks {sorted(blocks)}: only the dense family's attn + mlp "
            f"stacks convert")
    n_super, period = np.shape(blocks["attn"]["wq"])[:2]
    if period != 1 or n_super != cfg.n_layers:
        raise ValueError(f"attention stack of shape ({n_super}, {period}) "
                         f"for {cfg.n_layers} dense layers")
    layers = [({k: t(a[i, 0]) for k, a in blocks["attn"].items()},
               {k: t(a[i]) for k, a in blocks["mlp"].items()})
              for i in range(n_super)]
    return Transformer(cfg, embed, t(tree["final_norm"]), layers)
