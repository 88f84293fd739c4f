"""Weights carried across from the JAX package.

The JAX transformer stores its layers stacked for ``lax.scan``: attention
leaves under ``blocks["attn"]`` with leading ``(n_super, period)`` axes,
MLP leaves under ``blocks["mlp"]`` with a leading ``(n_super,)`` axis
(``src/repro/models/transformer.py::init``).  The port keeps every tensor's
own layout, so conversion unstacks those axes and copies.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Transformer, torch_dtype


def params_from_jax(tree: dict, cfg, device=None, dtype=None) -> Transformer:
    """``tree``: the JAX ``init`` params as nested dicts of numpy arrays
    under the JAX key paths.  Returns the port's model on ``device``, in
    ``dtype`` (default: the arrays' own dtype)."""
    dt = None if dtype is None else torch_dtype(dtype)

    def t(a) -> torch.Tensor:
        x = torch.from_numpy(np.array(a)).to(device)   # a writable copy
        return x if dt is None else x.to(dt)

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
    return Transformer(cfg, {k: t(a) for k, a in tree["embed"].items()},
                       t(tree["final_norm"]), layers)
