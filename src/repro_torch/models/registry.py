"""Uniform model API across families.

Every family exposes ``init(gen, cfg)`` / ``forward`` / ``loss_fn`` /
``prefill`` / ``decode_step`` / ``cache_init`` with dict batches, as in the
JAX package, so the serving engines treat every arch alike.  The port has
the dense family and the SSM family (Mamba1); the others raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import ssm_lm, transformer


class ModelApi(NamedTuple):
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    cache_init: Callable


_FAMILIES = {"dense": transformer, "ssm": ssm_lm}

# where each family not ported yet stands in ROADMAP.md ("Modules still to
# port")
_NOT_PORTED = {
    "moe": "item 8 (MoE: models/moe.py)",
    "hybrid": "item 8 (hybrid: models/hybrid.py)",
    "vlm": "item 8 (VLM: models/vlm.py)",
    "audio": "item 8 (audio: models/encdec.py)",
}


def get_model(cfg) -> ModelApi:
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        where = _NOT_PORTED.get(cfg.family, "item 8")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP modules {where})")
    return ModelApi(mod.init, mod.forward, mod.loss_fn, mod.prefill,
                    mod.decode_step, mod.cache_init)

