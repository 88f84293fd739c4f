"""The train step: loss, gradients and the AdamW update, as the JAX
package's ``distributed/steps.py::make_train_step`` builds it, on one
device (its shardings wait for ROADMAP modules item 11).

The step is a plain function of ``(model, opt_state, batch)``: the model's
parameters and the optimizer's moments are updated in place (the JAX step
donates its inputs and returns new trees), and the metrics are 0-d
tensors on the model's device, so the step does not wait for the device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.models import registry
from repro_torch.models.attention import AttnMode
from repro_torch.models.convert import decayed_names
from repro_torch.train import optimizer as opt_mod


def _attn_mode(cfg: ModelConfig, parallel: ParallelConfig,
               seq_len: int) -> AttnMode:
    """The attention path the JAX train step differentiates: full up to
    1024 tokens, blockwise with ``parallel.attn_block`` tiles beyond.  On
    the card the forward runs the kernel and its backward this path."""
    if seq_len <= 1024 and not cfg.unroll_scans:
        return AttnMode(kind="full")
    blk = parallel.attn_block
    return AttnMode(kind="blockwise", q_block=blk, kv_block=blk)


class StepBundle(NamedTuple):
    fn: Any                 # fn(model, opt_state, batch) -> same + metrics
    info: dict


def make_train_step(cfg: ModelConfig, parallel: ParallelConfig,
                    shape: ShapeConfig,
                    ocfg: opt_mod.OptimizerConfig | None = None):
    ocfg = ocfg or opt_mod.OptimizerConfig()
    api = registry.get_model(cfg)
    mode = _attn_mode(cfg, parallel, shape.seq_len)
    mb = parallel.microbatches

    def loss_and_grads(params: dict, model, batch):
        loss = api.loss_fn(model, cfg, batch, mode)
        return loss, torch.autograd.grad(loss, list(params.values()))

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if mb > 1:
            # (loss, grads) / mb summed in f32 over the microbatches, as
            # the JAX step's lax.scan accumulates them
            if any(v.shape[0] % mb for v in batch.values()):
                raise ValueError(f"batch of {len(batch['tokens'])} rows "
                                 f"does not split into {mb} microbatches")
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in params.values()]
            for micro in zip(*(torch.chunk(v, mb) for v in batch.values())):
                l, g = loss_and_grads(params, model,
                                      dict(zip(batch, micro)))
                loss = loss + l.detach() / mb
                for a, gi in zip(acc, g):
                    a.add_(gi / mb)
                del g
            grads = acc
        else:
            loss, grads = loss_and_grads(params, model, batch)
            loss = loss.detach()
        _, _, metrics = opt_mod.adamw_update(
            dict(zip(params, grads)), opt_state, params, ocfg,
            decay=decayed_names(params, cfg))
        return model, opt_state, {"loss": loss, **metrics}

    return StepBundle(train_step, {"mode": mode})
