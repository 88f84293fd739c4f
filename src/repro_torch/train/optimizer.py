"""AdamW + cosine schedule + global-norm clipping over dicts of tensors, in
the JAX package's arithmetic (``src/repro/train/optimizer.py``).

Not ``torch.optim.AdamW``: that one shrinks ``p`` by ``1 - lr * wd`` apart
from the Adam step, and keeps bf16 moments for bf16 parameters.  Here, as in
the reference: moments are f32 whatever the parameter dtype; ``count + 1``
comes before the schedule; the clip scale multiplies the f32 gradient;
``step + wd * p`` comes before ``lr``; the result is cast back to the
parameter's dtype.  Parameters and moments are updated in place (the JAX
function returns new trees), which keeps one copy of each on the card.

Weight decay applies where the JAX package applies it: to every leaf of
``ndim >= 2`` in the JAX layout.  The JAX transformer stacks its layers,
so its per-layer norms are 2-D leaves and decay; the port keeps them 1-D,
so a caller that trains a model passes ``decay``, the names whose JAX leaf
is a matrix (``models.convert.decayed_names``).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), f32, on the
    step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    mn = cfg.peak_lr * cfg.min_lr_ratio
    cos = mn + 0.5 * (cfg.peak_lr - mn) * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict) -> dict:
    """f32 zero moments under the parameters' names, and an int32 count on
    the parameters' device."""
    first = next(iter(params.values()))
    return {
        "mu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
        "nu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    sq = sum(torch.linalg.vector_norm(g, dtype=torch.float32).square()
             for g in tensors)
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict,
                 cfg: OptimizerConfig, decay=None, gnorm=None):
    """One AdamW step, in place on ``params`` and ``opt_state``.  ``decay``:
    the names that take weight decay (default: the tensors of ``ndim >=
    2``, the reference's rule on its own layout).  ``gnorm``: the norm to
    clip by, where ``grads`` is one rank's shard of a larger tree (default:
    ``grads``' own).  Returns ``(params, opt_state, metrics)`` with ``lr``
    and ``grad_norm`` as 0-d tensors."""
    count = opt_state["count"] + 1
    lr = cosine_schedule(cfg, count)
    if gnorm is None:
        gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    c = count.to(torch.float32)
    bc1, bc2 = 1 - cfg.b1 ** c, 1 - cfg.b2 ** c
    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        mu, nu = opt_state["mu"][name], opt_state["nu"][name]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        step = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(cfg.eps))
        if (p.ndim >= 2) if decay is None else (name in decay):
            step.add_(cfg.weight_decay * p.to(torch.float32))
        if p.dtype == torch.float32:
            p.sub_(lr * step)
        else:
            p.copy_(p.to(torch.float32) - lr * step)
    opt_state["count"] = count
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
