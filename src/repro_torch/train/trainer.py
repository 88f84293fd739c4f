"""Training loop: step bundle + data + checkpointing + fault recovery, the
JAX package's ``src/repro/train/trainer.py`` on one device.

The trainer runs on ``device`` (the card unless the caller names another)
and checkpoints in the JAX package's layout — ``params`` and ``opt``
(``mu``, ``nu``, ``count``) with the layers stacked — so a checkpoint
written by either package's trainer restores in the other's.  Saves are
asynchronous every ``ckpt_every`` steps into ``ckpt_dir``; given a task's
``CheckpointContext`` (``comm.checkpoint``) in its place, the trainer
saves durably into the attempt's own directory and restores across the
task's attempts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core.communicator import resolve_device
from repro_torch.distributed.steps import make_train_step
from repro_torch.models import registry
from repro_torch.models.convert import (jax_tree, named_from_jax,
                                        params_from_jax)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod


@dataclasses.dataclass
class TrainState:
    params: object          # the model, its parameters trainable
    opt_state: dict         # adamw_init's: mu, nu (by parameter name), count
    step: int = 0


def _named(state: TrainState) -> dict:
    return dict(state.params.named_parameters())


class Trainer:
    def __init__(self, cfg: ModelConfig, parallel: ParallelConfig,
                 shape: ShapeConfig,
                 ocfg: Optional[opt_mod.OptimizerConfig] = None,
                 ckpt_dir=None, ckpt_every: int = 0, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.parallel = parallel
        self.shape = shape
        self.ocfg = ocfg or opt_mod.OptimizerConfig()
        self.ckpt_dir = ckpt_dir      # a directory or a CheckpointContext
        self.ckpt_every = ckpt_every
        self.device = resolve_device(device)
        self.bundle = make_train_step(cfg, parallel, shape, self.ocfg)
        self.api = registry.get_model(cfg)
        self._seed = seed

    # --- state ---------------------------------------------------------
    def init_state(self) -> TrainState:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._seed)
        return self.state_from_model(
            self.api.init(gen, self.cfg, trainable=True))

    def state_from_model(self, model, step: int = 0) -> TrainState:
        """A fresh optimizer state for ``model``, whose gradients this turns
        on (a model built by ``params_from_jax`` serves frozen)."""
        model.requires_grad_(True)
        return TrainState(params=model,
                          opt_state=opt_mod.adamw_init(dict(
                              model.named_parameters())), step=step)

    def state_from_jax(self, tree: dict) -> TrainState:
        """A step-0 state from the JAX package's ``init`` params (nested
        numpy arrays), on this trainer's device."""
        return self.state_from_model(
            params_from_jax(tree, self.cfg, self.device))

    def state_tree(self, state: TrainState) -> dict:
        """The checkpoint tree in the JAX layout: ``params`` and ``opt``
        (``mu``, ``nu``, ``count``), per-layer tensors stacked."""
        o = state.opt_state
        return {"params": jax_tree(_named(state), self.cfg),
                "opt": {"mu": jax_tree(o["mu"], self.cfg),
                        "nu": jax_tree(o["nu"], self.cfg),
                        "count": o["count"]}}

    @torch.no_grad()
    def load_tree(self, state: TrainState, tree: dict) -> TrainState:
        """Copy a checkpoint tree (the JAX layout) into ``state``."""
        o = state.opt_state
        for dst, src in ((_named(state), tree["params"]),
                         (o["mu"], tree["opt"]["mu"]),
                         (o["nu"], tree["opt"]["nu"])):
            by_name = named_from_jax(src, self.cfg)
            for k, t in dst.items():
                t.copy_(by_name[k])
        o["count"] = tree["opt"]["count"].to(self.device, torch.int32)
        return state

    # --- checkpoints -----------------------------------------------------
    def _context(self) -> bool:
        return isinstance(self.ckpt_dir, ckpt.CheckpointContext)

    def _latest(self) -> Optional[int]:
        if self._context():
            return self.ckpt_dir.latest()
        return ckpt.latest_step(self.ckpt_dir)

    def _save(self, step: int, tree):
        if self._context():
            return self.ckpt_dir.save(step, tree)       # durable
        return ckpt.save(self.ckpt_dir, step, tree)     # async

    def maybe_restore(self) -> Optional[TrainState]:
        if not self.ckpt_dir:
            return None
        step = self._latest()
        if step is None:
            return None
        state = self.init_state()
        like = self.state_tree(TrainState(
            params=state.params.meta_twin(),
            opt_state={k: ({n: t.to("meta") for n, t in v.items()}
                           if isinstance(v, dict) else v.to("meta"))
                       for k, v in state.opt_state.items()}))
        restore = self.ckpt_dir.restore if self._context() else \
            lambda s, lk, **kw: ckpt.restore(self.ckpt_dir, s, lk, **kw)
        self.load_tree(state, restore(step, like, device=self.device))
        state.step = step
        return state

    # --- loop ------------------------------------------------------------
    def fit(self, batches: Iterable[dict], steps: int,
            state: Optional[TrainState] = None,
            log_every: int = 10,
            on_metrics: Optional[Callable[[int, dict], None]] = None):
        state = state or self.init_state()
        losses = []
        pending_save = None
        t0 = time.monotonic()  # rate measurement must not jump under NTP
        for i, batch in enumerate(batches):
            if i >= steps:
                break
            tb = {k: torch.as_tensor(v).to(self.device)
                  for k, v in batch.items()}
            state.params, state.opt_state, metrics = self.bundle.fn(
                state.params, state.opt_state, tb)
            state.step += 1
            loss = float(metrics["loss"])
            losses.append(loss)
            if on_metrics:
                on_metrics(state.step,
                           {k: float(v) for k, v in metrics.items()})
            if log_every and state.step % log_every == 0:
                rate = state.step / max(time.monotonic() - t0, 1e-9)
                print(f"step {state.step:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  {rate:.2f} it/s",
                      flush=True)
            if self.ckpt_dir and self.ckpt_every and \
                    state.step % self.ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = self._save(state.step, self.state_tree(state))
        if pending_save is not None:
            pending_save.join()
        return state, losses
