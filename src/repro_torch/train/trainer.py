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

Given ``mesh`` (a ``Communicator`` with ``data``/``model`` axes,
``launch/mesh.py::make_local_mesh``), the trainer holds its state as the
sharded step's per-rank blocks (``distributed/steps.py``): ``init_state``
draws the parameters and shards them, ``fit`` runs the sharded step, a
save unshards into the JAX layout (on the host), and ``maybe_restore``
shards the checkpoint onto this trainer's own mesh, whatever mesh wrote
it.  A one-rank mesh is the one-device trainer on that rank's device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core.communicator import resolve_device, torch_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.steps import make_train_step, shard_model
from repro_torch.models import registry
from repro_torch.models.convert import (jax_tree, named_from_jax,
                                        params_from_jax)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod


@dataclasses.dataclass
class TrainState:
    # one device: the model, its parameters trainable; on a mesh: one dict
    # a rank, JAX-layout path -> that rank's block
    params: object
    # adamw_init's: mu, nu (by parameter name), count; on a mesh: one a
    # rank, over its blocks
    opt_state: object
    step: int = 0


def _named(state: TrainState) -> dict:
    return dict(state.params.named_parameters())


class Trainer:
    def __init__(self, cfg: ModelConfig, parallel: ParallelConfig,
                 shape: ShapeConfig,
                 ocfg: Optional[opt_mod.OptimizerConfig] = None,
                 ckpt_dir=None, ckpt_every: int = 0, seed: int = 0,
                 device=None, mesh=None):
        self.cfg = cfg
        self.parallel = parallel
        self.shape = shape
        self.ocfg = ocfg or opt_mod.OptimizerConfig()
        self.ckpt_dir = ckpt_dir      # a directory or a CheckpointContext
        self.ckpt_every = ckpt_every
        if mesh is not None:
            first = torch_device(mesh.devices[0])
            if device is not None and resolve_device(device) != first:
                raise ValueError(f"device {device} beside a mesh on {first}")
            device = first
        self.device = resolve_device(device)
        # a one-rank mesh runs the one-device step
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.bundle = make_train_step(cfg, parallel, shape, self.ocfg,
                                      mesh=self.mesh)
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
        on (a model built by ``params_from_jax`` serves frozen); on a mesh,
        the model's parameters sharded, and the model left to the
        caller."""
        if self.mesh is not None:
            return self._sharded_state(
                shard_model(model, self.bundle.info, self.mesh), step)
        model.requires_grad_(True)
        return TrainState(params=model,
                          opt_state=opt_mod.adamw_init(dict(
                              model.named_parameters())), step=step)

    def state_from_jax(self, tree: dict) -> TrainState:
        """A step-0 state from the JAX package's ``init`` params (nested
        numpy arrays), on this trainer's device or mesh."""
        if self.mesh is not None:
            flat = {k: a.detach().to(self.device)
                    if isinstance(a, torch.Tensor) else
                    ckpt.tensor_from_host(a, device=self.device)
                    for k, a in sh.flat_paths(tree).items()}
            return self._sharded_state(sh.shard_tree(
                flat, self.bundle.info["pspecs"], self.mesh))
        return self.state_from_model(
            params_from_jax(tree, self.cfg, self.device))

    @staticmethod
    def _sharded_state(params: list, step: int = 0) -> TrainState:
        """Per-rank blocks with a fresh AdamW state a rank: f32 zero
        moments and a count on the rank's device."""
        return TrainState(params=params, step=step, opt_state=[
            opt_mod.adamw_init(p) for p in params])

    def _unshard(self, ranks: list) -> dict:
        """Whole host tensors from per-rank blocks, each leaf assembled on
        the trainer's device and copied to the host in one piece."""
        specs = self.bundle.info["pspecs"]
        return sh.nest_paths({
            path: sh.unshard([r[path] for r in ranks], spec, self.mesh,
                             self.device, name=path).cpu()
            for path, spec in specs.items()})

    def state_tree(self, state: TrainState) -> dict:
        """The checkpoint tree in the JAX layout: ``params`` and ``opt``
        (``mu``, ``nu``, ``count``), per-layer tensors stacked; on a mesh,
        the blocks unsharded into host tensors."""
        if self.mesh is not None:
            o = state.opt_state
            return {"params": self._unshard(state.params),
                    "opt": {"mu": self._unshard([r["mu"] for r in o]),
                            "nu": self._unshard([r["nu"] for r in o]),
                            "count": o[0]["count"].to("cpu")}}
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

    def _restore(self, step: int, like, **kw):
        if self._context():
            return self.ckpt_dir.restore(step, like, **kw)
        return ckpt.restore(self.ckpt_dir, step, like, **kw)

    def _restore_sharded(self, step: int) -> TrainState:
        """Each leaf loaded whole and sharded onto this trainer's mesh by
        its spec; the count replicated."""
        params = registry.eval_params_shape(self.cfg)
        moments = sh.nest_paths({
            k: torch.empty(v.shape, dtype=torch.float32, device="meta")
            for k, v in sh.flat_paths(params).items()})
        pspecs = sh.nest_paths(self.bundle.info["pspecs"])
        like = {"params": params,
                "opt": {"mu": moments, "nu": moments,
                        "count": torch.empty((), dtype=torch.int32,
                                             device="meta")}}
        specs = {"params": pspecs, "opt": sh.opt_specs(None, pspecs)}
        tree = self._restore(step, like, mesh=self.mesh, specs=specs)

        def ranks(sub):
            flat = sh.flat_paths(sub)
            return [{k: v[r] for k, v in flat.items()}
                    for r in range(self.mesh.size)]
        mu, nu = ranks(tree["opt"]["mu"]), ranks(tree["opt"]["nu"])
        return TrainState(
            params=ranks(tree["params"]),
            opt_state=[{"mu": m, "nu": n, "count": c} for m, n, c in
                       zip(mu, nu, tree["opt"]["count"])], step=step)

    def maybe_restore(self) -> Optional[TrainState]:
        if not self.ckpt_dir:
            return None
        step = self._latest()
        if step is None:
            return None
        if self.mesh is not None:
            return self._restore_sharded(step)
        state = self.init_state()
        like = self.state_tree(TrainState(
            params=state.params.meta_twin(),
            opt_state={k: ({n: t.to("meta") for n, t in v.items()}
                           if isinstance(v, dict) else v.to("meta"))
                       for k, v in state.opt_state.items()}))
        self.load_tree(state, self._restore(step, like, device=self.device))
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
