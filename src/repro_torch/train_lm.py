"""End-to-end driver: the ETL pipeline (distributed dataframe ops on logical
ranks of one device) feeds LM training, with checkpoints and resume — the
paper's 'data engineering + deep learning under one execution framework',
the twin of ``examples/train_lm.py``.

Presets:
  --preset ci    ~3M param model, 60 steps   (default)
  --preset full  ~100M param qwen3-style model, 300 steps

The ci preset takes another family's arch at the same widths (``--arch``:
a VLM's batches carry patch embeddings, an audio model's frame
embeddings, both drawn from the corpus's seed as the stub frontends' input;
falcon-mamba-7b trains through the ``ssm_scan`` kernel on the card).

    python -m repro_torch.train_lm [--preset full]      # on the card
    python -m repro_torch.train_lm --device cpu --synthetic --steps 20
    python -m repro_torch.train_lm --arch whisper-medium --synthetic

Resume after interruption: re-run with the same ``--ckpt`` directory.  The
checkpoints are in the JAX package's layout: ``examples/train_lm.py``
restores them, and this driver restores the JAX driver's (float32).

``train_task`` is the same training as a task payload of the runtime: it
checkpoints through ``comm.checkpoint`` and, when retried, resumes from
the step its failed attempt last saved.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np

from repro_torch.configs import ParallelConfig, get_config, reduced
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import build_communicator, logical_devices
from repro_torch.core.communicator import resolve_device
from repro_torch.models import make_concrete_batch
from repro_torch.models.registry import modal_shapes
from repro_torch.train.data import (SyntheticCorpus, etl_token_batches,
                                    make_events)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer

ETL_RANKS = 4               # logical ranks of the ETL stage on the device
ARCH = "qwen3-8b"


def model_for(preset: str, arch: str = ARCH
              ) -> tuple[ModelConfig, ShapeConfig, int]:
    if preset == "full":
        if arch != ARCH:
            raise ValueError(f"the full preset is qwen3-100m; {arch} takes "
                             f"the ci preset")
        # ~100M-param qwen3-family config (assigned arch, scaled depth/width)
        cfg = dataclasses.replace(
            get_config("qwen3-8b"), name="qwen3-100m", n_layers=12,
            d_model=640, n_heads=10, n_kv_heads=2, head_dim=64, d_ff=1792,
            vocab_size=32768, dtype="float32", remat=False)
        return cfg, ShapeConfig("t", "train", 256, 8), 300
    if preset != "ci":
        raise ValueError(f"preset {preset!r}: ci or full")
    cfg = dataclasses.replace(
        reduced(get_config(arch)), n_layers=4, d_model=128, d_ff=256,
        vocab_size=2048)
    return cfg, ShapeConfig("t", "train", 128, 8), 60


def with_modal_inputs(cfg, batches, seed: int = 0):
    """``batches`` (token batches) each with the stub frontend's input the
    family takes (``registry.modal_shapes``: a VLM's patch embeddings, an
    audio model's frames), drawn with numpy from ``seed``; the text
    families' batches pass as they are."""
    rng = np.random.default_rng(seed)
    for b in batches:
        shapes = modal_shapes(cfg, len(b["tokens"]))
        yield {**b, **make_concrete_batch(shapes, rng, cfg.vocab_size)}


def optimizer_for(steps: int) -> OptimizerConfig:
    return OptimizerConfig(peak_lr=3e-3, warmup_steps=max(steps // 10, 5),
                           total_steps=steps)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def etl_batches(cfg, shape, steps: int, comm) -> tuple[list, int]:
    """The ETL stage of ``examples/train_lm.py``: events cleaned by the
    dist filter -> join -> sort on ``comm``'s ranks, cut into batches, and
    cycled to ``steps`` batches if fewer came out."""
    need = steps * shape.global_batch * shape.seq_len
    events = make_events(max(next_pow2(need * 2), 1 << 15), cfg.vocab_size,
                         seed=0)
    doc_meta = {"doc_id": np.arange(256, dtype=np.int32),
                "weight": np.ones(256, np.float32)}
    etl = list(etl_token_batches(
        comm, events, doc_meta, batch=shape.global_batch, seq=shape.seq_len,
        capacity_per_rank=len(events["event_id"]) // comm.size * 2 + 64))
    return [etl[i % len(etl)] for i in range(steps)], len(etl)


def train_task(comm, preset: str = "ci", steps: int | None = None,
               ckpt_every: int = 5, fail_at: int | None = None,
               device=None, seed: int = 0) -> dict:
    """Train ``preset`` on the synthetic corpus as a runtime task, saving
    through ``comm.checkpoint`` every ``ckpt_every`` steps and resuming
    from its latest step.  ``fail_at``: the first attempt raises after that
    step (failure injection).  Returns the steps run and their losses."""
    ctx = comm.checkpoint
    cfg, shape, default_steps = model_for(preset)
    steps = steps or default_steps
    tr = Trainer(cfg, ParallelConfig(), shape, optimizer_for(steps),
                 ckpt_dir=ctx, ckpt_every=ckpt_every, seed=seed,
                 device=device)
    state = tr.maybe_restore() or tr.init_state()
    start = state.step
    corpus = SyntheticCorpus(cfg.vocab_size, seed)
    for _ in range(start):              # the data stream resumes too
        corpus.batch(shape.global_batch, shape.seq_len)

    def inject(step, _metrics):
        if step == fail_at and getattr(ctx, "attempt", "a0") == "a0":
            raise RuntimeError(f"injected failure after step {step}")

    state, losses = tr.fit(
        corpus.batches(shape.global_batch, shape.seq_len, steps - start),
        steps - start, state=state, log_every=0, on_metrics=inject)
    return {"start_step": start, "step": state.step, "losses": losses}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="ci", choices=["ci", "full"])
    ap.add_argument("--arch", default=ARCH,
                    help="the ci preset's arch (any ported family)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="skip the ETL stage and use the synthetic corpus")
    ap.add_argument("--device", default="cuda",
                    help="device of the model and of the ETL ranks")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg, shape, steps = model_for(args.preset, args.arch)
    steps = args.steps or steps
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{steps} steps of batch {shape.global_batch} x seq {shape.seq_len}"
          f" on {device}")

    # ---- stage 1: ETL on the runtime's dataframe ops ---------------------
    if args.synthetic:
        corpus = SyntheticCorpus(cfg.vocab_size)
        batches = corpus.batches(shape.global_batch, shape.seq_len, steps)
    else:
        comm = build_communicator(logical_devices(ETL_RANKS, device))
        batches, made = etl_batches(cfg, shape, steps, comm)
        print(f"[etl] produced {made} batches via join+sort pipeline on "
              f"{comm.size} ranks")

    batches = with_modal_inputs(cfg, batches)

    # ---- stage 2: training with checkpoint/restart ------------------------
    trainer = Trainer(cfg, ParallelConfig(), shape, optimizer_for(steps),
                      ckpt_dir=args.ckpt, ckpt_every=max(steps // 3, 10),
                      device=device)
    state = trainer.maybe_restore()
    if state:
        print(f"[resume] restored step {state.step} from {args.ckpt}")
    state, losses = trainer.fit(batches, steps=steps, state=state,
                                log_every=max(steps // 15, 1))
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) "
          f"at step {state.step}")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss did not decrease")


if __name__ == "__main__":
    main()
