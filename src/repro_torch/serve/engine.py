"""Serving engines.  This module holds the STATIC-batch baseline
(``ServeEngine``: requests grouped by prompt length, one prefill + decode
loop per group — the whole batch drains before the next group starts) plus
the pieces it shares with the continuous-batching engine
(``repro_torch.serve.continuous.ContinuousEngine``): the ``Request``
record, the modal dummy-input helper, and the ``greedy_reference`` oracle.

Both engines are payloads like any other: the runtime can schedule
generation as tasks on private rank sets next to ETL tasks
(``python -m repro_torch.serve_lm``, ``repro_torch.serve.driver``).  They
run on the device that holds the model's parameters, under
``torch.inference_mode`` (which is per thread, so each entry point enters
it itself).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.models.attention import AttnMode
from repro_torch.models.layers import torch_dtype


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int = 16
    uid: int = 0


def modal_dummy_inputs(cfg: ModelConfig, batch_size: int,
                       device=None) -> dict:
    """Zero-filled placeholder modal inputs for a ``batch_size`` batch: vlm
    prompts carry all-zero patch embeddings and audio prompts all-zero frame
    embeddings; text families carry none.  Shared by both engines and the
    oracle so the placeholders can never drift apart between them."""
    extras = {}
    if cfg.family == "vlm":
        extras["prefix_embeds"] = torch.zeros(
            (batch_size, cfg.n_patches, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device=device)
    if cfg.family == "audio":
        extras["frames"] = torch.zeros(
            (batch_size, cfg.n_encoder_frames, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device=device)
    return extras


def prompt_prefix_len(cfg: ModelConfig) -> int:
    """Positions a prompt's KV entries start AFTER: vlm patch embeddings are
    prepended to the token stream, so generation positions are offset by
    ``n_patches``; every other family starts at 0."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def model_device(params) -> torch.device:
    return next(params.parameters()).device


def tokens_tensor(rows, device) -> torch.Tensor:
    """Token ids (int64, as ``F.embedding`` takes them) on ``device``."""
    return torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(device)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_seq: int = 256):
        self.cfg = cfg
        self.params = params
        self.api = registry.get_model(cfg)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.device = model_device(params)

    def run_requests(self, requests: Sequence[Request]):
        """Static-batch generation; returns dict uid -> generated tokens.
        Requests are grouped by prompt length (causal prefill over padding
        would corrupt the cache), then chunked to max_batch."""
        out = {}
        by_len: dict[int, list] = {}
        for r in requests:
            by_len.setdefault(len(r.prompt), []).append(r)
        for _, group in sorted(by_len.items()):
            for i in range(0, len(group), self.max_batch):
                out.update(self._run_batch(group[i:i + self.max_batch]))
        return out

    @torch.inference_mode()
    def _run_batch(self, requests):
        cfg, dev = self.cfg, self.device
        b = len(requests)
        plen = len(requests[0].prompt)
        batch = {"tokens": tokens_tensor(np.stack([r.prompt for r in requests]),
                                         dev),
                 **modal_dummy_inputs(cfg, b, dev)}
        cache, logits = self.api.prefill(self.params, cfg, batch,
                                         self.max_seq, AttnMode())
        positions = torch.full((b,), prompt_prefix_len(cfg) + plen,
                               dtype=torch.int64, device=dev)
        max_new = max(r.max_new_tokens for r in requests)
        gen = torch.zeros((b, max_new), dtype=torch.int64, device=dev)
        next_tok = logits.argmax(-1)
        for t in range(max_new):
            gen[:, t] = next_tok
            db = {"tokens": next_tok[:, None], "positions": positions}
            logits, cache = self.api.decode_step(self.params, cfg, db, cache)
            next_tok = logits.argmax(-1)
            positions = positions + 1
        gen = gen.cpu().numpy().astype(np.int32)
        return {r.uid: gen[i, :r.max_new_tokens]
                for i, r in enumerate(requests)}


@torch.inference_mode()
def greedy_reference(cfg, params, prompt: np.ndarray, n_new: int):
    """Oracle: full forward re-run per generated token (tests)."""
    api = registry.get_model(cfg)
    dev = model_device(params)
    toks = list(map(int, prompt))
    for _ in range(n_new):
        batch = {"tokens": tokens_tensor([toks], dev),
                 **modal_dummy_inputs(cfg, 1, dev)}
        logits = api.forward(params, cfg, batch)
        toks.append(int(logits[0, -1].argmax()))
    return np.asarray(toks[len(prompt):], np.int32)
