"""Continuous-batching serving: a slotted cache that never drains (a dense
model's KV cache, or a Mamba model's conv windows and states).

The static engine (``repro_torch.serve.engine.ServeEngine``) runs prefill +
decode per prompt-length group: the decode batch starts full, bleeds slots
as short requests finish, and fully drains before the next group is
admitted.  This engine keeps ONE decode batch alive for the lifetime of the
server:

* the KV cache is allocated once for ``max_batch`` *slots* over a shared
  ``max_seq`` sequence budget;
* a finished sequence frees its slot immediately;
* a queued request is admitted into a free slot *between decode steps* — its
  prompt is prefilled into a single-slot cache and copied into the shared
  cache at the slot index — so the running batch is re-filled mid-decode and
  the decode loop never restarts from an empty batch.

The cache layout is probed, not assumed: :func:`cache_batch_axes` runs
``prefill`` on the model's ``meta`` twin (shapes only: no FLOPs, no
allocation, and the plain attention path, never the kernel) at two batch
sizes and takes the one axis of each cache leaf whose size tracks the batch
size.  Admission is then a copy into ``narrow(axis, slot, 1)`` of each leaf.

``decode_step`` updates the shared cache IN PLACE (the JAX engine's caches
are immutable and replaced each step).  So an :class:`Admission` owns a
fresh single-slot cache from its own prefill and never aliases the shared
one, and a free slot's dummy write at position 0 touches only that slot's
row, which the next admission's copy overwrites wholesale.

Per-slot correctness mirrors the static engine exactly: each slot keeps its
own write position, and ``decode_step`` masks attention per element by
``positions + 1`` — so a request's token stream equals ``greedy_reference``
regardless of what the neighbouring slots are doing
(``tests/test_torch_serve.py``).

On a CUDA device, a family whose ``decode_step`` is declared capturable
(``ModelApi.decode_graph``: the Mamba1 family) has its step captured in
``__init__`` as one CUDA graph at ``max_batch`` (:class:`DecodeGraph`): the
slot cache is the graph's state, and each round copies its token ids and
positions into the graph's input buffer and replays it, instead of issuing
the step's thousands of ops one at a time from Python under the
interpreter lock that the prefill thread shares.  The graph runs the same
ops in the same dtypes as the eager step.  Other families, and every
engine on the CPU, run the step eagerly.

Observability: counters (``serve_admitted`` / ``serve_completed`` /
``serve_evicted`` / ``serve_decode_steps`` / ``serve_prefill_tokens``,
``serve_admit_wait_us``, the µs admissions waited between their prefill's
end and their ``insert``, and ``serve_decode_graph_replays``, the rounds
the graph ran, and ``serve_moe_pairs_held``, the (token, expert) pairs a
dropless expert layer's prefills routed to the experts it holds, counted on
the device and read back with the first token) and gauges
(``serve_queue_depth`` / ``serve_slots_active``) live in a
:class:`repro_torch.obs.MetricsRegistry`;
``ServeDriver`` surfaces snapshots as ``telemetry`` TraceEvents and feeds
the autoscaler from them.  Inside a task, the thread's flight recorder
(``obs.spans``) records ``prefill_issue`` and ``prefill_sync`` (attribute
``req``, the request's uid) and each round's ``decode_issue`` and
``decode_sync`` (attribute ``slots``, the active slots): host time issuing
the work, and host time blocked in the readback that ends it.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from time import perf_counter
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.models.attention import AttnMode
from repro_torch.models.moe import held_pairs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spans import current_recorder
from repro_torch.serve.engine import (Request, model_device,
                                      modal_dummy_inputs, prompt_prefix_len,
                                      tokens_tensor)


@torch.inference_mode()
def cache_batch_axes(cfg: ModelConfig, params, max_seq: int):
    """Locate the batch axis of every prefill-cache leaf.

    Probes ``prefill`` on ``params.meta_twin()`` at batch sizes 2 and 3:
    only the batch dimension depends on the batch size, so exactly one axis
    per leaf may differ.  Returns ``(axes, cache_spec)``: the axis of each
    leaf, and the batch-2 ``meta`` cache, whose shapes and dtypes (the ones
    ``prefill`` produces) the slot cache takes.
    """
    api = registry.get_model(cfg)
    meta = params.meta_twin()

    def probe(b):
        batch = {"tokens": torch.zeros((b, 1), dtype=torch.int64,
                                       device="meta"),
                 **modal_dummy_inputs(cfg, b, "meta")}
        cache, _ = api.prefill(meta, cfg, batch, max_seq, AttnMode())
        return cache

    c2, c3 = probe(2), probe(3)

    def axis(a, b):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                 if x != y]
        if len(diffs) != 1:
            raise ValueError(
                f"cannot locate batch axis: shapes {tuple(a.shape)} vs "
                f"{tuple(b.shape)} differ in {len(diffs)} axes (family "
                f"{cfg.family!r})")
        return diffs[0]

    return {name: axis(c2[name], c3[name]) for name in c2}, c2


@dataclasses.dataclass
class _Slot:
    """One active sequence: its request, write position, and progress."""
    req: Request
    position: int       # next KV write index (prefix + prompt_len + decoded)
    next_tok: int       # last generated token = next decode input
    generated: list     # tokens generated so far (next_tok included)

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - len(self.generated)


@dataclasses.dataclass
class Admission:
    """A prefilled request ready to be inserted into a slot: the single-slot
    cache plus the first generated token (from the prefill logits).  Pure
    output of :meth:`ContinuousEngine.prefill_request` — computing one does
    not touch the shared cache, so prefill work can run concurrently with
    decode rounds (the ServeDriver's task split)."""
    req: Request
    cache: Optional[dict]   # prefill cache, batch size 1, owned by this
    #                         record until ``insert`` copies it (then None)
    first_tok: int
    ready: float = dataclasses.field(default_factory=perf_counter)
    # perf_counter when the prefill ended (the record's construction)


class DecodeGraph:
    """One ``decode_step`` over all ``max_batch`` slots of ``engine``'s cache,
    captured as a CUDA graph, and the argmax of its logits.

    The engine's slot cache is captured as it is: every replay reads and
    writes those tensors in place, so ``insert``'s copies into a slot,
    issued on the same stream, are ordered against the replays.  The token
    ids and positions go in through one static (2, max_batch) device buffer,
    filled by one copy from pinned host memory; the next token ids come out
    in a static (max_batch,) int64 tensor.  The step runs eagerly once on a
    side stream before the capture, as capture requires (cuBLAS handles,
    workspaces): its writes land in free slots, which the next admission's
    copy overwrites."""

    def __init__(self, engine: "ContinuousEngine"):
        b, dev = engine.max_batch, engine.device
        self._host = torch.zeros((2, b), dtype=torch.int64).pin_memory()
        self._staged = self._host.numpy()
        self._inputs = torch.zeros((2, b), dtype=torch.int64, device=dev)
        batch = {"tokens": self._inputs[0].view(b, 1),
                 "positions": self._inputs[1]}

        def step():
            logits, _ = engine.api.decode_step(engine.params, engine.cfg,
                                               batch, engine.cache)
            return logits.argmax(-1)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        # thread_local: a CUDA call that another thread makes meanwhile does
        # not invalidate the capture
        with torch.cuda.graph(self._graph, capture_error_mode="thread_local"):
            self.next_ids = step()

    def replay(self, toks: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """Issue one step for ``toks`` (max_batch, 1) at ``pos``
        (max_batch,); returns the device tensor that will hold the next
        token ids.  The pinned buffer is rewritten only after the caller
        has read the previous round's ids back, which waits for its copy."""
        self._staged[0] = toks[:, 0]
        self._staged[1] = pos
        self._inputs.copy_(self._host, non_blocking=True)
        self._graph.replay()
        return self.next_ids


class ContinuousEngine:
    """Continuous-batching greedy generation over a slotted KV cache.

    Shared-state methods (``insert``, ``decode_round``, ``step``, ``run``)
    must be called from one control thread at a time; ``submit`` and
    ``prefill_request`` touch only the queue / their own tensors.
    """

    @torch.inference_mode()
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_seq: int = 256,
                 metrics: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.params = params
        self.api = registry.get_model(cfg)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.device = model_device(params)
        self._prefix = prompt_prefix_len(cfg)
        self._axes, spec = cache_batch_axes(cfg, params, max_seq)
        # the shared slot cache: prefill's own layout/dtypes, batch axis
        # widened to max_batch slots
        self.cache = {
            name: torch.zeros(s.shape[:ax] + (max_batch,) + s.shape[ax + 1:],
                              dtype=s.dtype, device=self.device)
            for (name, s), ax in zip(spec.items(), self._axes.values())}
        self.slots: list[Optional[_Slot]] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self.results: dict[int, np.ndarray] = {}
        self.evicted: list[int] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.gauge("serve_queue_depth", lambda: len(self.queue))
        self.metrics.gauge("serve_slots_active", lambda: self.slots_active)
        self.graph = DecodeGraph(self) if (
            self.device.type == "cuda" and self.api.decode_graph) else None

    # -- introspection -----------------------------------------------------
    @property
    def slots_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def outstanding(self) -> int:
        """Requests admitted or queued but not yet finished."""
        return self.queue_depth + self.slots_active

    # -- request intake ----------------------------------------------------
    def submit(self, requests: Request | Sequence[Request]):
        """Enqueue requests.  A request that cannot fit the sequence budget
        (``prefix + prompt + max_new_tokens > max_seq`` — its decode writes
        would run off the end of the cache) is EVICTED at admission control:
        its uid lands in ``self.evicted`` and the ``serve_evicted`` counter,
        never in the queue."""
        if isinstance(requests, Request):
            requests = [requests]
        for r in requests:
            if self._prefix + len(r.prompt) + r.max_new_tokens > self.max_seq:
                self.evicted.append(r.uid)
                self.metrics.inc("serve_evicted")
                continue
            self.queue.append(r)

    # -- admission ---------------------------------------------------------
    @torch.inference_mode()
    def prefill_request(self, req: Request) -> Admission:
        """Prefill one request into a fresh single-slot cache (pure w.r.t.
        the shared cache).  The prefill logits yield the first generated
        token, exactly like the static engine."""
        rec = current_recorder()
        with rec.span("prefill_issue", req=req.uid), held_pairs() as held:
            batch = {"tokens": tokens_tensor(req.prompt[None], self.device),
                     **modal_dummy_inputs(self.cfg, 1, self.device)}
            cache, logits = self.api.prefill(self.params, self.cfg, batch,
                                             self.max_seq, AttnMode())
            self.metrics.inc("serve_prefill_tokens", len(req.prompt))
        with rec.span("prefill_sync", req=req.uid):
            if held.total is not None:
                # the held pairs come back in the first token's readback
                first, pairs = torch.stack(
                    [logits[0].argmax(), held.total]).tolist()
                self.metrics.inc("serve_moe_pairs_held", pairs)
            else:
                first = int(logits[0].argmax())
        return Admission(req=req, cache=cache, first_tok=first)

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @torch.inference_mode()
    def insert(self, adm: Admission) -> Optional[int]:
        """Copy an admission into a free slot (mutates the shared cache)
        and drop its single-slot cache (``adm.cache`` is None after).
        Returns the slot index, or None when the request completed at
        admission (``max_new_tokens == 1``: the prefill logits were the
        whole generation, no slot needed)."""
        self.metrics.inc("serve_admitted")
        self.metrics.inc("serve_admit_wait_us",
                         int((perf_counter() - adm.ready) * 1e6))
        if adm.req.max_new_tokens <= 1:
            adm.cache = None
            self._finish(adm.req, [adm.first_tok])
            return None
        free = self.free_slots()
        if not free:
            raise RuntimeError("insert() with no free slot")
        slot = free[0]
        for name, ax in self._axes.items():
            self.cache[name].narrow(ax, slot, 1).copy_(adm.cache[name])
        # copied (in stream order, before any later use of the memory)
        adm.cache = None
        self.slots[slot] = _Slot(
            req=adm.req,
            position=self._prefix + len(adm.req.prompt),
            next_tok=adm.first_tok, generated=[adm.first_tok])
        return slot

    def _admit_from_queue(self) -> int:
        """Admit queued requests into free slots (inline prefill+insert)."""
        n = 0
        while self.queue and (self.free_slots() or
                              self.queue[0].max_new_tokens <= 1):
            self.insert(self.prefill_request(self.queue.popleft()))
            n += 1
        return n

    # -- decode ------------------------------------------------------------
    @torch.inference_mode()
    def decode_round(self) -> list[Request]:
        """One decode step over ALL slots.  Active slots consume their last
        generated token at their own position; free slots decode a dummy
        token 0 at position 0 whose cache writes are dead (overwritten by
        the next admission's full-slot copy).  Returns the requests that
        finished this round (their slots are already free)."""
        active = self.slots_active
        if active == 0:
            return []
        rec = current_recorder()
        with rec.span("decode_issue", slots=active):
            toks = np.zeros((self.max_batch, 1), np.int64)
            pos = np.zeros((self.max_batch,), np.int64)
            for i, s in enumerate(self.slots):
                if s is not None:
                    toks[i, 0] = s.next_tok
                    pos[i] = s.position
            if self.graph is None:
                logits, self.cache = self.api.decode_step(
                    self.params, self.cfg,
                    {"tokens": tokens_tensor(toks, self.device),
                     "positions": tokens_tensor(pos, self.device)},
                    self.cache)
            else:
                ids = self.graph.replay(toks, pos)
                self.metrics.inc("serve_decode_graph_replays")
        with rec.span("decode_sync", slots=active):
            if self.graph is None:
                ids = logits.argmax(-1)
            nxt = ids.cpu().numpy()
        self.metrics.inc("serve_decode_steps")
        finished = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.position += 1
            s.next_tok = int(nxt[i])
            s.generated.append(s.next_tok)
            if s.remaining == 0:
                self._finish(s.req, s.generated)
                self.slots[i] = None
                finished.append(s.req)
        return finished

    def decode_rounds(self, max_rounds: int) -> list[Request]:
        """Up to ``max_rounds`` decode steps, stopping early the moment any
        slot finishes — freed capacity should go back to admission, not to
        more rounds of a smaller batch.  The ServeDriver's decode-task
        payload."""
        for _ in range(max_rounds):
            finished = self.decode_round()
            if finished or self.slots_active == 0:
                return finished
        return []

    def _finish(self, req: Request, generated: list):
        self.results[req.uid] = np.asarray(
            generated[:req.max_new_tokens], np.int32)
        self.metrics.inc("serve_completed")

    # -- standalone loop ---------------------------------------------------
    def step(self) -> list[Request]:
        """One engine iteration: admit whatever fits, then one decode step.
        Admission happens BETWEEN decode steps — the continuous-batching
        invariant — so a request arriving mid-generation joins the running
        batch without draining it."""
        self._admit_from_queue()
        return self.decode_round()

    def run(self, requests: Sequence[Request]) -> dict:
        """Convenience: serve ``requests`` to completion; returns
        uid -> generated tokens (evicted uids excluded — see ``evicted``)."""
        self.submit(list(requests))
        while self.outstanding:
            self.step()
        return dict(self.results)
