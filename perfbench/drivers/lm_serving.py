"""A language model served through the port's serving tier: the serving
cells.

Set-up makes the weights on the card from the seed (the configuration's
plain reference, ``make_weights``), hands them to the port's model class
as they are, builds ``ContinuousEngine`` (``max_batch`` slots),
a ``SchedulerSession`` over a ``ThreadExecutor`` whose pool is the
configuration's logical ranks of the card, and ``ServeDriver`` over both.
It then serves one warm-up batch (``max_batch`` requests of the mix, the
shortest and the longest prompt among them; the first prefill builds the
``ssm_scan`` kernel with nvcc into the checkout).  Eager PyTorch compiles
nothing per shape, so no other length needs a warm-up.

The benchmark records, around the engine's own methods (wrapped on the
instance; nothing of the program is changed), when each request's prefill
ran and returned its first token (``prefill_request`` synchronises to read
it), and when each decode call ended and which requests it finished.

The window is a closed loop: ``clients`` clients each keep one request in
the system.  The first requests go into the engine's queue, and the driving
thread calls ``ServeDriver.run([r])`` with one more, which returns once a
request has finished; it then issues one replacement for each finished (or
evicted) request in the same way, until the window closes, and waits for
the tasks in flight.  A request is timed from when it was issued.

The comparison takes ``check.requests`` finished requests drawn from the
seed, the one with the longest prompt among them, and runs the plain
reference once over each prompt with the tokens served, in float32: the
widest gap by which a served token's logit lies below the reference's best
at its position must stay under ``check.logit_gap_limit``.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from yardstick import counts
from yardstick.devtrace import Spans
from yardstick.traffic import Requests, rng, subseed


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for the configuration file, each mapped
    field checked against the file."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch"])
    z = {"n_layers": cfg["num_hidden_layers"], "d_model": cfg["hidden_size"],
         "vocab_size": cfg["vocab_size"], "ssm_state": cfg["state_size"],
         "ssm_conv": cfg["conv_kernel"],
         "ssm_expand": cfg["intermediate_size"] // cfg["hidden_size"],
         "tie_embeddings": cfg["tie_word_embeddings"],
         "norm_eps": cfg["layer_norm_epsilon"], "dtype": cfg["torch_dtype"],
         "ssm_scan_dtype": cfg["scan_state_dtype"]}
    mc = dataclasses.replace(base, **z)
    if mc.d_inner != cfg["intermediate_size"] or \
            mc.dt_rank != cfg["time_step_rank"]:
        raise ValueError(f"the port derives d_inner {mc.d_inner} and dt rank "
                         f"{mc.dt_rank}; the configuration states "
                         f"{cfg['intermediate_size']} and "
                         f"{cfg['time_step_rank']}")
    return mc


def port_model(mc, weights: dict):
    """The port's model object over the benchmark's weights (views of the
    stacked tensors, no copy)."""
    from repro_torch.models.ssm_lm import MambaLM
    if mc.family != "ssm":
        raise NotImplementedError(f"no serving driver for {mc.family!r}")
    lay = weights["layers"]
    layers = [{k: v[i] for k, v in lay.items()} for i in range(mc.n_layers)]
    embed = {"embedding": weights["embedding"]}
    if "lm_head" in weights:
        embed["lm_head"] = weights["lm_head"]
    return MambaLM(mc, embed, weights["final_norm"], layers)


class Driver:
    def __init__(self, cell, seed: int, device: torch.device,
                 overrides: dict):
        self.cell = cell
        self.cfg = {**cell.config, **overrides.get("config", {})}
        self.traffic = {**cell.traffic, **overrides.get("traffic", {})}
        self.ref = cell.reference()
        self.seed = seed
        self.device = device
        self.spans = Spans()
        self.req: dict = {}          # uid -> record of the request
        self.prefills: list = []     # (uid, start, end, prompt_len)
        self.decodes: list = []      # (start, end, rounds, finished uids)
        self.attempted = self.failed = 0
        self._lock = threading.Lock()

    # -- set-up ------------------------------------------------------------
    def setup(self):
        from repro_torch.core.communicator import logical_devices
        from repro_torch.core.executors import ThreadExecutor
        from repro_torch.core.pilot import ResourceManager
        from repro_torch.core.scheduler import SchedulerSession
        from repro_torch.serve.continuous import ContinuousEngine
        from repro_torch.serve.driver import ServeDriver

        dep = self.cfg["deployment"]
        self.mc = port_config(self.cfg)
        self.weights = self.ref.make_weights(
            self.cfg, subseed(self.seed, "weights"), self.device)
        self.model = port_model(self.mc, self.weights)
        self.engine = ContinuousEngine(self.mc, self.model,
                                       max_batch=dep["max_batch"],
                                       max_seq=dep["max_seq"])
        self._wrap(self.engine)
        self.session = SchedulerSession(
            ThreadExecutor(),
            ResourceManager(logical_devices(dep["ranks"], self.device)),
            ckpt_root="", result_cache="0")
        self.server = ServeDriver(self.engine, self.session,
                                  prefill_ranks=dep["prefill_ranks"],
                                  decode_ranks=dep["decode_ranks"],
                                  decode_chunk=dep["decode_chunk"])
        self.vocab = self.cfg["vocab_size"]
        warm = Requests(self.traffic, self.seed, self.vocab, "warmup")
        specs = [warm.next() for _ in range(dep["max_batch"])]
        g = rng(self.seed, "warmup-lengths")
        for spec, n in zip(specs, (self.traffic["prompt"]["min"],
                                   self.traffic["prompt"]["max"]),
                           strict=False):
            spec.prompt = g.integers(0, self.vocab, n, dtype=np.int32)
        self.server.run([self._request(s, -1 - i, time.perf_counter())
                         for i, s in enumerate(specs)], timeout=600)
        self.session.drain(timeout=600)     # set-up ends with the program idle
        self.req.clear()
        self.prefills.clear()
        self.decodes.clear()
        self.spans = Spans()
        self.session.trace.clear()
        self._warm_tasks = len(self.session.tasks)

    def _request(self, spec, uid: int, due: float):
        from repro_torch.serve.engine import Request
        self.req[uid] = {"due": due, "prompt": spec.prompt,
                         "answer": spec.answer_len}
        return Request(prompt=spec.prompt, max_new_tokens=spec.answer_len,
                       uid=uid)

    def _wrap(self, eng):
        prefill, decode = eng.prefill_request, eng.decode_rounds
        steps = eng.metrics

        def prefill_request(req):
            s, sn = time.perf_counter(), time.time_ns()
            adm = prefill(req)
            e, en = time.perf_counter(), time.time_ns()
            self.spans.add("prefill", sn, en, uid=req.uid,
                           prompt=len(req.prompt))
            with self._lock:
                self.prefills.append((req.uid, s, e, len(req.prompt)))
                rec = self.req.get(req.uid)
                if rec is not None:
                    rec["first"] = e
            return adm

        def decode_rounds(n):
            s, sn = time.perf_counter(), time.time_ns()
            before = steps.get("serve_decode_steps")
            finished = decode(n)
            e, en = time.perf_counter(), time.time_ns()
            rounds = steps.get("serve_decode_steps") - before
            self.spans.add("decode", sn, en, rounds=rounds)
            with self._lock:
                self.decodes.append((s, e, rounds,
                                     [r.uid for r in finished]))
                for r in finished:
                    if r.uid in self.req:
                        self.req[r.uid]["done"] = e
            return finished

        eng.prefill_request = prefill_request
        eng.decode_rounds = decode_rounds

    # -- the window ----------------------------------------------------------
    def run(self, seconds: float, clock):
        self.stream = Requests(self.traffic, self.seed, self.vocab)
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + seconds
        clock.open(time.time_ns())
        self._closed(clock)
        self.report = self.session.close()
        issued = [u for u, r in self.req.items() if r["due"] < self.t_end]
        self.attempted = len(issued)
        self.failed = sum(1 for u in issued
                          if u in self.engine.evicted) + sum(
            1 for t in self.report.tasks[self._warm_tasks:]
            if t.state.name == "FAILED")

    def _closed(self, clock):
        eng, n = self.engine, int(self.traffic["clients"])
        out = set()

        def issue():
            spec = self.stream.next()
            out.add(spec.index)
            return self._request(spec, spec.index, time.perf_counter())

        first = [issue() for _ in range(n)]
        eng.submit(first[:-1])
        self._serve([first[-1]])
        while time.perf_counter() < self.t_end:
            clock.tick()
            # ``ServeDriver.run`` returned once a request finished or was
            # evicted, so each turn issues at least one replacement
            evicted = set(eng.evicted)
            done = [u for u in out if u in eng.results or u in evicted]
            out.difference_update(done)
            more = [issue() for _ in done]
            eng.submit(more[:-1])
            self._serve(more[-1:])
        self.session.drain(timeout=600)

    def _serve(self, requests):
        t0n = time.time_ns()
        self.server.run(requests, timeout=600)
        self.spans.add("ServeDriver.run", t0n, time.time_ns())

    def release(self):
        self.results = dict(self.engine.results)
        self.tasks = self.report.tasks[self._warm_tasks:]
        for t in self.report.tasks:
            t.result = None          # a prefill task's admissions hold caches
        self.engine = self.server = self.session = self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------------
    def sample(self) -> list:
        """The finished requests compared: drawn from the seed, and the
        one with the longest prompt among all finished ones."""
        done = sorted(u for u in self.results if u >= 0)
        if not done:
            return []
        k = min(int(self.cfg["check"]["requests"]), len(done))
        longest = max(done, key=lambda u: len(self.req[u]["prompt"]))
        g = rng(self.seed, "sample")
        pick = set(int(u) for u in g.choice(done, k, replace=False))
        if longest not in pick:
            pick.discard(max(pick))
            pick.add(longest)
        return sorted(pick)

    def check(self) -> list:
        uids = self.sample()
        self.compared = uids
        if not uids:
            return [("nothing_compared", 1, 0)]
        prompts = [self.req[u]["prompt"] for u in uids]
        served = [self.results[u] for u in uids]
        short = sum(1 for u, s in zip(uids, served, strict=True)
                    if len(s) != self.req[u]["answer"])
        gaps = self.ref.served_gaps(self.weights, self.cfg, prompts, served)
        widest = float(max(g.max() for g in gaps))
        self.served_tokens_compared = int(sum(len(s) for s in served))
        return [("logit_gap", widest, self.cfg["check"]["logit_gap_limit"]),
                ("answers_cut_short", short, 0)]

    # -- metrics ----------------------------------------------------------------
    def finished_in_window(self) -> list:
        return [r for u, r in self.req.items()
                if u >= 0 and "done" in r and self.t0 <= r["due"]
                and r["done"] <= self.t_end]

    def end_to_end(self) -> dict:
        out = {}
        done = self.finished_in_window()
        out["served_tokens_per_s"] = sum(
            len(r["prompt"]) + r["answer"] for r in done) / (
            self.t_end - self.t0)
        return out

    def context(self) -> dict:
        return {"kind": "serving", "cfg": self.cfg, "traffic": self.traffic,
                "t0": self.t0, "t_end": self.t_end, "requests": self.req,
                "prefills": self.prefills, "decodes": self.decodes,
                "tasks": self.tasks, "trace": self.report.trace, "spans": self.spans,
                "counts": counts,
                "finished_in_window": self.finished_in_window()}
