"""AI21-Jamba2-Mini served through the port's serving tier: the cell
``jamba2-mini.longdoc``.

``lm_serving.Driver`` does the work: the closed loop, the comparison with
the plain reference and the end-to-end metric are its own.  This driver
builds the port's Jamba configuration (``repro_torch.configs`` arch
``jamba2-mini``, each field held against the configuration file) before
anything else, so that a checkout whose port lacks the family fails at
once, before the weights are drawn; then the weights from the seed on the
card (``configs/jamba2-mini.ref.py``'s ``make_weights``: the 8 held
experts of each expert layer), the port's ``JambaLM`` over views of them,
and ``ServeDriver`` with the configuration's ``admit_chunk``.

The comparison takes ``lm_serving``'s sample (``check.requests`` finished
requests, the longest among them) through the same float32 reference, and
compares the mean of the gaps over every served token
(``logit_gap_mean``, under ``check.logit_gap_mean_limit``) where the
serving cells compare the widest.  A routed model's widest gap is one
routing flip's, a tail that the float8 control's widest lies within 3 x
of; the mean holds every compared token and stands 10 x and more apart
from the control's.  The widest gap is printed on standard error.

Around the engine's ``prefill_request`` it also records, for each request,
the growth of the engine's ``serve_moe_pairs_held`` counter (the prefill
thread is the only one that adds to it, a request at a time): the pairs
that request's prefill routed to the held experts, read by
``moe_roofline.ldc`` and ``mfu.ldc`` under ``ctx["moe_pairs"]``.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from drivers import lm_serving
from yardstick.devtrace import Spans
from yardstick.traffic import Requests, rng, subseed

PAIRS = "serve_moe_pairs_held"


def port_config(cfg: dict):
    """The port's ``JambaConfig`` for the configuration file, each mapped
    field checked against the file.  Raises before any weight is drawn
    where the port has no such arch."""
    from repro_torch.configs import get_config
    try:
        base = get_config(cfg["arch"])
    except KeyError as e:
        raise NotImplementedError(
            f"the port has no {cfg['arch']!r} configuration (no Jamba "
            f"family): this cell cannot run on this checkout") from e
    lo, hi = cfg["held_experts"]
    z = {"n_layers": cfg["num_hidden_layers"], "d_model": cfg["hidden_size"],
         "n_heads": cfg["num_attention_heads"],
         "n_kv_heads": cfg["num_key_value_heads"],
         "head_dim": cfg["hidden_size"] // cfg["num_attention_heads"],
         "d_ff": cfg["intermediate_size"], "vocab_size": cfg["vocab_size"],
         "norm_eps": cfg["rms_norm_eps"],
         "tie_embeddings": cfg["tie_word_embeddings"],
         "ssm_state": cfg["mamba_d_state"], "ssm_conv": cfg["mamba_d_conv"],
         "ssm_expand": cfg["mamba_expand"],
         "n_experts": cfg["num_experts"], "top_k": cfg["num_experts_per_tok"],
         "n_router_experts": cfg["published_num_experts"],
         "first_expert": lo,
         "attn_layer_period": cfg["attn_layer_period"],
         "attn_layer_offset": cfg["attn_layer_offset"],
         "expert_layer_period": cfg["expert_layer_period"],
         "expert_layer_offset": cfg["expert_layer_offset"],
         "dtype": cfg["torch_dtype"], "ssm_scan_dtype": cfg["scan_state_dtype"]}
    mc = dataclasses.replace(base, **z)
    if mc.dt_rank != cfg["mamba_dt_rank"] or hi - lo != mc.n_experts or \
            cfg["mamba_proj_bias"] or not cfg["mamba_conv_bias"]:
        raise ValueError("the port's Jamba block differs from the "
                         "configuration file (dt rank, held experts or "
                         "biases)")
    return mc


def port_model(mc, weights: dict):
    """The port's model object over the benchmark's weights (views of the
    stacked tensors, no copy)."""
    from repro_torch.models.jamba import JambaLM
    at = {"mamba": 0, "attn": 0, "mlp": 0, "moe": 0}
    layers = []
    for i in range(mc.n_layers):
        groups = []
        for kind in ("attn" if mc.is_attn_layer(i) else "mamba",
                     "moe" if mc.is_moe_layer(i) else "mlp"):
            groups.append({k: v[at[kind]] for k, v in weights[kind].items()})
            at[kind] += 1
        layers.append(tuple(groups))
    return JambaLM(mc, {"embedding": weights["embedding"],
                        "lm_head": weights["lm_head"]},
                   weights["final_norm"], layers)


class Driver(lm_serving.Driver):
    def __init__(self, cell, seed, device, overrides):
        super().__init__(cell, seed, device, overrides)
        self.pairs: dict = {}        # uid -> held pairs of its prefill

    def setup(self):
        from repro_torch.core.communicator import logical_devices
        from repro_torch.core.executors import ThreadExecutor
        from repro_torch.core.pilot import ResourceManager
        from repro_torch.core.scheduler import SchedulerSession
        from repro_torch.serve.continuous import ContinuousEngine
        from repro_torch.serve.driver import ServeDriver

        self.mc = port_config(self.cfg)      # first: before any weight
        dep = self.cfg["deployment"]
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
                                  decode_chunk=dep["decode_chunk"],
                                  admit_chunk=dep["admit_chunk"])
        self.vocab = self.cfg["vocab_size"]
        # the warm-up: one prefill task's worth of the mix (admit_chunk
        # requests), its shortest and its longest prompt among them
        warm = Requests(self.traffic, self.seed, self.vocab, "warmup")
        specs = [warm.next() for _ in range(dep["admit_chunk"])]
        g = rng(self.seed, "warmup-lengths")
        for spec, n in zip(specs, (self.traffic["prompt"]["min"],
                                   self.traffic["prompt"]["max"]),
                           strict=False):
            spec.prompt = g.integers(0, self.vocab, n, dtype=np.int32)
        self.server.run([self._request(s, -1 - i, time.perf_counter())
                         for i, s in enumerate(specs)], timeout=900)
        self.session.drain(timeout=900)
        self.req.clear()
        self.prefills.clear()
        self.decodes.clear()
        self.pairs.clear()
        self.spans = Spans()
        self.session.trace.clear()
        self._warm_tasks = len(self.session.tasks)

    def _wrap(self, eng):
        super()._wrap(eng)
        inner, metrics = eng.prefill_request, eng.metrics

        def prefill_request(req):
            before = metrics.get(PAIRS)
            adm = inner(req)
            self.pairs[req.uid] = metrics.get(PAIRS) - before
            return adm

        eng.prefill_request = prefill_request

    def context(self) -> dict:
        ctx = super().context()
        ctx["moe_pairs"] = dict(self.pairs)
        return ctx

    def check(self) -> list:
        uids = self.sample()
        self.compared = uids
        if not uids:
            return [("nothing_compared", 1, 0)]
        served = [self.results[u] for u in uids]
        short = sum(1 for u, s in zip(uids, served, strict=True)
                    if len(s) != self.req[u]["answer"])
        gaps = torch.cat(self.ref.served_gaps(
            self.weights, self.cfg, [self.req[u]["prompt"] for u in uids],
            served))
        self.served_tokens_compared = int(gaps.numel())
        print(f"widest logit gap {float(gaps.max())!r} over "
              f"{gaps.numel()} served tokens", file=sys.stderr, flush=True)
        return [("logit_gap_mean", float(gaps.mean()),
                 self.cfg["check"]["logit_gap_mean_limit"]),
                ("answers_cut_short", short, 0)]
