"""Serving on the pilot runtime, in two acts on one pool of logical ranks:

1. the STATIC engine as one task next to an ETL dist-sort task, both placed
   by ``RaptorMaster`` on private rank sets (heterogeneous tasks on one
   pool);
2. the CONTINUOUS engine through ``ServeDriver``: prefill and decode as
   separately-tagged scheduler pipelines beside ETL sort tasks, serve
   telemetry in the session trace, and a ``ServeAutoscaler`` that grows the
   pool by a logical rank when the queue backs up.

The model's weights are random, drawn from a seeded ``torch.Generator`` on
the device; a VLM's patch embeddings and an audio model's frame embeddings
are the stub frontends' zeros.  On the card every prefill of the dense,
MoE and VLM families goes through the ``flash_attention`` kernel (the
audio family's: its encoder's, decoder's and cross-attention's), every
prefill of the SSM family (falcon-mamba) through ``ssm_scan``, and every
ETL shuffle through ``radix_partition``.

    python -m repro_torch.serve_lm                 # 4 ranks on cuda:0
    python -m repro_torch.serve_lm --device cpu
    python -m repro_torch.serve_lm --device cpu --arch falcon-mamba-7b
    python -m repro_torch.serve_lm --device cpu --arch qwen2-moe-a2.7b
    python -m repro_torch.serve_lm --device cpu --arch internvl2-1b
    python -m repro_torch.serve_lm --device cpu --arch whisper-medium
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.serve import (AutoscaleConfig, ContinuousEngine, Request,
                               ServeAutoscaler, ServeDriver, ServeEngine,
                               greedy_reference)

N_RANKS = 4


def make_requests(cfg, lengths, budgets, seed: int = 0) -> list:
    """Random-token prompts of ``lengths`` with ``budgets`` new tokens."""
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m, uid=i)
            for i, (n, m) in enumerate(zip(lengths, budgets, strict=True))]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def etl_sort(comm, rows: int, seed: int) -> dict:
    """A dist sort over the task's ranks, checked against numpy."""
    from repro_torch.dataframe import ops_dist as D
    keys = np.random.default_rng(seed).integers(0, 1 << 30, rows,
                                                dtype=np.int32)
    t = D.shard_table(comm, {"k": keys}, rows // comm.size * 2 + 64)
    out, _ = D.make_dist_sort(comm, "k", on_overflow="raise")(t)
    got = D.collect_table(out)["k"]
    if not np.array_equal(got, np.sort(keys)):
        raise AssertionError(f"dist sort of {rows} rows disagrees with numpy")
    return {"rows": rows, "ranks": comm.size}


def act_static(cfg, params, requests, devices, *, max_batch: int,
               max_seq: int, etl_rows: int, timeout: float = 600):
    """Act 1: ``ServeEngine`` as one task beside an ETL dist-sort task on a
    pilot over ``devices``.  Returns (tokens by uid, the report)."""
    from repro_torch.core import (PilotDescription, PilotManager,
                                  RaptorMaster, TaskDescription, TaskState)
    dev = devices[0].device

    def serve_task(comm):
        out = ServeEngine(cfg, params, max_batch=max_batch,
                          max_seq=max_seq).run_requests(requests)
        _sync(dev)
        return out

    half = max(len(devices) // 2, 1)
    pilot = PilotManager(devices).submit_pilot(
        PilotDescription(n_devices=len(devices)))
    master = RaptorMaster(pilot)
    master.submit(TaskDescription(name="serve", ranks=half, fn=serve_task,
                                  tags={"pipeline": "serve"}))
    master.submit(TaskDescription(
        name="etl", ranks=half, tags={"pipeline": "etl"},
        fn=functools.partial(etl_sort, rows=etl_rows, seed=1)))
    rep = master.run(timeout=timeout)
    by_name = {t.desc.name: t for t in rep.tasks}
    for t in by_name.values():
        if t.state is not TaskState.DONE:
            raise RuntimeError(f"act 1: task {t.desc.name} failed: "
                               f"{t.error}")
    return by_name["serve"].result, rep


def act_continuous(cfg, params, requests, devices, *, max_batch: int,
                   max_seq: int, etl_rows: int, etl_tasks: int = 2,
                   timeout: float = 600):
    """Act 2: ``ContinuousEngine`` through ``ServeDriver`` on a
    ``SchedulerSession`` over ``devices``, beside ``etl_tasks`` dist-sort
    tasks.  Returns (tokens by uid, the report, the engine, the
    autoscaler)."""
    from repro_torch.core import (RankDevice, ResourceManager,
                                  SchedulerSession, TaskDescription,
                                  TaskState, ThreadExecutor)
    dev = devices[0].device
    engine = ContinuousEngine(cfg, params, max_batch=max_batch,
                              max_seq=max_seq)
    ex = ThreadExecutor(tick=0.01)
    sess = SchedulerSession(ex, ResourceManager(devices), tick=0.01)
    grown = []

    def grow():
        # one more logical rank on the same device
        rank = RankDevice(len(devices) + len(grown), dev)
        grown.append(rank)
        ex.inject_grow([rank])

    autoscaler = ServeAutoscaler(
        grow=grow, retire=lambda: None,
        config=AutoscaleConfig(queue_high=2, sustain_s=0.01,
                               cooldown_s=0.05, max_workers=2))
    sess.submit([TaskDescription(
        name=f"etl{i}", ranks=2, tags={"pipeline": "etl"},
        fn=functools.partial(etl_sort, rows=etl_rows, seed=10 + i))
        for i in range(etl_tasks)])
    out = ServeDriver(engine, sess, autoscaler=autoscaler).run(
        requests, timeout=timeout)
    _sync(dev)
    rep = sess.drain(timeout=timeout).close()
    failed = [t.desc.name for t in rep.tasks if t.state is not TaskState.DONE]
    if failed:
        raise RuntimeError(f"act 2: tasks {failed} did not finish")
    return out, rep, engine, autoscaler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-8b",
                    help="an arch of a ported family (dense, moe, vlm, "
                         "ssm or audio), at reduced widths")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="device of the ranks (default: cuda:0)")
    args = ap.parse_args(argv)
    from repro_torch.core import logical_devices
    from repro_torch.models import get_model

    devices = logical_devices(N_RANKS, args.device)
    dev = devices[0].device
    cfg = dataclasses.replace(reduced(get_config(args.arch)),
                              n_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = get_model(cfg).init(gen, cfg)
    requests = make_requests(cfg, [4, 6, 4, 6, 5, 4], [8] * 6)

    t0 = time.perf_counter()
    serve_out, rep = act_static(cfg, params, requests, devices, max_batch=4,
                                max_seq=32, etl_rows=2000)
    print(f"[runtime] served {len(serve_out)} requests + ETL sort on "
          f"{len(devices)} ranks of {dev} in {rep.makespan:.2f}s")
    ref = greedy_reference(cfg, params, requests[0].prompt, 8)
    if not (serve_out[0] == ref).all():
        raise AssertionError(f"request 0: {serve_out[0]} != oracle {ref}")
    print("generated (req 0):", serve_out[0].tolist(), "== oracle")

    out, rep, engine, autoscaler = act_continuous(
        cfg, params, requests, devices, max_batch=2, max_seq=32,
        etl_rows=2000)
    for r in requests:
        ref = greedy_reference(cfg, params, r.prompt, r.max_new_tokens)
        if not (out[r.uid] == ref).all():
            raise AssertionError(f"request {r.uid}: {out[r.uid]} != {ref}")
    pipes = sorted({e.pipeline for e in rep.trace if e.kind == "dispatch"})
    tel = [e for e in rep.trace if e.kind == "telemetry"]
    print(f"[continuous] {len(out)} requests through pipelines {pipes}, "
          f"{engine.metrics.get('serve_decode_steps')} decode rounds, "
          f"{len(tel)} telemetry events, "
          f"{len(autoscaler.actions)} autoscale actions == oracle "
          f"({time.perf_counter() - t0:.2f}s in all)")


if __name__ == "__main__":
    main()
