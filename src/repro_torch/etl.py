"""The paper's headline experiment on the port: heterogeneous (shared-pool)
vs batch (static-partition) execution of two MPMD pipelines — a join DAG and
a sort DAG — on one pool of logical ranks, with continuous DAG release: each
stage is submitted the moment its own deps complete, so a freed rank
immediately backfills work from any pipeline.

Every task gets its own communicator from the thread executor and runs the
distributed sort or join of :mod:`repro_torch.dataframe.ops_dist`, whose
shuffles pack through the ``radix_partition`` CUDA kernel.  The sleeps stand
for residual work of each task, as in ``examples/etl_pipeline.py``:

    python -m repro_torch.etl                      # 4 ranks on cuda:0
    python -m repro_torch.etl --device cpu --sort-sleep 0 --join-sleep 0
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

ROWS = 20_000


def _sync(comm):
    for dev in set(comm.torch_devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _rows(table) -> int:
    return int(table.nrows.sum())


def sort_payload(comm, *_deps, rows: int = ROWS, sleep_s: float = 1.0):
    from repro_torch.dataframe import ops_dist as D
    rng = np.random.default_rng(1)
    data = {"k": rng.integers(0, 1_000_000, rows).astype(np.int32)}
    t = D.shard_table(comm, data, rows // comm.size * 2 + 64)
    out, _ = D.make_dist_sort(comm, "k", on_overflow="raise")(t)
    _sync(comm)
    time.sleep(sleep_s)     # simulated residual work of the task
    return f"sorted({_rows(out)})"


def join_payload(comm, *_deps, rows: int = ROWS, sleep_s: float = 3.0):
    from repro_torch.dataframe import ops_dist as D
    rng = np.random.default_rng(2)
    cap = rows // comm.size * 2 + 64
    a = D.shard_table(comm, {
        "k": rng.integers(0, 1_000_000, rows).astype(np.int32),
        "v": rng.normal(size=rows).astype(np.float32)}, cap)
    b = D.shard_table(comm, {
        "k": rng.integers(0, 1_000_000, rows).astype(np.int32),
        "w": rng.normal(size=rows).astype(np.float32)}, cap)
    out, _ = D.make_dist_join(comm, "k", out_factor=3.0,
                              on_overflow="raise")(a, b)
    _sync(comm)
    time.sleep(sleep_s)     # joins are the long pole
    return f"joined({_rows(out)})"


def merge_payload(comm, *_deps, rows: int = ROWS):
    """Stage that sorts once more over its whole communicator."""
    from repro_torch.dataframe import ops_dist as D
    rng = np.random.default_rng(3)
    data = {"k": rng.integers(0, 1_000_000, rows).astype(np.int32)}
    t = D.shard_table(comm, data, rows // comm.size * 2 + 64)
    out, _ = D.make_dist_sort(comm, "k", on_overflow="raise")(t)
    _sync(comm)
    return f"merged({_rows(out)} rows over {comm.size} ranks)"


def build_pipelines(n_dev: int, rows: int = ROWS, sort_sleep: float = 1.0,
                    join_sleep: float = 3.0, full_width: bool = False):
    """Two DAG pipelines: 'join' is two heavy stages plus a cheap dependent
    summarize stage; 'sort' is a chain of sorts feeding a merge.
    ``full_width=False`` caps the merge at half the pool, so a BATCH run's
    static partition can host it and both policies run the same work."""
    from repro_torch.core import Pipeline
    per = max(n_dev // 2, 1)
    merge_ranks = n_dev if full_width else per
    srt = functools.partial(sort_payload, rows=rows, sleep_s=sort_sleep)
    jn = functools.partial(join_payload, rows=rows, sleep_s=join_sleep)
    join = Pipeline("join")
    join.add("join0", ranks=per, fn=jn)
    join.add("join1", ranks=per, fn=jn)
    join.add("summarize", ranks=per,
             fn=lambda comm, *deps: f"summary({','.join(map(str, deps))})",
             deps=["join0", "join1"])
    sort = Pipeline("sort")
    sort.add("sort0", ranks=per, fn=srt)
    sort.add("sort1", ranks=per, fn=srt)
    sort.add("sort2", ranks=per, fn=srt, deps=["sort0"])
    sort.add("sort3", ranks=per, fn=srt, deps=["sort1"])
    sort.add("merge", ranks=merge_ranks,
             fn=functools.partial(merge_payload, rows=rows),
             deps=["sort2", "sort3"])
    return [join, sort]


def warm_up(n_ranks: int = 4, device=None):
    """One small sort and join on the pool's ranks.  Run it before timing
    :func:`run`: the device's and the kernels' first-use costs would
    otherwise land on whichever policy runs first."""
    from repro_torch.core import build_communicator, logical_devices
    comm = build_communicator(logical_devices(n_ranks, device))
    sort_payload(comm, rows=4096, sleep_s=0.0)
    join_payload(comm, rows=4096, sleep_s=0.0)


def run(rows: int = ROWS, sort_sleep: float = 1.0, join_sleep: float = 3.0,
        n_ranks: int = 4, device=None, placement: str = "spread",
        work_stealing: bool = False, timeout: float = 900) -> dict:
    """Both policies on a fresh ThreadExecutor each, over ``n_ranks``
    logical ranks on ``device`` (the card unless the caller names another).
    Returns ``{policy: (results, report)}``; raises if a pipeline's result
    is missing or wrong."""
    from repro_torch.core import (BATCH, HETEROGENEOUS, PilotDescription,
                                  PilotManager, ThreadExecutor,
                                  logical_devices, run_pipelines)
    devices = logical_devices(n_ranks, device)
    out = {}
    for policy in (HETEROGENEOUS, BATCH):
        rm = PilotManager(devices).submit_pilot(
            PilotDescription(n_devices=n_ranks)).resource_manager
        res, rep = run_pipelines(
            build_pipelines(n_ranks, rows, sort_sleep, join_sleep),
            rm, policy=policy, timeout=timeout, executor=ThreadExecutor(),
            placement=placement, work_stealing=work_stealing)
        if not res.get(("join", "summarize"), "").startswith("summary("):
            raise RuntimeError(f"{policy}: join pipeline result "
                               f"{res.get(('join', 'summarize'))!r}")
        merged = res.get(("sort", "merge"), "")
        if not merged.startswith(f"merged({rows} rows"):
            raise RuntimeError(f"{policy}: sort pipeline result {merged!r}")
        out[policy] = (res, rep)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="rows per task")
    ap.add_argument("--sort-sleep", type=float, default=1.0,
                    help="simulated residual seconds of each sort task")
    ap.add_argument("--join-sleep", type=float, default=3.0,
                    help="simulated residual seconds of each join task")
    ap.add_argument("--ranks", type=int, default=4,
                    help="logical ranks in the pool")
    ap.add_argument("--device", default=None,
                    help="device of the ranks (default: cuda:0)")
    ap.add_argument("--placement", choices=("spread", "pack"),
                    default="spread")
    ap.add_argument("--work-stealing", action="store_true",
                    help="batch policy: backlogged partitions lease idle "
                         "ranks from sibling partitions")
    args = ap.parse_args(argv)
    warm_up(args.ranks, args.device)
    runs = run(args.rows, args.sort_sleep, args.join_sleep, args.ranks,
               args.device, args.placement, args.work_stealing)
    spans = {}
    for policy, (res, rep) in runs.items():
        spans[policy] = rep.makespan
        print(f"[{policy:>13s}] makespan {rep.makespan:.3f}s  "
              f"({len(rep.events('dispatch'))} dispatches)  "
              f"{res[('join', 'summarize')]}  {res[('sort', 'merge')]}")
        t0 = rep.trace[0].t
        for e in rep.trace:
            if e.kind in ("dispatch", "done"):
                print(f"    t={e.t - t0:6.3f}s {e.kind:>8s} {e.task:<16s} "
                      f"ranks={e.ranks}")
    het, bat = spans["heterogeneous"], spans["batch"]
    print(f"heterogeneous vs batch: {(bat - het) / bat * 100:.1f}% shorter "
          f"makespan")


if __name__ == "__main__":
    main()
