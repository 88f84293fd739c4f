"""The paper's headline experiment on the port: heterogeneous (shared-pool)
vs batch (static-partition) execution of two MPMD pipelines — a join DAG and
a sort DAG — on one pool of logical ranks, with continuous DAG release: each
stage is submitted the moment its own deps complete, so a freed rank
immediately backfills work from any pipeline.

Every task gets its own communicator and runs the distributed sort or join
of :mod:`repro_torch.dataframe.ops_dist`, whose shuffles pack through the
``radix_partition`` CUDA kernel.  The sleeps stand for residual work of each
task, as in ``examples/etl_pipeline.py``.  Two live backends share the
scheduler core and the payloads:

  thread (default) — every task in this process, one thread each:
    python -m repro_torch.etl                      # 4 ranks on cuda:0
    python -m repro_torch.etl --device cpu --sort-sleep 0 --join-sleep 0

  process — the paper's multi-node mode: one worker interpreter per node,
  each owning its own ranks (every worker on cuda:0 on one card); a task
  whose ranks span workers runs one part per worker, each part on its own
  ranks, and the final ``merge_all`` task spans every worker:
    python -m repro_torch.etl --backend process [--workers 2]
        [--devices-per-worker 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

ROWS = 20_000


def _local(comm):
    """Per-node view of the communicator: under the process backend the
    dataframe ops run on this worker's own ranks; under the thread backend
    the task's whole communicator is local."""
    return getattr(comm, "local_comm", comm)


def _sync(comm):
    for dev in set(comm.torch_devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _rows(table) -> int:
    return int(table.nrows.sum())


def sort_payload(comm, *_deps, rows: int = ROWS, sleep_s: float = 1.0):
    from repro_torch.dataframe import ops_dist as D
    lc = _local(comm)
    rng = np.random.default_rng(1)
    data = {"k": rng.integers(0, 1_000_000, rows).astype(np.int32)}
    t = D.shard_table(lc, data, rows // lc.size * 2 + 64)
    out, _ = D.make_dist_sort(lc, "k", on_overflow="raise")(t)
    _sync(lc)
    time.sleep(sleep_s)     # simulated residual work of the task
    return f"sorted({_rows(out)})"


def join_payload(comm, *_deps, rows: int = ROWS, sleep_s: float = 3.0):
    from repro_torch.dataframe import ops_dist as D
    lc = _local(comm)
    rng = np.random.default_rng(2)
    cap = rows // lc.size * 2 + 64
    a = D.shard_table(lc, {
        "k": rng.integers(0, 1_000_000, rows).astype(np.int32),
        "v": rng.normal(size=rows).astype(np.float32)}, cap)
    b = D.shard_table(lc, {
        "k": rng.integers(0, 1_000_000, rows).astype(np.int32),
        "w": rng.normal(size=rows).astype(np.float32)}, cap)
    out, _ = D.make_dist_join(lc, "k", out_factor=3.0,
                              on_overflow="raise")(a, b)
    _sync(lc)
    time.sleep(sleep_s)     # joins are the long pole
    return f"joined({_rows(out)})"


def summarize_payload(comm, *deps):
    return f"summary({','.join(map(str, deps))})"


def merge_payload(comm, *_deps, rows: int = ROWS):
    """Stage that sorts once more over its communicator.  Under the process
    backend a task whose ranks span several workers sorts on each worker's
    own ranks, and the per-worker row counts are combined through the
    cross-process communicator (the paper's heterogeneous communicator
    across nodes): the merge then reports ``rows`` times its part count."""
    from repro_torch.dataframe import ops_dist as D
    lc = _local(comm)
    rng = np.random.default_rng(3)
    data = {"k": rng.integers(0, 1_000_000, rows).astype(np.int32)}
    t = D.shard_table(lc, data, rows // lc.size * 2 + 64)
    out, _ = D.make_dist_sort(lc, "k", on_overflow="raise")(t)
    _sync(lc)
    total = _rows(out)
    if hasattr(comm, "allgather"):          # process backend: one per part
        total = sum(comm.allgather(total))
    return f"merged({total} rows over {comm.size} ranks)"


def _warm_payload(comm):
    sort_payload(comm, rows=4096, sleep_s=0.0)
    join_payload(comm, rows=4096, sleep_s=0.0)


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
    join.add("summarize", ranks=per, fn=summarize_payload,
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


def warm_up(n_ranks: int = 4, device=None, executor=None):
    """One small sort and join on the pool's ranks (with ``executor``, a
    started process executor: one task spanning all its ranks, so that
    every worker warms its own).  Run it before timing :func:`run`: the
    device's and the kernels' first-use costs would otherwise land on
    whichever policy runs first."""
    if executor is not None:
        run_spanning(executor, "warm_up", _warm_payload)
        return
    from repro_torch.core import build_communicator, logical_devices
    _warm_payload(build_communicator(logical_devices(n_ranks, device)))


def _parts(task) -> int:
    """Worker processes a task's ranks span (1 under the thread backend)."""
    return len({getattr(d, "worker", None) for d in task.devices})


def run_spanning(executor, name: str, fn, timeout: float = 600, **kwargs):
    """Run ``fn`` as one task over every rank of a started process
    executor; returns the finished task, or raises with its error."""
    from repro_torch.core import SchedulerSession, TaskDescription, TaskState
    n = len(executor.devices())
    rep = SchedulerSession(executor, executor.resource_manager()).run(
        [TaskDescription(name=name, ranks=n, fn=fn, kwargs=kwargs,
                         tags={"pipeline": "demo"})], timeout=timeout)
    task = rep.tasks[0]
    if task.state != TaskState.DONE:
        raise RuntimeError(f"{name}: {task.state} {task.error}")
    return task


def radix_launches(comm, reset: bool = False) -> dict:
    """``{pid: launches}``: the ``radix_partition`` kernel launches each
    worker process of the task has counted, zeroed after reading with
    ``reset``.  A worker counts its launches in its own process, out of the
    parent's sight; run this as a task over every rank (``run_spanning``)
    so that each worker answers, while no other task runs."""
    import os

    from repro_torch.kernels.radix_partition.ops import radix_partition
    mine = {os.getpid(): radix_partition.launches}
    if reset:
        radix_partition.launches = 0
    if not hasattr(comm, "allgather"):
        return mine
    out = {}
    for counts in comm.allgather(mine):
        out.update(counts)
    return out


def merge_all(executor, rows: int = ROWS) -> str:
    """The paper's multi-node headline: ONE merge task whose ranks span
    every worker of a started process executor; raises unless it reports
    ``rows`` sorted rows per worker."""
    task = run_spanning(executor, "merge_all", merge_payload, rows=rows)
    n = len(task.devices)
    want = f"merged({rows * _parts(task)} rows over {n} ranks)"
    if task.result != want:
        raise RuntimeError(f"merge_all: {task.result!r}, expected {want!r}")
    return task.result


def run(rows: int = ROWS, sort_sleep: float = 1.0, join_sleep: float = 3.0,
        n_ranks: int = 4, device=None, placement: str = "spread",
        work_stealing: bool = False, timeout: float = 900,
        backend: str = "thread", workers: int = 2,
        devices_per_worker: int = 2, executor=None) -> dict:
    """Both policies over ``n_ranks`` logical ranks on ``device`` (the card
    unless the caller names another): each on a fresh ThreadExecutor, or
    with ``backend="process"`` over ``workers`` worker processes of
    ``devices_per_worker`` ranks each — on ``executor`` if given (a started
    ProcessExecutor, left running), else on a fresh warmed-up one per
    policy.  Returns ``{policy: (results, report)}``; raises if a
    pipeline's result is missing or wrong."""
    from repro_torch.core import (BATCH, HETEROGENEOUS, PilotDescription,
                                  PilotManager, ProcessExecutor,
                                  ThreadExecutor, logical_devices,
                                  run_pipelines)
    if backend == "process":
        n_ranks = len(executor.devices()) if executor is not None \
            else workers * devices_per_worker
    elif backend != "thread":
        raise ValueError(f"backend {backend!r}: thread or process")
    own = backend == "process" and executor is None
    out = {}
    for policy in (HETEROGENEOUS, BATCH):
        ex = ThreadExecutor() if backend == "thread" else executor
        try:
            if own:
                ex = ProcessExecutor(n_workers=workers,
                                     devices_per_worker=devices_per_worker,
                                     device=device).start()
                warm_up(executor=ex)
            rm = ex.resource_manager() if backend == "process" else \
                PilotManager(logical_devices(n_ranks, device)).submit_pilot(
                    PilotDescription(n_devices=n_ranks)).resource_manager
            res, rep = run_pipelines(
                build_pipelines(n_ranks, rows, sort_sleep, join_sleep),
                rm, policy=policy, timeout=timeout, executor=ex,
                placement=placement, work_stealing=work_stealing)
        finally:
            if own and ex is not None:
                ex.shutdown()
        if not res.get(("join", "summarize"), "").startswith("summary("):
            raise RuntimeError(f"{policy}: join pipeline result "
                               f"{res.get(('join', 'summarize'))!r}")
        merged = res.get(("sort", "merge"), "")
        parts = _parts(next(t for t in rep.tasks
                            if t.desc.name == "sort.merge"))
        if not merged.startswith(f"merged({rows * parts} rows"):
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
                    help="logical ranks in the pool (thread backend)")
    ap.add_argument("--backend", choices=("thread", "process"),
                    default="thread")
    ap.add_argument("--workers", type=int, default=2,
                    help="process backend: worker interpreters (nodes)")
    ap.add_argument("--devices-per-worker", type=int, default=2,
                    help="process backend: logical ranks per worker")
    ap.add_argument("--device", default=None,
                    help="device of the ranks (default: cuda:0)")
    ap.add_argument("--placement", choices=("spread", "pack"),
                    default="spread")
    ap.add_argument("--work-stealing", action="store_true",
                    help="batch policy: backlogged partitions lease idle "
                         "ranks from sibling partitions")
    args = ap.parse_args(argv)
    if args.backend == "thread":
        warm_up(args.ranks, args.device)
    runs = run(args.rows, args.sort_sleep, args.join_sleep, args.ranks,
               args.device, args.placement, args.work_stealing,
               backend=args.backend, workers=args.workers,
               devices_per_worker=args.devices_per_worker)
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
    if args.backend == "process":
        from repro_torch.core import ProcessExecutor
        with ProcessExecutor(n_workers=args.workers,
                             devices_per_worker=args.devices_per_worker,
                             device=args.device) as ex:
            print(f"cross-node merge over {args.workers} workers: "
                  f"{merge_all(ex, args.rows)}")


if __name__ == "__main__":
    main()
