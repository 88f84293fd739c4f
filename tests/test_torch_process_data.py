"""The dataframe path across worker processes: the out-of-core ``sort_task``
and ``join_task`` on the port's 2-worker pilot, their buckets packed by
``radix_bucket`` (``verify_kernel``: the kernel's wrapper held to its
oracle in every worker) and exchanged worker to worker.

Each summary is held to a numpy oracle over all parts' rows (and, in
``test_torch_process_jax.py``, to the JAX package's).  The ETL pipelines
run on the process backend under both policies, and ``merge_all`` spans
every worker.  Workers run on the CPU (``device="cpu"``).
"""
import numpy as np
import pytest

import repro_torch.core as T
from repro_torch import etl
from repro_torch.dataframe import shuffle
from repro_torch.dataframe.shuffle import _gen_part

PARTS = 2
SORT_SPECS = {
    "in_memory": {"rows_per_part": 6000, "seed": 3},
    # a budget far below the data: every received run spills to disk
    "spilled": {"rows_per_part": 5000, "seed": 7, "payload_width": 2,
                "budget": 8192, "chunk_rows": 700},
}
JOIN_SPECS = {
    "in_memory": {"rows_per_part": 4000, "key_range": 6000, "seed": 4},
    "spilled": {"rows_per_part": 3000, "right_rows_per_part": 2000,
                "key_range": 2500, "seed": 8, "budget": 8192,
                "chunk_rows": 500},
}


def _u64sum(a) -> int:
    return int(np.add.reduce(np.asarray(a).astype(np.uint64),
                             dtype=np.uint64))


def _rows(spec, side):
    parts = [_gen_part(spec if side == 0 else dict(
        spec, rows_per_part=spec.get("right_rows_per_part",
                                     spec["rows_per_part"])), p, side)
        for p in range(PARTS)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def numpy_sort_summary(spec) -> dict:
    keys = _rows(spec, 0)["key"]
    return {"n": len(keys), "key_sum": _u64sum(keys), "sorted": True}


def numpy_join_summary(spec) -> dict:
    """Inner join of all parts' left and right rows on ``key``."""
    left, right = _rows(spec, 0), _rows(spec, 1)
    order = np.argsort(right["key"], kind="stable")
    rk = right["key"][order]
    lo = np.searchsorted(rk, left["key"], "left")
    counts = np.searchsorted(rk, left["key"], "right") - lo
    li = np.repeat(np.arange(len(counts)), counts)
    ri = order[lo[li] + (np.arange(len(li)) - (np.cumsum(counts)
                                                - counts)[li])]
    return {"n": len(li), "key_sum": _u64sum(left["key"][li]),
            "v_sum": _u64sum(left["v0"][li]),
            "w_sum": _u64sum(right["w0"][ri])}


def run_all(pkg, ex, sh, **extra):
    """Every spec of this file as one task over all ranks of ``ex`` (an
    executor of package ``pkg``), through the shuffle module ``sh``'s
    tasks, in one session; ``extra`` joins every spec."""
    return _run(pkg, ex, [
        *((f"sort_{k}", sh.sort_task, dict(s, verify_kernel=True, **extra))
          for k, s in SORT_SPECS.items()),
        *((f"join_{k}", sh.join_task, dict(s, verify_kernel=True, **extra))
          for k, s in JOIN_SPECS.items())])


def _run(pkg, ex, descs):
    sess = pkg.SchedulerSession(ex, ex.resource_manager(), tick=0.02)
    rep = sess.run([pkg.TaskDescription(name=n, ranks=2 * PARTS, fn=fn,
                                        args=(spec,), tags={"pipeline": "p"})
                    for n, fn, spec in descs], timeout=300)
    for t in rep.tasks:
        assert t.state == pkg.TaskState.DONE, (t.desc.name, t.error)
        assert len({d.worker for d in t.devices}) == PARTS
    return {t.desc.name: t for t in rep.tasks}


@pytest.fixture(scope="module")
def port_ex():
    with T.ProcessExecutor(n_workers=PARTS, devices_per_worker=2,
                           device="cpu") as ex:
        yield ex


@pytest.fixture(scope="module")
def port_tasks(port_ex):
    return run_all(T, port_ex, shuffle, device="cpu")


@pytest.mark.parametrize("case", list(SORT_SPECS))
def test_spanning_sort_task_matches_numpy(port_tasks, port_ex, case):
    task = port_tasks[f"sort_{case}"]
    res = task.result
    assert {k: res[k] for k in ("n", "key_sum", "sorted")} == \
        numpy_sort_summary(SORT_SPECS[case])
    assert (res["spills"] > 0) == (case == "spilled")
    # the buckets crossed between the workers on the peer plane
    assert task.p2p_bytes > 0 and port_ex.p2p_fallbacks == 0


@pytest.mark.parametrize("case", list(JOIN_SPECS))
def test_spanning_join_task_matches_numpy(port_tasks, case):
    res = port_tasks[f"join_{case}"].result
    assert {k: res[k] for k in ("n", "key_sum", "v_sum", "w_sum")} == \
        numpy_join_summary(JOIN_SPECS[case])
    assert (res["spills"] > 0) == (case == "spilled")


def test_radix_launch_census_reaches_every_worker(port_ex):
    """On the CPU the wrapper takes the plain version and counts nothing;
    the census still answers once per worker process."""
    counts = etl.run_spanning(port_ex, "census", etl.radix_launches,
                              reset=True).result
    assert len(counts) == PARTS and set(counts.values()) == {0}
    assert {w.proc.pid for w in port_ex.workers.values()} == set(counts)


def test_etl_process_backend_both_policies_and_merge_all(port_ex):
    """``python -m repro_torch.etl --backend process``: both policies, each
    on a fresh warmed-up pilot, then ``merge_all`` over every worker."""
    rows = 3000
    runs = etl.run(rows=rows, sort_sleep=0.0, join_sleep=0.0, device="cpu",
                   backend="process", workers=PARTS, devices_per_worker=2,
                   timeout=300)
    for policy, (res, rep) in runs.items():
        assert res[("join", "summarize")].startswith("summary(joined(")
        merge = next(t for t in rep.tasks if t.desc.name == "sort.merge")
        parts = len({d.worker for d in merge.devices})
        assert res[("sort", "merge")] == \
            f"merged({rows * parts} rows over 2 ranks)", policy
        assert all(isinstance(d, T.ProcDevice) for t in rep.tasks
                   for d in t.devices)
    assert etl.merge_all(port_ex, rows) == \
        f"merged({rows * PARTS} rows over {2 * PARTS} ranks)"
