"""The port's runtime core against the JAX package's.

The scheduler, placement and virtual clock are copies, so the same task
descriptions must give the same trace, event for event, and the same
makespan on both packages.  The communicator's shape factorisation is held
against the reference for every small rank count.  The thread executor runs
the port's ETL pipelines end to end on logical CPU ranks.  And the port
imports neither JAX nor the JAX package.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.communicator import _factor_shape as jax_factor_shape
from repro.core.communicator import degenerate_axes as jax_degenerate_axes
from repro_torch import etl
from repro_torch.core.communicator import _factor_shape, degenerate_axes
from repro_torch.core.executors import serialize
from repro_torch.kernels.radix_partition.ops import radix_partition

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("naxes", [1, 2, 3])
def test_factor_shape_and_degenerate_axes_match_jax(naxes):
    for n in range(1, 65):
        shape = _factor_shape(n, naxes)
        assert shape == jax_factor_shape(n, naxes), (n, naxes)
        assert degenerate_axes(shape) == jax_degenerate_axes(shape)


# (name, pipeline, ranks, seconds, deps)
_SPECS = [("j0", "join", 2, 3.0, ()), ("j1", "join", 2, 2.5, ()),
          ("j2", "join", 1, 1.0, ("j0", "j1")),
          ("s0", "sort", 1, 1.0, ()), ("s1", "sort", 2, 2.0, ()),
          ("s2", "sort", 1, 0.5, ("s0",)), ("s3", "sort", 3, 1.5, ("s1",)),
          ("s4", "sort", 1, 4.0, ())]


def _descs(pkg):
    return [pkg.TaskDescription(name=n, ranks=r, fn=None,
                                duration_model=(lambda _r, d=d: d),
                                tags={"pipeline": p})
            for n, p, r, d, _ in _SPECS]


def _pipelines(pkg):
    pipes = {}
    for n, p, r, d, deps in _SPECS:
        pipes.setdefault(p, pkg.Pipeline(p)).add(
            n, r, duration_model=(lambda _r, d=d: d), deps=list(deps))
    return list(pipes.values())


def _trace(report):
    # uid is a process-wide counter in each package, so it is left out
    return [(e.t, e.kind, e.task, e.pipeline, e.ranks, e.value)
            for e in report.trace]


_CASES = [(policy, placement, steal)
          for policy in ("heterogeneous", "batch")
          for placement in ("spread", "pack")
          for steal in (False, True)
          if not (steal and policy == "heterogeneous")]


@pytest.mark.parametrize("policy,placement,steal", _CASES)
def test_virtual_clock_trace_identical_to_jax(policy, placement, steal):
    reps = []
    for pkg in (J, T):
        opts = pkg.SimOptions(policy=policy, placement=placement,
                              work_stealing=steal, devices_per_node=2,
                              noise=0.05, seed=7, failure_prob=0.1)
        reps.append(pkg.simulate(_descs(pkg), 6, opts))
    assert _trace(reps[0]) == _trace(reps[1])
    assert reps[0].makespan == reps[1].makespan
    assert [t.state.value for t in reps[0].tasks] == \
        [t.state.value for t in reps[1].tasks]


@pytest.mark.parametrize("policy,placement,steal", _CASES)
def test_virtual_clock_pipelines_identical_to_jax(policy, placement, steal):
    """Continuous DAG release through run_pipelines on both packages."""
    reps = []
    for pkg in (J, T):
        ex = pkg.VirtualClockExecutor(pkg.SimOptions(
            noise=0.0, devices_per_node=2, overhead_model=lambda r: 0.1))
        _, rep = pkg.run_pipelines(_pipelines(pkg),
                                   pkg.ResourceManager(list(range(6))),
                                   policy=policy, executor=ex, timeout=1e9,
                                   placement=placement, work_stealing=steal)
        reps.append(rep)
    assert _trace(reps[0]) == _trace(reps[1])
    assert reps[0].makespan == reps[1].makespan


def test_thread_executor_dispatch_order_matches_virtual_clock():
    """One scheduler, two executors: on a single rank the thread executor
    reproduces the virtual clock's submit/dispatch/done order."""
    specs = [("p0", "p", 3.0), ("p1", "p", 1.0),
             ("q0", "q", 2.0), ("q1", "q", 4.0)]
    sim = T.SchedulerSession(T.VirtualClockExecutor(T.SimOptions(noise=0.0)),
                             T.ResourceManager([0])).run(
        [T.TaskDescription(name=n, ranks=1, fn=None,
                           duration_model=(lambda r, d=d: d),
                           tags={"pipeline": p}) for n, p, d in specs])
    live = T.SchedulerSession(
        T.ThreadExecutor(tick=0.01),
        T.ResourceManager(T.logical_devices(1, "cpu"))).run(
        [T.TaskDescription(name=n, ranks=1,
                           fn=(lambda comm, d=d: comm.device_of(0).type),
                           tags={"pipeline": p}) for n, p, d in specs],
        timeout=60)

    def key(rep):
        return [(e.kind, e.task) for e in rep.trace
                if e.kind in ("submit", "dispatch", "done")]

    assert key(sim) == key(live)
    assert [t.result for t in live.tasks] == ["cpu"] * 4


def test_etl_pipelines_on_four_logical_cpu_ranks():
    before = radix_partition.launches
    runs = etl.run(rows=3000, sort_sleep=0.0, join_sleep=0.0, n_ranks=4,
                   device="cpu", timeout=120)
    assert set(runs) == {"heterogeneous", "batch"}
    for res, rep in runs.values():
        assert res[("sort", "merge")] == "merged(3000 rows over 2 ranks)"
        assert res[("join", "summarize")].startswith("summary(joined(")
        assert len(rep.events("done")) == 8
        assert rep.makespan > 0
    # identical inputs, identical answers under both policies
    assert runs["heterogeneous"][0] == runs["batch"][0]
    assert radix_partition.launches == before      # the CPU takes plain


def test_communicator_over_logical_ranks():
    devs = T.logical_devices(6, "cpu")
    assert [d.rank for d in devs] == list(range(6))
    comm = T.build_communicator(devs, axes=("a", "b"))
    assert comm.shape == (3, 2) and comm.size == 6
    assert comm.device_of(5) == torch.device("cpu")
    assert comm.sub("b") == 2
    with pytest.raises(ValueError, match="unknown mesh axis"):
        comm.sub("c")
    assert T.build_communicator(T.logical_devices(7, "cpu"),
                                axes=("a", "b")).degenerate_axes == ("b",)


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.PilotManager()
    with pytest.raises(RuntimeError):
        T.logical_devices(2)
    assert T.resolve_device("cpu") == torch.device("cpu")


def test_thread_executor_refuses_checkpointing_not_yet_ported(tmp_path):
    """Checkpointing is ported now: with a checkpoint root the task gets a
    CheckpointContext of its lineage, attempt and part, and its save lands
    under ``t<uid>/p0-of-1/a0``."""
    from repro_torch.train.checkpoint import CheckpointContext, latest_step

    def pay(comm):
        assert isinstance(comm.checkpoint, CheckpointContext)
        comm.checkpoint.save(3, {"x": torch.ones(2)})
        return 1

    sess = T.SchedulerSession(T.ThreadExecutor(tick=0.01),
                              T.ResourceManager(T.logical_devices(1, "cpu")),
                              ckpt_root=str(tmp_path))
    rep = sess.run([T.TaskDescription(name="t", ranks=1, fn=pay,
                                      max_retries=0)], timeout=30)
    task = rep.tasks[0]
    assert task.state == T.TaskState.DONE, task.error
    assert latest_step(tmp_path / f"t{task.uid}" / "p0-of-1" / "a0") == 3


def test_serialize_ships_torch_tensors_as_raw_arrays():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    skel, metas, bufs = serialize.dumps_arrays({"x": t, "y": [1, "a"]})
    assert metas == [(np.dtype(np.float32).str, (2, 3))]
    payload = b"".join(memoryview(b).cast("B") for b in bufs)
    out = serialize.loads_arrays(skel, metas, payload)
    np.testing.assert_array_equal(out["x"], t.numpy())
    assert out["y"] == [1, "a"]
    assert serialize.dumps_arrays({"y": [1, 2]}) is None


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)",
                     re.M)


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files if p.exists()
                 for m in _IMPORT.finditer(p.read_text())]
    assert not offenders, offenders


def test_port_imports_without_loading_jax_or_repro():
    code = ("import sys, repro_torch, repro_torch.etl, repro_torch.core, "
            "repro_torch.dataframe.ops_dist, repro_torch.dataframe.shuffle, "
            "repro_torch.obs, repro_torch.serve_lm, "
            "repro_torch.models.convert, repro_torch.core.executors.proc, "
            "repro_torch.core.executors.worker\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
