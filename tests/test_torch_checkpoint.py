"""The port's checkpoints: twins of ``tests/test_checkpoint_resume.py``
(the commit protocol, ``CheckpointContext`` across attempts, a retried
task resuming on the thread and the process executor), and the file
format held to the JAX package's: a checkpoint written by either package
restores in the other, and the port reads the JAX package's bfloat16
files, which the JAX package itself cannot restore."""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jck

from repro_torch.core import (ProcessExecutor, ResourceManager,
                              SchedulerSession, TaskDescription, TaskState,
                              ThreadExecutor)
from repro_torch.core.executors import serialize
from repro_torch.train.checkpoint import (
    CheckpointContext, CheckpointError, completed_steps, latest_step,
    restore, save,
)

if serialize.HAVE_CLOUDPICKLE:
    import cloudpickle

    # ship this module's payload functions by value: a worker process has no
    # way to import the test module
    cloudpickle.register_pickle_by_value(sys.modules[__name__])

needs_cloudpickle = pytest.mark.skipif(
    not serialize.HAVE_CLOUDPICKLE,
    reason="cloudpickle needed to ship test-local payload functions")

SRC = str(Path(__file__).resolve().parents[1] / "src")


# ---------------------------------------------------------------------------
# commit protocol units
# ---------------------------------------------------------------------------
def _tree(scale=1.0):
    return {"w": torch.arange(4.0) * scale,
            "opt": {"m": np.ones(2) * scale}}


def test_save_commits_atomically_and_latest_is_monotonic(tmp_path):
    save(tmp_path, 5, _tree(), async_=False)
    # an out-of-order (older) save lands as a step but must NOT move LATEST
    # backwards — e.g. a straggling async writer of a step already superseded
    save(tmp_path, 3, _tree(0.5), async_=False)
    assert (tmp_path / "LATEST").read_text().strip() == "5"
    assert completed_steps(tmp_path) == [3, 5]
    assert latest_step(tmp_path) == 5
    # tmp-file finalize leaves no droppings behind
    assert not [p for p in tmp_path.rglob(".*tmp*")]


def test_latest_validates_and_falls_back_to_newest_complete(tmp_path):
    save(tmp_path, 1, _tree(), async_=False)
    save(tmp_path, 2, _tree(2.0), async_=False)
    # torn LATEST (garbage bytes): fall back to the manifest scan
    (tmp_path / "LATEST").write_text("garb\x00age")
    assert latest_step(tmp_path) == 2
    # LATEST pointing at a step whose leaf vanished: also fall back
    (tmp_path / "LATEST").write_text("2")
    (tmp_path / "step_00000002" / "w.npy").unlink()
    assert latest_step(tmp_path) == 1
    assert completed_steps(tmp_path) == [1]
    # and restore of the half-missing step refuses with a structured error
    with pytest.raises(CheckpointError, match="step 2"):
        restore(tmp_path, 2, _tree())


def test_restore_names_missing_leaf(tmp_path):
    save(tmp_path, 0, {"w": torch.arange(3.0)}, async_=False)
    with pytest.raises(CheckpointError, match="opt/m"):
        restore(tmp_path, 0, {"w": torch.zeros(3),
                              "opt": {"m": torch.zeros(2)}})
    with pytest.raises(CheckpointError, match="no complete checkpoint"):
        restore(tmp_path, 9, {"w": torch.zeros(3)})


def test_restore_dtype_cast_and_scalar_leaves(tmp_path):
    tree = {"w": torch.arange(4, dtype=torch.float64), "step": 7, "lr": 0.1,
            "n": np.arange(3, dtype=np.int64)}
    save(tmp_path, 0, tree, async_=False)
    like = {"w": torch.zeros(4, dtype=torch.float32), "step": 0, "lr": 0.0,
            "n": np.zeros(3, np.int32)}
    got = restore(tmp_path, 0, like)
    assert got["w"].dtype == torch.float32       # cast to `like`'s dtype
    assert torch.equal(got["w"], torch.arange(4.0))
    assert got["n"].dtype == np.int32
    assert int(got["step"]) == 7                 # scalar leaves: no dtype
    assert float(got["lr"]) == pytest.approx(0.1)
    # a meta-tensor like gives the shape and dtype; device= places it
    meta = restore(tmp_path, 0, {"w": torch.empty(4, device="meta")},
                   device="cpu")
    assert meta["w"].device.type == "cpu" and meta["w"].dtype == \
        torch.float32


def test_save_takes_host_copies_before_returning(tmp_path):
    """The trainer updates its tensors in place while an async save
    writes: the file holds the values at the call."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    h = save(tmp_path, 1, {"w": w}, async_=True)
    w.add_(1.0)
    h.join()
    assert torch.equal(restore(tmp_path, 1, {"w": torch.zeros(1 << 16)})["w"],
                       torch.arange(1 << 16, dtype=torch.float32))


def test_sigkill_at_commit_boundary_leaves_restorable_step(tmp_path):
    """A process killed after writing step 1's leaves but BEFORE its
    manifest commits must leave step 0 fully restorable and step 1
    invisible — the manifest is the commit point."""
    snippet = (
        "import os, signal, sys\n"
        "import torch\n"
        "from repro_torch.train import checkpoint as ck\n"
        "root = sys.argv[1]\n"
        "ck.save(root, 0, {'w': torch.arange(4.0)}, async_=False)\n"
        "orig = ck._atomic_write_text\n"
        "def dying(path, text):\n"
        "    if path.name == 'manifest.json':\n"
        "        os.kill(os.getpid(), signal.SIGKILL)\n"
        "    orig(path, text)\n"
        "ck._atomic_write_text = dying\n"
        "ck.save(root, 1, {'w': torch.arange(4.0) * 2}, async_=False)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", snippet, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == -signal.SIGKILL, r.stderr
    assert (tmp_path / "step_00000001" / "w.npy").exists()
    assert latest_step(tmp_path) == 0
    assert completed_steps(tmp_path) == [0]
    got = restore(tmp_path, 0, {"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.arange(4.0))


def test_context_reads_across_attempts_writes_only_its_own(tmp_path):
    a0 = CheckpointContext(tmp_path, attempt="a0")
    a0.save(0, {"acc": torch.full((2,), 0.0)})
    a0.save(1, {"acc": torch.full((2,), 1.0)})
    a1 = CheckpointContext(tmp_path, attempt="a1")
    assert a1.latest() == 1                       # sees the doomed primary's
    got = a1.restore(1, {"acc": torch.zeros(2)})  # durable progress...
    assert torch.equal(got["acc"], torch.ones(2))
    assert a1.resumed_from_step == 1
    a1.save(2, {"acc": torch.full((2,), 2.0)})
    # ...but writes land only in a1's own dir (no cross-attempt races)
    assert completed_steps(a0.dir) == [0, 1]
    assert completed_steps(a1.dir) == [2]
    assert a0.latest() == 2                       # lineage-wide view
    # a different part split is a different scope: conservatively fresh
    assert CheckpointContext(tmp_path, attempt="a0",
                             part=0, n_parts=2).latest() is None


def test_mesh_restore_waits_for_the_distributed_layer(tmp_path):
    """The elastic re-shard, which waited for the distributed layer: a
    leaf with a spec restores as its per-rank blocks on the mesh, a leaf
    with the spec () as a copy on every rank, a leaf whose spec is None
    whole, as without a mesh."""
    from repro_torch.launch.mesh import make_local_mesh
    save(tmp_path, 0, {"w": torch.arange(4.), "b": torch.ones(2)},
         async_=False)
    like = {"w": torch.zeros(4), "b": torch.zeros(2)}
    mesh = make_local_mesh(2, 1, device="cpu")
    got = restore(tmp_path, 0, like, mesh=mesh,
                  specs={"w": ("data",), "b": None})
    assert [b.tolist() for b in got["w"]] == [[0., 1.], [2., 3.]]
    assert torch.equal(got["b"], torch.ones(2))
    got = restore(tmp_path, 0, like, mesh=mesh, specs={"w": (), "b": ()})
    assert [b.tolist() for b in got["w"]] == [[0., 1., 2., 3.]] * 2


# ---------------------------------------------------------------------------
# the file format across packages
# ---------------------------------------------------------------------------
def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = {"params": {"w": torch.randn(3, 4), "b": [torch.arange(3)]},
            "count": torch.tensor(7, dtype=torch.int32)}
    save(tmp_path, 4, tree, async_=False)
    assert jck.latest_step(tmp_path) == 4
    like = {"params": {"w": jnp.zeros((3, 4), jnp.float32),
                       "b": [jnp.zeros(3, jnp.int32)]},
            "count": jnp.zeros((), jnp.int32)}
    got = jck.restore(tmp_path, 4, like)
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]),
                                  tree["params"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(got["params"]["b"][0]),
                                  np.arange(3))
    assert int(got["count"]) == 7


def test_jax_checkpoint_restores_in_port(tmp_path):
    tree = {"params": {"w": jnp.arange(12.0).reshape(3, 4),
                       "b": [jnp.arange(3, dtype=jnp.int32)]},
            "count": jnp.asarray(5, jnp.int32)}
    jck.save(tmp_path, 2, tree, async_=False)
    like = {"params": {"w": torch.zeros(3, 4),
                       "b": [torch.zeros(3, dtype=torch.int32)]},
            "count": torch.zeros((), dtype=torch.int32)}
    got = restore(tmp_path, latest_step(tmp_path), like)
    assert torch.equal(got["params"]["w"], torch.arange(12.0).reshape(3, 4))
    assert torch.equal(got["params"]["b"][0],
                       torch.arange(3, dtype=torch.int32))
    assert int(got["count"]) == 5


def test_port_restores_the_jax_packages_bf16_checkpoint(tmp_path):
    """The JAX package writes a bfloat16 leaf as ``<V2`` words and cannot
    read it back (``astype`` has no cast from void); the port reads it as
    torch.bfloat16, bit for bit, and writes the same file."""
    vals = np.random.default_rng(0).standard_normal((2, 3)).astype(
        np.float32)
    jck.save(tmp_path / "jax", 0, {"w": jnp.asarray(vals, jnp.bfloat16)},
             async_=False)
    with pytest.raises(ValueError):
        jck.restore(tmp_path / "jax", 0,
                    {"w": jnp.zeros((2, 3), jnp.bfloat16)})
    got = restore(tmp_path / "jax", 0,
                  {"w": torch.zeros(2, 3, dtype=torch.bfloat16)})["w"]
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    save(tmp_path / "port", 0, {"w": want}, async_=False)
    jfile, pfile = (tmp_path / d / "step_00000000" / "w.npy"
                    for d in ("jax", "port"))
    assert pfile.read_bytes() == jfile.read_bytes()
    manifest = (tmp_path / "port" / "step_00000000" / "manifest.json")
    assert '"dtype": "bfloat16"' in manifest.read_text()
    # restored into f32 it is the bf16 values widened
    wide = restore(tmp_path / "port", 0, {"w": torch.zeros(2, 3)})["w"]
    assert wide.dtype == torch.float32 and torch.equal(wide, want.float())


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_checkpoint_crosses_packages(tmp_path, arch):
    """An MoE trainer's checkpoint (``blocks/moe`` with its nested
    ``shared``, and llama4's ``blocks/mlp_dense``) written by the JAX
    trainer restores in the port's, and the port's in the JAX trainer's,
    bit for bit (f32), parameters and moments alike."""
    import dataclasses

    import jax

    from repro.configs import ParallelConfig as JParallel
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch.mesh import make_local_mesh
    from repro.train import data as jdata
    from repro.train.trainer import Trainer as JTrainer

    from repro_torch.configs import ParallelConfig, ShapeConfig
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.convert import jax_tree, params_to_jax
    from repro_torch.train import data as tdata
    from repro_torch.train.trainer import Trainer

    jcfg = jreduced(jget(arch))
    tcfg = reduced(get_config(arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jt = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(),
                  JShape("t", "train", 16, 2), ckpt_dir=str(jdir),
                  ckpt_every=2)
    js, _ = jt.fit(jdata.SyntheticCorpus(jcfg.vocab_size, 0).batches(2, 16,
                                                                      2),
                   2, log_every=0)
    tt = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", 16, 2),
                 ckpt_dir=str(jdir), device="cpu")
    ts = tt.maybe_restore()
    assert ts.step == 2 and int(ts.opt_state["count"]) == 2

    def pairs(port, ref):
        ref = jax.tree.map(np.asarray, ref)
        pf = dict(jax.tree_util.tree_flatten_with_path(port)[0])
        rf = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        assert set(pf) == set(rf)
        assert any("shared" in str(p) for p in rf)
        return [(str(k), np.asarray(pf[k]), rf[k]) for k in rf]

    nu = jax.tree.map(lambda t: t.numpy(), jax_tree(ts.opt_state["nu"],
                                                    tcfg))
    for path, p, r in pairs(params_to_jax(ts.params), js.params) + pairs(
            nu, js.opt_state["nu"]):
        np.testing.assert_array_equal(p, r, err_msg=path)

    tt2 = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", 16, 2),
                  ckpt_dir=str(tdir), ckpt_every=3, device="cpu")
    ts2, _ = tt2.fit(tdata.SyntheticCorpus(tcfg.vocab_size, 0).batches(
        2, 16, 1), 1, state=ts, log_every=0)
    jt2 = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(),
                   JShape("t", "train", 16, 2), ckpt_dir=str(tdir))
    js2 = jt2.maybe_restore()
    assert js2.step == 3 and int(js2.opt_state["count"]) == 3
    for path, p, r in pairs(params_to_jax(ts2.params), js2.params):
        np.testing.assert_array_equal(p, r, err_msg=path)


# ---------------------------------------------------------------------------
# scheduler integration: thread executor (tier-1)
# ---------------------------------------------------------------------------
def test_thread_retry_resumes_from_last_durable_step(tmp_path):
    executed = []

    def pay(comm, n_steps=6):
        c = comm.checkpoint
        assert c is not None
        acc, start = torch.zeros(2), 0
        last = c.latest()
        if last is not None:
            acc = c.restore(last, {"acc": acc})["acc"]
            start = last + 1
        for s in range(start, n_steps):
            executed.append(s)
            acc = acc + s
            c.save(s, {"acc": acc})
            if s == 2 and c.attempt == "a0":
                raise RuntimeError("dies after step 2 committed")
        return acc

    sess = SchedulerSession(ThreadExecutor(build_comm=False, tick=0.01),
                            ResourceManager(["d0"]), tick=0.01,
                            ckpt_root=str(tmp_path))
    rep = sess.run([TaskDescription(name="t", ranks=1, fn=pay, max_retries=2,
                                    tags={"pipeline": "p"})], timeout=60)
    task = rep.tasks[0]
    assert task.state == TaskState.DONE
    assert rep.n_retries == 1
    assert executed == [0, 1, 2, 3, 4, 5]
    assert task.resumed_from_step == 2
    assert torch.equal(task.result, torch.full((2,), float(sum(range(6)))))
    resumes = rep.events("resume")
    assert len(resumes) == 1 and resumes[0].value == 2.0
    done = rep.events("done")[0]
    assert done.data["resumed_from_step"] == 2


def test_thread_retry_resumes_training_from_its_checkpoint(tmp_path):
    """The trainer on a task's CheckpointContext: attempt a0 saves every 2
    steps and dies after step 5; the retry restores step 4 from a0's
    directory and trains to step 8."""
    from repro_torch.train_lm import train_task
    sess = SchedulerSession(ThreadExecutor(build_comm=False, tick=0.01),
                            ResourceManager(["d0"]), tick=0.01,
                            ckpt_root=str(tmp_path))
    rep = sess.run([TaskDescription(
        name="train", ranks=1, fn=train_task, max_retries=1,
        kwargs=dict(preset="ci", steps=8, ckpt_every=2, fail_at=5,
                    device="cpu"), tags={"pipeline": "p"})], timeout=120)
    task = rep.tasks[0]
    assert task.state == TaskState.DONE, task.error
    assert rep.n_retries == 1 and task.resumed_from_step == 4
    assert task.result["start_step"] == 4 and task.result["step"] == 8
    assert len(task.result["losses"]) == 4


def test_no_ckpt_root_means_no_context(tmp_path):
    seen = []

    def pay(comm):
        seen.append(comm.checkpoint)
        return 1

    sess = SchedulerSession(ThreadExecutor(build_comm=False, tick=0.01),
                            ResourceManager(["d0"]), tick=0.01)
    rep = sess.run([TaskDescription(name="t", ranks=1, fn=pay,
                                    tags={"pipeline": "p"})], timeout=60)
    assert rep.tasks[0].state == TaskState.DONE
    assert seen == [None]
    assert not rep.events("resume")


def test_env_knob_binds_ckpt_root(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CKPT_DIR", str(tmp_path))

    def pay(comm):
        comm.checkpoint.save(0, {"x": torch.ones(1)})
        return 1

    sess = SchedulerSession(ThreadExecutor(build_comm=False, tick=0.01),
                            ResourceManager(["d0"]), tick=0.01)
    rep = sess.run([TaskDescription(name="t", ranks=1, fn=pay,
                                    tags={"pipeline": "p"})], timeout=60)
    uid = rep.tasks[0].uid
    assert latest_step(tmp_path / f"t{uid}" / "p0-of-1" / "a0") == 0


# ---------------------------------------------------------------------------
# process-executor integration: real SIGKILL, real resume
# ---------------------------------------------------------------------------
def _ckpt_steps(comm, n_steps=8, step_s=0.25):
    c = comm.checkpoint
    acc, start = torch.zeros(1), 0
    last = c.latest() if c is not None else None
    if last is not None:
        acc = c.restore(last, {"acc": acc})["acc"]
        start = last + 1
    executed = 0
    for s in range(start, n_steps):
        time.sleep(step_s)
        acc = acc + s
        c.save(s, {"acc": acc})
        executed += 1
    return {"executed": executed, "start": start, "acc": float(acc[0])}


@needs_cloudpickle
@pytest.mark.integration
def test_proc_sigkill_midtask_retry_resumes(tmp_path):
    """SIGKILL the worker running a stepped task partway through: the retry
    on the surviving worker must restore the steps the dead attempt durably
    committed and re-execute strictly fewer than the total."""
    n_steps, step_s = 8, 0.25
    with ProcessExecutor(n_workers=2, devices_per_worker=1,
                         build_comm=False, tick=0.005,
                         heartbeat_interval=0.2, device="cpu") as ex:
        sess = SchedulerSession(ex, ex.resource_manager(), tick=0.02,
                                ckpt_root=str(tmp_path))
        sess.submit([TaskDescription(
            name="steps", ranks=1, fn=_ckpt_steps,
            kwargs={"n_steps": n_steps, "step_s": step_s},
            max_retries=2, tags={"pipeline": "p"})])
        # let a few steps commit, then kill the worker that owns the task
        time.sleep(step_s * (n_steps // 2) + 0.4)
        victim = sess.tasks[0].devices[0].worker
        ex.kill_worker(victim, signal.SIGKILL)
        rep = sess.drain(timeout=180).close()
    task = rep.tasks[0]
    assert task.state == TaskState.DONE
    assert rep.n_retries >= 1
    assert task.resumed_from_step > 0
    assert task.result["start"] == task.resumed_from_step + 1
    assert task.result["executed"] < n_steps
    assert task.result["acc"] == float(sum(range(n_steps)))
    resumes = rep.events("resume")
    assert resumes and resumes[0].value == float(task.resumed_from_step)
