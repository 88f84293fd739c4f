"""The port's distributed layer against the JAX package's, on the CPU:
placement by spec, the sharded train step, local-expert MoE and the
elastic restore, over logical CPU ranks (``make_local_mesh(d, m,
device="cpu")``).

The JAX oracles run on one host device: the JAX ``Trainer`` on
``make_local_mesh(1, 1)`` from the same parameters (its ``init`` at key 0,
carried across) and batches, and ``moe_ffn`` on each data shard's tokens
alone, which is what the JAX ``moe_ffn_shardmap`` computes.  The (2, 2)
JAX trainer on 4 host devices is the ``integration`` test at the end,
within that test's own 2e-3.

Tolerances: the sharded step's losses within 1e-5 relative and every
parameter leaf within 1e-5 of its largest magnitude (float32 sums over
data ranks in another order); the EP within 1e-5 of the largest |output|;
placement and restores bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._subproc import run_with_devices

from repro.configs import ParallelConfig as JParallel
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import get_model as jax_get_model
from repro.models import moe as jmoe
from repro.train.trainer import Trainer as JTrainer

from repro_torch.configs import ParallelConfig, ShapeConfig, get_config, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.context import axes_ctx
from repro_torch.distributed.steps import make_train_step
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe as tmoe
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticCorpus
from repro_torch.train.trainer import Trainer

CPU = "cpu"
ARCH = "qwen3-8b"
SEQ, BATCH, STEPS = 32, 8, 3
MOE = ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side on one torch thread: the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(d, m):
    return make_local_mesh(d, m, device=CPU)


def _configs(arch=ARCH, n_layers=2, **kw):
    return (dataclasses.replace(jreduced(jget(arch)), n_layers=n_layers, **kw),
            dataclasses.replace(reduced(get_config(arch)), n_layers=n_layers,
                                **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch=ARCH, n_layers=2, **kw):
    jcfg, _ = _configs(arch, n_layers, **kw)
    return jax.tree.map(np.asarray,
                        jax_get_model(jcfg).init(jax.random.key(0), jcfg))


def _batches(vocab, n=STEPS, b=BATCH, s=SEQ):
    return list(SyntheticCorpus(vocab, 0).batches(b, s, n))


def _close_tree(got: dict, want: dict, tol=1e-5):
    got, want = sh.flat_paths(got), sh.flat_paths(want)
    assert set(got) == set(want)
    for k, r in want.items():
        p = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) \
            else got[k]
        r = np.asarray(r)
        assert p.shape == r.shape, k
        assert np.abs(p - r).max() <= tol * np.abs(r).max(), k


def _equal_tree(got: dict, want: dict):
    got, want = sh.flat_paths(got), sh.flat_paths(want)
    assert set(got) == set(want)
    for k in want:
        a, b = got[k], want[k]
        a, b = (x.detach().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in (a, b))
        np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# the mesh and placement
# ---------------------------------------------------------------------------
def test_make_local_mesh():
    m = mesh(2, 3)
    assert (m.axes, m.shape, m.size) == (("data", "model"), (2, 3), 6)
    assert all(d.type == "cpu" for d in m.torch_devices)
    assert sh.rank_coords(m)[4] == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_local_mesh(2, 2)
    with pytest.raises(ValueError):
        make_local_mesh(0, 2, device=CPU)


SPECS = [((), (8, 6)), (("data",), (8, 6)), ((None, "model"), (4, 6)),
         (("model", "data"), (4, 6, 3)), ((("data", "model"), None), (12, 5)),
         ((None, None, ("model", "data")), (2, 3, 8)),
         (("data", None, "model"), (4, 1, 6))]


@pytest.mark.parametrize("spec,shape", SPECS)
@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (1, 4), (2, 3)])
def test_shard_unshard_round_trip(spec, shape, grid):
    """Each rank's block is what NamedSharding gives its device: dim d
    split over its axes, the first major; other axes hold copies."""
    m = mesh(*grid)
    sizes = dict(zip(m.axes, m.shape))
    used = [a for e in spec if e for a in ((e,) if isinstance(e, str) else e)]
    if any(shape[i] % int(np.prod([sizes[a] for a in (
            (e,) if isinstance(e, str) else e)])) for i, e in enumerate(spec)
            if e):
        with pytest.raises(ValueError, match="leaf/x"):
            sh.shard(torch.zeros(shape), spec, m, "leaf/x")
        return
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        x = torch.arange(int(np.prod(shape))).reshape(shape).to(dtype)
        blocks = sh.shard(x, spec, m, "leaf/x")
        assert len(blocks) == m.size
        for r, (b, c) in enumerate(zip(blocks, sh.rank_coords(m))):
            assert b.is_contiguous() and b.dtype == dtype
            want = x
            for i, e in enumerate(spec):
                names = () if e is None else (e,) if isinstance(e, str) else e
                idx, n = 0, 1
                for a in names:
                    idx, n = idx * sizes[a] + c[a], n * sizes[a]
                step = shape[i] // n
                want = want.narrow(i, idx * step, step)
            assert torch.equal(b, want)
            assert b.data_ptr() != x.data_ptr()
        back = sh.unshard(blocks, spec, m, name="leaf/x")
        assert torch.equal(back, x) and back.dtype == dtype
        # the owners' blocks tile x once: one a distinct block
        assert len(sh.owners(spec, m)) == int(np.prod(
            [sizes[a] for a in used] or [1]))


@pytest.mark.parametrize("spec,shape", [
    ((), (8, 6)), (("data",), (8, 6)), ((None, "model"), (4, 12)),
    (("data", None, "model"), (4, 1, 12))])
@pytest.mark.parametrize("grid", [(2, 2), (1, 4), (2, 3)])
def test_gather_block_is_each_model_ranks_block(spec, shape, grid):
    """``gather_block`` at ``{"model": j}`` gives model rank j's block of
    the dim ``model_split`` names, whole over the other axes (the leaf
    itself where the spec has no ``model``); at ``{}`` the whole leaf; a
    spec that does not fit the mesh raises, naming the leaf."""
    m = mesh(*grid)
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    blocks = sh.shard(x, spec, m, "leaf/x")
    for j in range(dict(zip(m.axes, m.shape))["model"]):
        hit = sh.model_split(spec, shape, m, j)
        want = x if hit is None else x[(slice(None),) * hit[0] + (hit[1],)]
        coords = {} if hit is None else {"model": j}
        got = sh.gather_block(blocks, spec, m, coords, name="leaf/x")
        assert torch.equal(got, want) and got.is_contiguous()
    assert torch.equal(sh.gather_block(blocks, spec, m, {}), x)
    with pytest.raises(ValueError, match="leaf/x.*'pod'"):
        sh.gather_block(blocks, ("pod",), m, {}, name="leaf/x")


def test_shard_refuses_what_it_cannot_place():
    m = mesh(2, 2)
    with pytest.raises(ValueError, match="blocks/attn/wq.*'pod'"):
        sh.shard(torch.zeros(4, 4), ("pod",), m, "blocks/attn/wq")
    with pytest.raises(ValueError, match="embed/embedding.*does not split"):
        sh.shard(torch.zeros(5, 4), ("data",), m, "embed/embedding")
    with pytest.raises(ValueError, match="twice"):
        sh.shard(torch.zeros(4, 4), ("data", "data"), m, "x")
    with pytest.raises(ValueError, match="more entries"):
        sh.shard(torch.zeros(4), ("data", None), m, "x")
    _, tcfg = _configs()
    bad = make_local_mesh(2, 2, device=CPU)
    bad.axes = ("data", "expert")
    with pytest.raises(ValueError, match="expert"):
        make_train_step(tcfg, ParallelConfig(), ShapeConfig("t", "train",
                                                            SEQ, 4), mesh=bad)


def test_restore_shards_each_leaf_by_its_spec(tmp_path):
    m = mesh(2, 2)
    tree = {"a": torch.arange(24.).reshape(4, 6), "b": {"c": torch.ones(3)},
            "n": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(tmp_path, 1, tree, async_=False)
    like = {"a": torch.empty(4, 6, device="meta"),
            "b": {"c": torch.empty(3, device="meta")},
            "n": torch.empty((), dtype=torch.int32, device="meta")}
    specs = {"a": ("data", "model"), "b": {"c": ()}, "n": ()}
    got = ckpt.restore(tmp_path, 1, like, mesh=m, specs=specs)
    assert [tuple(b.shape) for b in got["a"]] == [(2, 3)] * 4
    assert torch.equal(sh.unshard(got["a"], ("data", "model"), m), tree["a"])
    assert all(torch.equal(b, tree["b"]["c"]) for b in got["b"]["c"])
    assert [int(n) for n in got["n"]] == [7] * 4


# ---------------------------------------------------------------------------
# the sharded train step against the JAX trainer
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_run(mb: int, arch=ARCH, n_layers=2, moe_cf=None):
    kw = {} if moe_cf is None else {"capacity_factor": moe_cf}
    jcfg, tcfg = _configs(arch, n_layers, **kw)
    jt = JTrainer(jcfg, jax_local_mesh(1, 1), JParallel(microbatches=mb),
                  JShape("t", "train", SEQ, BATCH))
    js, jl = jt.fit(iter(_batches(tcfg.vocab_size)), STEPS,
                    state=jt.init_state(), log_every=0)
    return jl, jax.tree.map(np.asarray, js.params)


def _port_run(grid, mb, arch=ARCH, n_layers=2, moe_cf=None, moe_impl="gspmd",
              **trainer_kw):
    kw = {} if moe_cf is None else {"capacity_factor": moe_cf}
    _, tcfg = _configs(arch, n_layers, **kw)
    tr = Trainer(tcfg, ParallelConfig(microbatches=mb, moe_impl=moe_impl),
                 ShapeConfig("t", "train", SEQ, BATCH), mesh=mesh(*grid),
                 **trainer_kw)
    state, losses = tr.fit(iter(_batches(tcfg.vocab_size)), STEPS,
                           state=tr.state_from_jax(_jax_params(
                               arch, n_layers, **kw)), log_every=0)
    return tr, state, losses


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("grid", [(2, 2), (4, 1), (1, 4)])
def test_sharded_step_matches_jax_trainer(grid, mb):
    """Reduced qwen3-8b at 2 layers, f32, 3 steps of 8 x 32 tokens: losses
    within 1e-5 relative and every parameter leaf within 1e-5 of the JAX
    trainer on one device, from the same parameters and batches."""
    jl, jparams = _jax_run(mb)
    tr, state, tl = _port_run(grid, mb)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close_tree(tr.state_tree(state)["params"], jparams)
    # each rank holds its block: a sharded leaf's block is a 1/size share
    # of it on (2, 2), (4, 1) and (1, 4) alike, where the rules shard it
    # over both axes
    specs = tr.bundle.info["pspecs"]
    for path, spec in specs.items():
        whole = tr.state_tree(state)["params"]
        for k in path.split("/"):
            whole = whole[k]
        blocks = [r[path] for r in state.params]
        n_used = np.prod([dict(zip(("data", "model"), grid))[a]
                          for e in spec if e for a in (
                              (e,) if isinstance(e, str) else e)] or [1])
        assert all(b.numel() * n_used == whole.numel() for b in blocks)
        assert all(o["mu"][path].shape == blocks[0].shape
                   for o in state.opt_state)


def test_one_rank_mesh_is_the_one_device_trainer():
    _, tcfg = _configs()
    tr = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", SEQ,
                                                      BATCH), mesh=mesh(1, 1))
    assert tr.mesh is None and "pspecs" not in tr.bundle.info
    one = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", SEQ,
                                                       BATCH), device=CPU)
    _, a = tr.fit(iter(_batches(tcfg.vocab_size)), STEPS,
                  state=tr.state_from_jax(_jax_params()), log_every=0)
    _, b = one.fit(iter(_batches(tcfg.vocab_size)), STEPS,
                   state=one.state_from_jax(_jax_params()), log_every=0)
    assert a == b


def test_undivisible_batch_is_computed_once():
    """3 rows on 2 data ranks: the batch is replicated, as the JAX rule
    leaves it, and its loss is that of the one-device step."""
    _, tcfg = _configs()
    shape = ShapeConfig("t", "train", SEQ, 3)
    batch = {k: torch.as_tensor(v) for k, v in _batches(
        tcfg.vocab_size, 1, 3)[0].items()}
    tr = Trainer(tcfg, ParallelConfig(), shape, mesh=mesh(2, 1))
    one = Trainer(tcfg, ParallelConfig(), shape, device=CPU)
    st, ost = tr.state_from_jax(_jax_params()), one.state_from_jax(
        _jax_params())
    assert tr.bundle.info["bspecs"]["tokens"] == (None, None)
    _, _, m = tr.bundle.fn(st.params, st.opt_state, batch)
    _, _, om = one.bundle.fn(ost.params, ost.opt_state, batch)
    assert float(m["loss"]) == float(om["loss"])


# ---------------------------------------------------------------------------
# local-expert MoE
# ---------------------------------------------------------------------------
def _moe_params(jcfg):
    p = jmoe.moe_init(jax.random.key(3), jcfg, jnp.float32)
    host = jax.tree.map(np.asarray, p)
    return p, jax.tree.map(lambda a: torch.from_numpy(a.copy()), host)


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_shardmap_matches_jax_per_data_shard(arch, grid):
    """Each data shard's tokens routed alone at their own capacity (pairs
    drop at cf 1.25), each model rank's experts apart: within 1e-5 of the
    largest |output| of the JAX ``moe_ffn`` on each data shard."""
    jcfg, tcfg = _configs(arch, 4)
    jp, tp = _moe_params(jcfg)
    x = np.random.default_rng(0).normal(size=(2, 64, jcfg.d_model)).astype(
        np.float32)
    with axes_ctx(mesh(*grid), "shardmap"):
        got = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg).numpy()
    flat = x.reshape(-1, jcfg.d_model)
    want = np.concatenate([np.asarray(jmoe.moe_ffn(jp, jnp.asarray(s), jcfg))
                           for s in np.split(flat, grid[0])])
    want = want.reshape(x.shape)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # without the shardmap context, moe_ffn routes all the tokens at once
    whole = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg).numpy()
    ref = np.asarray(jmoe.moe_ffn(jp, jnp.asarray(x), jcfg))
    assert np.abs(whole - ref).max() <= 1e-5 * np.abs(ref).max()


def test_moe_ffn_shardmap_refuses_an_undivided_split():
    jcfg, tcfg = _configs(MOE[0], 4)
    _, tp = _moe_params(jcfg)
    with pytest.raises(ValueError, match="experts"):
        tmoe.moe_ffn_shardmap(tp, torch.zeros(6, jcfg.d_model), tcfg,
                              mesh(4, 1))


@pytest.mark.parametrize("arch", MOE)
def test_shardmap_step_matches_jax_trainer(arch):
    """``moe_impl="shardmap"`` on (2, 2), 4 layers, at capacity factor
    n_experts / top_k (no pair drops, so every data shard's routing is the
    whole batch's): within 1e-5 of the JAX trainer on one device.  The
    reduced qwen2-moe's stacked ``shared`` MLP has its layer axis split
    over ``model`` by the expert rule: each model rank holds 2 layers."""
    jcfg, _ = _configs(arch, 4)
    cf = jcfg.n_experts / jcfg.top_k
    jl, jparams = _jax_run(1, arch, 4, cf)
    tr, state, tl = _port_run((2, 2), 1, arch, 4, cf, "shardmap")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close_tree(tr.state_tree(state)["params"], jparams)
    if arch == MOE[0]:
        blocks = [r["blocks/moe/shared/wg"] for r in state.params]
        assert tr.bundle.info["pspecs"]["blocks/moe/shared/wg"][0] == "model"
        assert [tuple(b.shape) for b in blocks] == [(2, 32, 128)] * 4


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------
def test_elastic_restore_across_meshes(tmp_path):
    """Save on (2, 2) at step 3; restore onto (1, 2), (4, 1) and (1, 1):
    parameters and moments bit-equal to those saved; then 2 more steps on
    each mesh within 1e-5 of the (2, 2) run's own next steps."""
    _, tcfg = _configs()
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    batches = _batches(tcfg.vocab_size, STEPS + 2)
    tr = Trainer(tcfg, ParallelConfig(), shape, mesh=mesh(2, 2),
                 ckpt_dir=str(tmp_path), ckpt_every=STEPS)
    state, _ = tr.fit(iter(batches), STEPS, state=tr.state_from_jax(
        _jax_params()), log_every=0)
    saved = tr.state_tree(state)
    _, want = Trainer(tcfg, ParallelConfig(), shape, mesh=mesh(2, 2)).fit(
        iter(batches[STEPS:]), 2, state=state, log_every=0)
    for grid in ((1, 2), (4, 1), (1, 1)):
        tr2 = Trainer(tcfg, ParallelConfig(), shape, mesh=mesh(*grid),
                      ckpt_dir=str(tmp_path))
        back = tr2.maybe_restore()
        assert back is not None and back.step == STEPS
        tree = tr2.state_tree(back)
        _equal_tree(tree["params"], saved["params"])
        _equal_tree(tree["opt"]["mu"], saved["opt"]["mu"])
        _equal_tree(tree["opt"]["nu"], saved["opt"]["nu"])
        assert int(tree["opt"]["count"]) == STEPS
        back, losses = tr2.fit(iter(batches[STEPS:]), 2, state=back,
                               log_every=0)
        assert back.step == STEPS + 2
        np.testing.assert_allclose(losses, want, rtol=1e-5)


def test_sharded_checkpoint_restores_in_the_jax_trainer(tmp_path):
    """A checkpoint written by the port on (2, 2) restores in the JAX
    trainer bit for bit (it holds whole leaves in the JAX layout)."""
    jcfg, tcfg = _configs()
    tr = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", SEQ,
                                                      BATCH), mesh=mesh(2, 2),
                 ckpt_dir=str(tmp_path), ckpt_every=2)
    state, _ = tr.fit(iter(_batches(tcfg.vocab_size)), 2,
                      state=tr.state_from_jax(_jax_params()), log_every=0)
    jt = JTrainer(jcfg, jax_local_mesh(1, 1), JParallel(),
                  JShape("t", "train", SEQ, BATCH), ckpt_dir=str(tmp_path))
    js = jt.maybe_restore()
    assert js.step == 2 and int(js.opt_state["count"]) == 2
    tree = tr.state_tree(state)
    _equal_tree(tree["params"], jax.tree.map(np.asarray, js.params))
    _equal_tree(tree["opt"]["nu"], jax.tree.map(np.asarray,
                                                js.opt_state["nu"]))


def test_distributed_modules_import_without_jax():
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.launch.mesh, "
            "repro_torch.distributed.context, "
            "repro_torch.distributed.sharding, "
            "repro_torch.distributed.compression, "
            "repro_torch.distributed.steps, repro_torch.train.trainer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(src)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# the JAX trainer on a real (2, 2) mesh of host devices
# ---------------------------------------------------------------------------
JAX_MESH_TRAIN = r"""
import dataclasses, json, numpy as np, jax
from repro.configs import ParallelConfig, get_config, reduced
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_local_mesh
from repro.train.data import SyntheticCorpus
from repro.train.trainer import Trainer
cfg = dataclasses.replace(reduced(get_config("qwen3-8b")), n_layers=2)
tr = Trainer(cfg, make_local_mesh(2, 2), ParallelConfig(),
             ShapeConfig("t", "train", %d, %d))
batches = list(SyntheticCorpus(cfg.vocab_size, 0).batches(%d, %d, %d))
s, losses = tr.fit(iter(batches), %d, log_every=0)
print("LOSSES", json.dumps([float(l) for l in losses]))
print("NORM", json.dumps(np.asarray(s.params["final_norm"]).tolist()))
""" % (SEQ, BATCH, BATCH, SEQ, STEPS, STEPS)


@pytest.mark.integration
def test_port_mesh_matches_jax_trainer_on_host_devices():
    """The JAX trainer on a (2, 2) mesh of 4 host devices against the
    port's (2, 2) run from the same parameters (key 0) and batches, within
    the JAX elastic test's 2e-3."""
    import json
    out = run_with_devices(JAX_MESH_TRAIN, n_devices=4, timeout=900)
    lines = dict(line.split(" ", 1) for line in out.splitlines()
                 if line.startswith(("LOSSES", "NORM")))
    tr, state, tl = _port_run((2, 2), 1)
    np.testing.assert_allclose(tl, json.loads(lines["LOSSES"]), atol=2e-3)
    np.testing.assert_allclose(
        tr.state_tree(state)["params"]["final_norm"].numpy(),
        np.asarray(json.loads(lines["NORM"])), atol=2e-3)


# ---------------------------------------------------------------------------
# the model axis splitting compute under remat
# ---------------------------------------------------------------------------
def _split_grads(grid, remat_mode: str) -> list:
    """One data pass of the sharded train step (data rank 0's rows, every
    model rank's share) with ``remat_mode``: each working slice's f32
    gradients."""
    from repro_torch.distributed.steps import gather_model, shard_model
    from repro_torch.models.convert import params_from_jax
    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, remat=True, remat_mode=remat_mode)
    m = mesh(*grid)
    bundle = make_train_step(tcfg, ParallelConfig(), ShapeConfig(
        "t", "train", SEQ, BATCH), mesh=m)
    info = bundle.info
    params = shard_model(params_from_jax(_jax_params(), tcfg, CPU), info, m)
    work = info["working"](torch.device(CPU))
    for r, model in enumerate(work.slices):
        model.requires_grad_(True)
        gather_model(model, params, info["layout"], info["pspecs"], m,
                     info["slices"], r)
    accs = [{k: torch.zeros(p.shape) for k, p in model.named_parameters()}
            for model in work.slices]
    rows = {k: torch.as_tensor(v)[:BATCH // grid[0]]
            for k, v in _batches(tcfg.vocab_size, 1)[0].items()}
    info["data_pass"](0, work, accs, rows, 1)
    return accs


@pytest.mark.parametrize("grid", [(1, 4), (2, 2)])
def test_split_gradients_under_dots_equal_nothing_bit_for_bit(grid):
    """Under "dots" the backward's recompute is handed the forward's
    weight products in call order, the model-rank loops included: every
    slice's gradients equal those of "nothing" bit for bit."""
    dots, nothing = _split_grads(grid, "dots"), _split_grads(grid, "nothing")
    assert len(dots) == grid[1]
    for a, b in zip(dots, nothing):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert any(float(g.abs().max()) > 0 for acc in dots
               for g in acc.values())
