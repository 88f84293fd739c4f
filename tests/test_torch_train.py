"""The port's training half against the JAX package's, on the CPU.

Twins of ``tests/test_train_substrate.py`` (AdamW, schedule, clipping, the
quadratic problem, the trainer's loss and resume, microbatching), then the
port held to the JAX package on shared inputs: JAX ``init`` parameters
carried across by ``models/convert.py::params_from_jax``, batches drawn
with numpy.  Everything is float32 at the reduced widths.

Tolerances: gradients and one train step within 1e-5 of each leaf's
largest magnitude (float32 sums in other orders); the 10-step loss curves
within 1e-4 relative.  The first AdamW step divides each gradient by its
own magnitude plus ``eps``, so a gradient of about ``eps`` (1e-8) moves
its parameter by up to ``lr`` on float32 noise: the one-step check runs
at the reference's default schedule, where step 1's learning rate is 3e-6,
and the weight-decay rule is pinned separately, on shared gradients, at a
learning rate where a wrong rule shows (``test_adamw_decays_per_layer_
norms_as_jax_does``).  The ETL batches are integers: bit-equal.
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
from repro.core import build_communicator as jax_build_communicator
from repro.distributed.steps import make_train_step as jax_make_train_step
from repro.launch.mesh import make_local_mesh
from repro.models import get_model as jax_get_model
from repro.models import make_concrete_batch as jax_make_concrete_batch
from repro.models import train_batch_shapes as jax_train_batch_shapes
from repro.models.attention import AttnMode as JAttnMode
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer

from repro_torch.configs import ParallelConfig, ShapeConfig, get_config, reduced
from repro_torch.core import build_communicator, logical_devices
from repro_torch.distributed.steps import _attn_mode, make_train_step
from repro_torch.kernels.flash_attention.ops import FlashAttention
from repro_torch.models import get_model, make_concrete_batch, train_batch_shapes
from repro_torch.models import attention as TA
from repro_torch.models.convert import (decayed_names, jax_tree,
                                        params_from_jax, params_to_jax)
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer

CPU = "cpu"
ARCH = "qwen3-8b"           # dense, qk_norm: per-layer q_norm / k_norm


def _configs(arch=ARCH, n_layers=2):
    return (dataclasses.replace(jreduced(jget(arch)), n_layers=n_layers),
            dataclasses.replace(reduced(get_config(arch)), n_layers=n_layers))


def _walk(a, b, path=""):
    """Pairs of leaves of two nested dicts with the same keys."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _walk(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _close_per_leaf(port: dict, ref: dict, tol=1e-5):
    for path, p, r in _walk(port, ref):
        p = p.detach().numpy() if isinstance(p, torch.Tensor) else \
            np.asarray(p)
        r = np.asarray(r)
        assert p.shape == r.shape, path
        err = np.abs(p - r).max()
        assert err <= tol * np.abs(r).max(), (path, err, np.abs(r).max())


@functools.lru_cache(maxsize=None)
def _jax_params(arch=ARCH, n_layers=2, seed=0):
    jcfg, _ = _configs(arch, n_layers)
    params = jax_get_model(jcfg).init(jax.random.key(seed), jcfg)
    return params, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# optimizer: twins of test_train_substrate.py
# ---------------------------------------------------------------------------
def test_adamw_matches_numpy_reference():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    g = rng.normal(size=(4, 3)).astype(np.float32)
    cfg = opt.OptimizerConfig(peak_lr=1e-2, warmup_steps=0, total_steps=10,
                              weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.from_numpy(p0.copy())}
    state = opt.adamw_init(params)
    new_p, state, _ = opt.adamw_update({"w": torch.from_numpy(g)}, state,
                                       params, cfg)
    mu = 0.1 * g
    nu = 0.05 * g * g
    mu_hat = mu / (1 - 0.9)
    nu_hat = nu / (1 - 0.95)
    lr = opt.cosine_schedule(cfg, 1)
    want = p0 - float(lr) * mu_hat / (np.sqrt(nu_hat) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), want, atol=1e-5)
    assert int(state["count"]) == 1 and state["mu"]["w"].dtype == \
        torch.float32


def test_cosine_schedule_shape():
    cfg = opt.OptimizerConfig(peak_lr=1.0, min_lr_ratio=0.1, warmup_steps=10,
                              total_steps=110)
    assert float(opt.cosine_schedule(cfg, 0)) == 0.0
    assert float(opt.cosine_schedule(cfg, 10)) == pytest.approx(1.0, abs=1e-3)
    assert float(opt.cosine_schedule(cfg, 110)) == pytest.approx(0.1, abs=1e-3)
    assert float(opt.cosine_schedule(cfg, 60)) == pytest.approx(0.55, abs=0.01)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 57, 110, 200])
def test_cosine_schedule_matches_jax(step):
    kw = dict(peak_lr=3e-3, min_lr_ratio=0.1, warmup_steps=10,
              total_steps=110)
    assert float(opt.cosine_schedule(opt.OptimizerConfig(**kw), step)) == \
        float(jopt.cosine_schedule(jopt.OptimizerConfig(**kw), step))


def test_grad_clipping():
    cfg = opt.OptimizerConfig(clip_norm=1.0, warmup_steps=0, peak_lr=1.0,
                              weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    state = opt.adamw_init(params)
    g = {"w": torch.tensor([100.0, 0.0, 0.0])}
    _, _, metrics = opt.adamw_update(g, state, params, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)


def test_adamw_converges_quadratic():
    cfg = opt.OptimizerConfig(peak_lr=0.1, warmup_steps=0, total_steps=200,
                              weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, state, _ = opt.adamw_update(g, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_adamw_matches_jax_over_steps():
    """Five updates of a matrix, a vector and a bf16 matrix from the same
    gradients, with clipping and decay on: f32 moments, the cast back to
    bf16 after each step."""
    rng = np.random.default_rng(3)
    shapes = {"m": (6, 5), "v": (7,), "h": (4, 8)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5)
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "h" else jnp.float32)
          for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "h" else
                                    torch.float32) for k, v in p0.items()}
    js, ts = jopt.adamw_init(jp), opt.adamw_init(tp)
    for _ in range(5):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        jp, js, jm = jopt.adamw_update(
            {k: jnp.asarray(v, jp[k].dtype) for k, v in g.items()}, js, jp,
            jopt.OptimizerConfig(**kw))
        tp, ts, tm = opt.adamw_update(
            {k: torch.from_numpy(v).to(tp[k].dtype) for k, v in g.items()},
            ts, tp, opt.OptimizerConfig(**kw))
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
    assert tp["h"].dtype == torch.bfloat16
    for k in shapes:
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(
            js["nu"][k]), rtol=1e-6, atol=1e-12)
    assert int(ts["count"]) == int(js["count"]) == 5


# ---------------------------------------------------------------------------
# the weight-decay rule (per-layer norms decay in the reference)
# ---------------------------------------------------------------------------
def test_decayed_names_follow_the_jax_layout():
    _, tcfg = _configs()
    _, host = _jax_params()
    model = params_from_jax(host, tcfg, CPU)
    named = dict(model.named_parameters())
    dec = decayed_names(named, tcfg)
    assert "final_norm" not in dec
    for i in range(tcfg.n_layers):
        for k in ("attn.ln", "attn.q_norm", "attn.k_norm", "mlp.ln",
                  "attn.wq", "mlp.wo"):
            assert f"layers.{i}.{k}" in dec
    assert {"embed.embedding", "embed.lm_head"} <= dec
    # the reference's own rule on its own (stacked) leaves picks the same
    jdec = {p for p, leaf, _ in _walk(host, host) if np.ndim(leaf) >= 2}
    flags = jax_tree({k: torch.full_like(p, float(k in dec))
                      for k, p in named.items()}, tcfg)
    assert jdec == {p for p, leaf, _ in _walk(flags, flags)
                    if bool((leaf == 1).all())}
    assert "/final_norm" not in jdec and "/blocks/attn/ln" in jdec


def test_adamw_decays_per_layer_norms_as_jax_does():
    """From the JAX package's own gradients of one batch, the port's update
    with ``decayed_names`` equals the JAX update (norms included), and the
    update that decays only the port's own 2-D tensors does not: it leaves
    every per-layer norm lr * wd * |p| away."""
    jcfg, tcfg = _configs()
    params, host = _jax_params()
    rng = np.random.default_rng(1)
    tok = rng.integers(0, jcfg.vocab_size, (4, 32), dtype=np.int32)
    jgrads = jax.jit(jax.grad(lambda p: jax_get_model(jcfg).loss_fn(
        p, jcfg, {"tokens": tok, "labels": tok}, JAttnMode(kind="full"))))(
            params)
    kw = dict(peak_lr=1e-2, warmup_steps=0, total_steps=100)
    jnew, _, _ = jax.jit(functools.partial(
        jopt.adamw_update, cfg=jopt.OptimizerConfig(**kw)))(
            jgrads, jopt.adamw_init(params), params)
    ref = jax.tree.map(np.asarray, jnew)
    grads_named = {k: g for k, g in dict(params_from_jax(
        jax.tree.map(np.asarray, jgrads), tcfg, CPU).named_parameters()
    ).items()}
    outs = {}
    for rule in ("jax_layout", "own_layout"):
        model = params_from_jax(host, tcfg, CPU)
        named = dict(model.named_parameters())
        decay = decayed_names(named, tcfg) if rule == "jax_layout" else None
        opt.adamw_update(grads_named, opt.adamw_init(named), named,
                         opt.OptimizerConfig(**kw), decay=decay)
        outs[rule] = params_to_jax(model)
    _close_per_leaf(outs["jax_layout"], ref, tol=1e-6)
    wrong = np.abs(outs["own_layout"]["blocks"]["attn"]["ln"]
                   - ref["blocks"]["attn"]["ln"]).max()
    assert wrong == pytest.approx(1e-2 * 0.1, rel=1e-3)


# ---------------------------------------------------------------------------
# one train step, and ten, against the JAX package's
# ---------------------------------------------------------------------------
def _batch(vocab, b=4, s=32, seed=1):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s),
                                               dtype=np.int32)
    return {"tokens": tok, "labels": tok}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_gradients_match_jax():
    jcfg, tcfg = _configs()
    params, host = _jax_params()
    batch = _batch(jcfg.vocab_size)
    jgrads = jax.jit(jax.grad(lambda p: jax_get_model(jcfg).loss_fn(
        p, jcfg, batch, JAttnMode(kind="full"))))(params)
    model = params_from_jax(host, tcfg, CPU).requires_grad_()
    loss = get_model(tcfg).loss_fn(model, tcfg, _torch_batch(batch),
                                   TA.AttnMode(kind="full"))
    loss.backward()
    port = jax_tree({k: p.grad for k, p in model.named_parameters()}, tcfg)
    _close_per_leaf(port, jax.tree.map(np.asarray, jgrads))


def test_train_step_matches_jax():
    """One step of each package's train step at the reference's default
    optimizer settings: loss, grad norm and every leaf after the update,
    the per-layer norms included."""
    jcfg, tcfg = _configs()
    params, host = _jax_params()
    batch = _batch(jcfg.vocab_size)
    mesh = make_local_mesh(1, 1)
    with mesh:
        jb = jax_make_train_step(jcfg, mesh, JParallel(),
                                 JShape("t", "train", 32, 4))
        jnew, _, jm = jb.fn(params, jopt.adamw_init(params), dict(batch))
    model = params_from_jax(host, tcfg, CPU).requires_grad_()
    state = opt.adamw_init(dict(model.named_parameters()))
    tb = make_train_step(tcfg, ParallelConfig(), ShapeConfig("t", "train",
                                                             32, 4))
    _, state, tm = tb.fn(model, state, _torch_batch(batch))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert float(tm["lr"]) == float(jm["lr"])
    ref = jax.tree.map(np.asarray, jnew)
    _close_per_leaf(params_to_jax(model), ref)
    # the per-layer norms moved (decay and Adam), and moved alike
    assert not np.array_equal(ref["blocks"]["attn"]["q_norm"],
                              host["blocks"]["attn"]["q_norm"])


def test_ten_step_losses_match_jax():
    jcfg, tcfg = _configs()
    _, host = _jax_params()
    kw = dict(peak_lr=3e-3, warmup_steps=5, total_steps=10)
    jt = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(),
                  JShape("t", "train", 64, 8), jopt.OptimizerConfig(**kw))
    _, jl = jt.fit(jdata.SyntheticCorpus(jcfg.vocab_size, 0).batches(8, 64,
                                                                      10),
                   10, state=jt.init_state(), log_every=0)
    tt = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", 64, 8),
                 opt.OptimizerConfig(**kw), device=CPU)
    # the JAX trainer's init_state draws from key 0, as _jax_params does
    _, tl = tt.fit(tdata.SyntheticCorpus(tcfg.vocab_size, 0).batches(8, 64,
                                                                      10),
                   10, state=tt.state_from_jax(host), log_every=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_microbatches_match_jax():
    jcfg, tcfg = _configs()
    params, host = _jax_params()
    batch = _batch(jcfg.vocab_size)
    mesh = make_local_mesh(1, 1)
    with mesh:
        jb = jax_make_train_step(jcfg, mesh, JParallel(microbatches=2),
                                 JShape("t", "train", 32, 4))
        jnew, _, jm = jb.fn(params, jopt.adamw_init(params), dict(batch))
    model = params_from_jax(host, tcfg, CPU).requires_grad_()
    state = opt.adamw_init(dict(model.named_parameters()))
    tb = make_train_step(tcfg, ParallelConfig(microbatches=2),
                         ShapeConfig("t", "train", 32, 4))
    _, _, tm = tb.fn(model, state, _torch_batch(batch))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _close_per_leaf(params_to_jax(model), jax.tree.map(np.asarray, jnew))


def test_grad_accum_equivalence():
    """microbatches=2 must equal a single big batch step (same grads)."""
    _, tcfg = _configs("granite-3-8b")
    shape = ShapeConfig("t", "train", 16, 4)
    rng = np.random.default_rng(0)
    batch = make_concrete_batch(train_batch_shapes(tcfg, 4, 16), rng,
                                tcfg.vocab_size, CPU)
    out = []
    for mb in (1, 2):
        gen = torch.Generator().manual_seed(0)
        model = get_model(tcfg).init(gen, tcfg, trainable=True)
        step = make_train_step(tcfg, ParallelConfig(microbatches=mb), shape)
        _, _, m = step.fn(model, opt.adamw_init(dict(
            model.named_parameters())), dict(batch))
        out.append((float(m["loss"]), model.final_norm.detach().clone()))
    assert out[0][0] == pytest.approx(out[1][0], abs=1e-4)
    np.testing.assert_allclose(out[0][1].numpy(), out[1][1].numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("arch", [ARCH, "internvl2-1b", "whisper-medium"])
def test_concrete_batch_matches_jax(arch):
    """One seed draws the same batch in both packages, bit for bit: the
    int32 tokens and labels, and the VLM's bf16 ``prefix_embeds`` and the
    audio model's bf16 ``frames`` (the port draws f32 and casts, the JAX
    package casts from f64; both round to bf16 through f32)."""
    jcfg, tcfg = _configs(arch)
    jb = jax_make_concrete_batch(jax_train_batch_shapes(jcfg, 3, 16),
                                 np.random.default_rng(5), jcfg.vocab_size)
    tb = make_concrete_batch(train_batch_shapes(tcfg, 3, 16),
                             np.random.default_rng(5), tcfg.vocab_size, CPU)
    assert set(jb) == set(tb) == set(train_batch_shapes(tcfg, 3, 16))
    for k in jb:
        want = np.asarray(jb[k])
        if k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            got = tb[k].numpy()
        else:
            assert tb[k].dtype == torch.bfloat16
            got = tb[k].view(torch.int16).numpy().view(want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=k)


# ---------------------------------------------------------------------------
# models: trainable, remat, conversion both ways
# ---------------------------------------------------------------------------
def test_params_to_jax_inverts_params_from_jax():
    _, tcfg = _configs()
    _, host = _jax_params()
    back = params_to_jax(params_from_jax(host, tcfg, CPU))
    for path, p, r in _walk(back, host):
        assert p.dtype == r.dtype and p.shape == r.shape, path
        np.testing.assert_array_equal(p, r, err_msg=path)


def test_serving_models_stay_frozen_and_init_can_train():
    _, tcfg = _configs()
    gen = torch.Generator().manual_seed(0)
    assert not any(p.requires_grad
                   for p in get_model(tcfg).init(gen, tcfg).parameters())
    assert all(p.requires_grad for p in get_model(tcfg).init(
        gen, tcfg, trainable=True).parameters())
    _, host = _jax_params()
    assert not any(p.requires_grad
                   for p in params_from_jax(host, tcfg, CPU).parameters())


@functools.lru_cache(maxsize=None)
def _remat_grads(remat: bool, mode: str) -> list:
    """The loss and gradients of one step under ``cfg.remat`` and
    ``remat_mode`` (kept: each case compares with the same remat=False
    run)."""
    _, tcfg = _configs()
    _, host = _jax_params()
    cfg = dataclasses.replace(tcfg, remat=remat, remat_mode=mode)
    model = params_from_jax(host, cfg, CPU).requires_grad_()
    loss = get_model(cfg).loss_fn(model, cfg,
                                  _torch_batch(_batch(tcfg.vocab_size)),
                                  TA.AttnMode(kind="full"))
    loss.backward()
    return [loss.detach()] + [p.grad for p in model.parameters()]


@pytest.mark.parametrize("mode", ["none", "nothing", "dots"])
def test_remat_changes_no_number(mode):
    """cfg.remat wraps each layer in torch.utils.checkpoint as
    ``remat_mode`` says (none, the whole layer, or all but its weight
    products): the same loss and the same gradients, bit for bit, on the
    CPU."""
    assert all(torch.equal(a, b) for a, b in zip(
        _remat_grads(False, "none"), _remat_grads(True, mode)))


def test_attn_mode_matches_jax_train_step():
    from repro.distributed.steps import _attn_mode as jax_attn_mode
    jcfg, tcfg = _configs()
    for seq in (128, 1024, 1025, 2048):
        jm = jax_attn_mode(jcfg, JParallel(attn_block=256), seq)
        tm = _attn_mode(tcfg, ParallelConfig(attn_block=256), seq)
        assert (tm.kind, tm.q_block, tm.kv_block) == \
            (jm.kind, jm.q_block, jm.kv_block)


# ---------------------------------------------------------------------------
# the kernels under autograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,s", [(TA.AttnMode(kind="full"), 40),
                                    (TA.AttnMode(q_block=16, kv_block=16),
                                     48)])
def test_flash_attention_function_backward_is_plain_autograd(mode, s):
    """The autograd Function (forward through the wrapper: its plain version
    on the CPU) gives exactly the gradients of autograd through the plain
    path it is given: attend_full, or attend_blockwise past q_block."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, h, 16)).astype(
        np.float32)).requires_grad_() for h in (4, 2, 2))
    g = torch.from_numpy(rng.standard_normal((2, s, 4, 16)).astype(
        np.float32))
    plain = functools.partial(TA.attend_plain, mode=mode)
    out = FlashAttention.apply(q, k, v, True, plain)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref_out = plain(q, k, v, causal=True)
    want = torch.autograd.grad(ref_out, (q, k, v), g)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # only the inputs that ask for a gradient get one
    qd = q.detach().requires_grad_()
    (gq,) = torch.autograd.grad(
        FlashAttention.apply(qd, k.detach(), v.detach(), True, plain), (qd,),
        g)
    assert torch.equal(gq, want[0])


# ---------------------------------------------------------------------------
# the trainer: twins of test_train_substrate.py, and across packages
# ---------------------------------------------------------------------------
def test_trainer_loss_decreases_and_resumes(tmp_path):
    _, cfg = _configs("granite-3-8b")
    shape = ShapeConfig("t", "train", 32, 4)
    tr = Trainer(cfg, ParallelConfig(), shape, ckpt_dir=str(tmp_path),
                 ckpt_every=10, device=CPU)
    corpus = tdata.SyntheticCorpus(cfg.vocab_size, 0)
    state, losses = tr.fit(corpus.batches(4, 32, 20), steps=20, log_every=0)
    assert losses[-1] < losses[0]
    from repro_torch.train.checkpoint import latest_step
    assert latest_step(tmp_path) == 20

    tr2 = Trainer(cfg, ParallelConfig(), shape, ckpt_dir=str(tmp_path),
                  device=CPU)
    st2 = tr2.maybe_restore()
    assert st2 is not None and st2.step == 20
    for a, b in zip(st2.params.parameters(), state.params.parameters()):
        assert torch.equal(a, b)
    for k, m in state.opt_state["nu"].items():
        assert torch.equal(st2.opt_state["nu"][k], m)
    assert int(st2.opt_state["count"]) == 20
    st3, _ = tr2.fit(corpus.batches(4, 32, 3), steps=3, state=st2,
                     log_every=0)
    assert st3.step == 23


def test_resume_continues_the_same_curve(tmp_path):
    """Steps 7-10 after a restore from step 6 equal steps 7-10 of the run
    that never stopped (the CPU sums in one order: bit for bit)."""
    _, cfg = _configs()
    shape = ShapeConfig("t", "train", 32, 4)
    ocfg = opt.OptimizerConfig(peak_lr=3e-3, warmup_steps=2, total_steps=10)
    batches = list(tdata.SyntheticCorpus(cfg.vocab_size, 0).batches(4, 32,
                                                                     10))
    tr = Trainer(cfg, ParallelConfig(), shape, ocfg, ckpt_dir=str(tmp_path),
                 ckpt_every=6, device=CPU)
    _, whole = tr.fit(batches, 10, log_every=0)
    tr2 = Trainer(cfg, ParallelConfig(), shape, ocfg, ckpt_dir=str(tmp_path),
                  device=CPU)
    st = tr2.maybe_restore()
    assert st.step == 6
    _, tail = tr2.fit(batches[6:], 4, state=st, log_every=0)
    assert tail == whole[6:]


def test_checkpoints_cross_restore_between_trainers(tmp_path):
    """A JAX trainer's checkpoint restores in the port's trainer and the
    port's in the JAX trainer's, bit for bit (f32): the same keys, the
    layers stacked."""
    jcfg, tcfg = _configs()
    shape = (32, 4)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jt = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(),
                  JShape("t", "train", *shape), ckpt_dir=str(jdir),
                  ckpt_every=3)
    js, _ = jt.fit(jdata.SyntheticCorpus(jcfg.vocab_size, 0).batches(4, 32,
                                                                      3),
                   3, log_every=0)
    tt = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", *shape),
                 ckpt_dir=str(jdir), device=CPU)
    ts = tt.maybe_restore()
    assert ts.step == 3 and int(ts.opt_state["count"]) == 3
    for path, p, r in _walk(params_to_jax(ts.params),
                            jax.tree.map(np.asarray, js.params)):
        np.testing.assert_array_equal(p, r, err_msg=path)
    for path, p, r in _walk(jax_tree(ts.opt_state["mu"], tcfg),
                            jax.tree.map(np.asarray, js.opt_state["mu"])):
        np.testing.assert_array_equal(p.numpy(), r, err_msg=path)

    tt2 = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", *shape),
                  ckpt_dir=str(tdir), ckpt_every=5, device=CPU)
    ts2, _ = tt2.fit(tdata.SyntheticCorpus(tcfg.vocab_size, 0).batches(
        4, 32, 2), 2, state=ts, log_every=0)
    jt2 = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(),
                   JShape("t", "train", *shape), ckpt_dir=str(tdir))
    js2 = jt2.maybe_restore()
    assert js2.step == 5 and int(js2.opt_state["count"]) == 5
    for path, p, r in _walk(params_to_jax(ts2.params),
                            jax.tree.map(np.asarray, js2.params)):
        np.testing.assert_array_equal(p, r, err_msg=path)


# ---------------------------------------------------------------------------
# data: the synthetic corpus and the ETL stage
# ---------------------------------------------------------------------------
def test_synthetic_corpus_and_events_match_jax():
    jb = list(jdata.SyntheticCorpus(512, 3).batches(2, 16, 3))
    tb = list(tdata.SyntheticCorpus(512, 3).batches(2, 16, 3))
    for a, b in zip(jb, tb, strict=True):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    je, te = jdata.make_events(5000, 512, 1), tdata.make_events(5000, 512, 1)
    for k in je:
        np.testing.assert_array_equal(je[k], te[k])


def _etl_inputs(n=1 << 14):
    events = tdata.make_events(n, 512, seed=0)
    meta = {"doc_id": np.arange(256, dtype=np.int32),
            "weight": np.ones(256, np.float32)}
    return events, meta


def _port_etl(ranks):
    events, meta = _etl_inputs()
    comm = build_communicator(logical_devices(ranks, CPU))
    return list(tdata.etl_token_batches(
        comm, events, meta, batch=4, seq=32,
        capacity_per_rank=len(events["event_id"]) // ranks * 2 + 64))


def test_etl_token_batches_match_jax_one_rank():
    events, meta = _etl_inputs()
    jcomm = jax_build_communicator(jax.devices()[:1], axes=("df",))
    want = list(jdata.etl_token_batches(
        jcomm, events, meta, batch=4, seq=32,
        capacity_per_rank=len(events["event_id"]) * 2 + 64))
    got = _port_etl(1)
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        assert a["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


_JAX_P2_ETL = r"""
import numpy as np, jax
from repro.core import build_communicator
from repro.train.data import etl_token_batches, make_events
events = make_events(1 << 14, 512, seed=0)
meta = {"doc_id": np.arange(256, dtype=np.int32),
        "weight": np.ones(256, np.float32)}
comm = build_communicator(jax.devices(), axes=("df",))
assert comm.size == 2
out = list(etl_token_batches(comm, events, meta, batch=4, seq=32,
                             capacity_per_rank=len(events["event_id"]) // 2
                             * 2 + 64))
np.save(OUT, np.stack([b["tokens"] for b in out]))
print("ETL2_OK")
"""


def test_etl_token_batches_match_jax_two_ranks(tmp_path):
    """At P = 2 the join hashes and the sample sort splits across two
    ranks; the JAX side runs on 2 host devices in a fresh interpreter."""
    out = tmp_path / "etl2.npy"
    assert "ETL2_OK" in run_with_devices(f"OUT = {str(out)!r}\n"
                                         + _JAX_P2_ETL, n_devices=2)
    want = np.load(out)
    got = _port_etl(2)
    assert len(got) == len(want) > 10
    np.testing.assert_array_equal(np.stack([b["tokens"] for b in got]), want)


# ---------------------------------------------------------------------------
# the driver, and the package's imports
# ---------------------------------------------------------------------------
def test_train_lm_runs_etl_then_trains_and_resumes(tmp_path, capsys):
    """python -m repro_torch.train_lm on the CPU: the ETL stage on 4
    logical ranks feeds the ci preset; a re-run resumes from the last
    checkpoint, which the JAX package's trainer also restores."""
    from repro_torch.train_lm import main
    ck = str(tmp_path / "ck")
    main(["--device", "cpu", "--steps", "12", "--ckpt", ck])
    out = capsys.readouterr().out
    assert "[etl] produced" in out and "on 4 ranks" in out
    # the re-run starts the data stream over at the schedule's floor, as
    # the reference driver does; whether its loss falls is not the point
    try:
        main(["--device", "cpu", "--steps", "12", "--ckpt", ck])
    except SystemExit as e:
        assert str(e) == "loss did not decrease"
    assert "[resume] restored step 10" in capsys.readouterr().out
    from repro.train.checkpoint import latest_step as jax_latest_step
    assert jax_latest_step(ck) == 20


def test_train_modules_import_without_jax():
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.train_lm, repro_torch.train.trainer, "
            "repro_torch.train.checkpoint, repro_torch.distributed.steps, "
            "repro_torch.obs.perfetto\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(src)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
