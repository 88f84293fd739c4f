"""The port's VLM family (internvl2-1b: the transformer with stub patch
embeddings before the tokens) and audio family (whisper-medium: the
encoder-decoder over stub frame embeddings) against the JAX package's, on
the CPU.

Parameters are the JAX ``init`` params carried across by
``models/convert.py::params_from_jax``; tokens, patch and frame
embeddings are drawn with numpy from a seed.  Everything is float32 at the
reduced widths of the JAX tests (2 layers; whisper's encoder 2 layers over
16 frames, internvl2's 8 patches), and the JAX side runs under
``jax.jit``.  Tolerances: forward, loss, prefill, caches and decode
within 1e-5 (float32 sums in other orders); gradients and one train step
within 1e-5 of each leaf's largest magnitude; 10-step losses within 1e-4
relative (as ``test_torch_train.py``); conversion and checkpoints bit for
bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as JParallel
from repro.configs import get_config, reduced
from repro.configs.base import ShapeConfig as JShape
from repro.distributed.steps import make_train_step as jax_make_train_step
from repro.launch.mesh import make_local_mesh
from repro.models import get_model as jax_get_model
from repro.models import train_batch_shapes as jax_train_batch_shapes
from repro.models.attention import AttnMode as JAttnMode
from repro.models.registry import prefill_batch_shapes as \
    jax_prefill_batch_shapes
from repro.serve.continuous import cache_batch_axes as jax_cache_batch_axes
from repro.train import checkpoint as jck
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer

from repro_torch.configs import ParallelConfig, ShapeConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.distributed.steps import make_train_step
from repro_torch.models import attention as TA
from repro_torch.models import encdec, get_model
from repro_torch.models import train_batch_shapes
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (decayed_names, jax_tree,
                                        params_from_jax, params_to_jax)
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.models.registry import prefill_batch_shapes
from repro_torch.serve.continuous import cache_batch_axes
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer

VLM, AUDIO = "internvl2-1b", "whisper-medium"
ARCHS = (VLM, AUDIO)
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(arch, n_layers=2):
    return (dataclasses.replace(reduced(get_config(arch)), n_layers=n_layers),
            dataclasses.replace(t_reduced(t_get_config(arch)),
                                n_layers=n_layers))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed=0):
    jcfg, _ = _configs(arch)
    params = jax_get_model(jcfg).init(jax.random.key(seed), jcfg)
    return params, jax.tree.map(np.asarray, params)


def _models(arch):
    jcfg, tcfg = _configs(arch)
    params, host = _jax_params(arch)
    return jcfg, tcfg, params, params_from_jax(host, tcfg, "cpu")


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _modal(cfg, b, seed):
    """The stub frontend's input of ``cfg``'s family, f32 from a seed."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"prefix_embeds": rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    return {"frames": rng.standard_normal(
        (b, cfg.n_encoder_frames, cfg.d_model)).astype(np.float32)}


def _batches(cfg, tokens, seed=9, labels=True):
    """The same batch for both packages: tokens (and labels), the modal
    input."""
    b = {"tokens": tokens, **_modal(cfg, len(tokens), seed)}
    if labels:
        b["labels"] = tokens
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _walk(a, b, path=""):
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
        assert np.abs(p - r).max() <= tol * np.abs(r).max(), path


# ---------------------------------------------------------------------------
# layers and the model API
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_pos,d", [(16, 64), (1500, 1024), (7, 10)])
def test_sinusoidal_positions_are_the_jax_table(n_pos, d):
    from repro.models.layers import sinusoidal_positions as jsin
    got = sinusoidal_positions(n_pos, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_pos, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsin(n_pos, d)))


@pytest.mark.parametrize("arch", ARCHS)
def test_get_model_takes_the_family_at_published_widths(arch):
    cfg = t_get_config(arch)
    api = get_model(cfg)
    if arch == VLM:
        assert api.init is TT.init and api.prefill is TT.prefill
    else:
        assert api.init is encdec.init and api.decode_step is \
            encdec.decode_step


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    """The VLM's logits cover the patches and the tokens; its loss counts
    the tokens only (sliced past the prefix, as the JAX loss is)."""
    jcfg, tcfg, params, model = _models(arch)
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    jb, tb = _batches(jcfg, _tokens(jcfg, 2, 9, 1))
    with torch.inference_mode():
        logits = api.forward(model, tcfg, tb)
        loss = api.loss_fn(model, tcfg, tb)
    want = _jit(japi.forward, 1)(params, jcfg, jb)
    assert tuple(logits.shape) == want.shape
    assert want.shape[1] == 9 + (jcfg.n_patches if arch == VLM else 0)
    _close(logits, want)
    _close(loss, _jit(japi.loss_fn, 1)(params, jcfg, jb))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill over 6 tokens (after the patches, or with the frames), then
    three decode steps at the engines' positions (offset by n_patches for
    the VLM); every cache leaf within 1e-5 after each."""
    jcfg, tcfg, params, model = _models(arch)
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    toks = _tokens(jcfg, 2, 9, 3)
    jb, tb = _batches(jcfg, toks[:, :6], labels=False)
    jc, jl = _jit(japi.prefill, 1, 3)(params, jcfg, jb, 24)
    with torch.inference_mode():
        tc, tl = api.prefill(model, tcfg, tb, 24)
    _close(tl, jl)
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])
    off = jcfg.n_patches if arch == VLM else 0
    jdecode = _jit(japi.decode_step, 1)
    for t in range(6, 9):
        jl, jc = jdecode(params, jcfg, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "positions": jnp.full((2,), off + t, jnp.int32)}, jc)
        with torch.inference_mode():
            tl, tc = api.decode_step(model, tcfg, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "positions": torch.full((2,), off + t)}, tc)
        _close(tl, jl)
        for name in jc:
            _close(tc[name], jc[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_axes_and_cache_init_match_jax(arch):
    """The continuous engine's probe finds every leaf's batch axis where the
    JAX engine's does: whisper's cross caches ``xk``/``xv`` (L, B, F, H, hd)
    included."""
    jcfg, tcfg, params, model = _models(arch)
    axes, spec = cache_batch_axes(tcfg, model, 24)
    jaxes, jspec = jax_cache_batch_axes(jcfg, params, 24)
    assert axes == dict(jaxes)
    if arch == AUDIO:
        assert axes == {"k": 1, "v": 1, "xk": 1, "xv": 1}
    jcache = jax_get_model(jcfg).cache_init(jcfg, 3, 24)
    cache = get_model(tcfg).cache_init(tcfg, 3, 24)
    for name in jspec:
        assert tuple(spec[name].shape) == jspec[name].shape
        assert spec[name].device.type == "meta"
        assert tuple(cache[name].shape) == jcache[name].shape
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(jcache[name].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_jax_shapes_and_dtypes(arch):
    """A bf16 model drawn from a generator: every leaf in the JAX layout has
    the shape and dtype of the JAX init's (``eval_shape``); the parameter
    count is the config's; the same seed draws the same weights; serving
    models carry no gradient."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _configs(arch))
    want = jax.eval_shape(lambda: jax_get_model(jcfg).init(
        jax.random.key(0), jcfg))
    model = get_model(tcfg).init(torch.Generator().manual_seed(3), tcfg)
    got = jax_tree(dict(model.named_parameters()), tcfg)
    want_flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(got_flat) == set(want_flat)
    for path, leaf in want_flat.items():
        assert tuple(got_flat[path].shape) == leaf.shape, path
        assert str(got_flat[path].dtype).removeprefix("torch.") == \
            str(leaf.dtype), path
    assert TT.param_count(model) == tcfg.param_count() == \
        jcfg.param_count()
    again = get_model(tcfg).init(torch.Generator().manual_seed(3), tcfg)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_decay_rule(arch):
    """``params_to_jax(params_from_jax(tree))`` is ``tree`` bit for bit, and
    ``decayed_names`` picks the JAX leaves of ``ndim >= 2``: every stacked
    per-layer tensor, norms included, but not ``final_norm`` nor
    whisper's ``enc_norm``."""
    _, tcfg, _, model = _models(arch)
    _, host = _jax_params(arch)
    back = params_to_jax(model)
    want_flat = dict(jax.tree_util.tree_flatten_with_path(host)[0])
    got_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got_flat) == set(want_flat)
    for path, leaf in want_flat.items():
        assert got_flat[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got_flat[path], leaf, err_msg=str(path))
    named = dict(model.named_parameters())
    dec = decayed_names(named, tcfg)
    flags = jax_tree({k: torch.full_like(p, float(k in dec))
                      for k, p in named.items()}, tcfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(flags)[0]:
        assert bool((leaf == 1).all()) == (want_flat[path].ndim >= 2), path
    assert "final_norm" not in dec
    if arch == AUDIO:
        assert "enc_norm" not in dec
        assert {"encoder.1.ln1", "decoder.0.ln3", "decoder.1.cross.wk"} <= dec


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shapes_match_jax(arch):
    """The train and prefill batch builders give the JAX package's names,
    shapes and dtypes, the patch and frame embeddings bf16 (the batches
    they draw: ``test_torch_train.py::test_concrete_batch_matches_jax``)."""
    jcfg, tcfg = _configs(arch)
    for jfn, tfn in ((jax_train_batch_shapes, train_batch_shapes),
                     (jax_prefill_batch_shapes, prefill_batch_shapes)):
        js, ts = jfn(jcfg, 3, 16), tfn(tcfg, 3, 16)
        assert set(js) == set(ts)
        for k, (shape, dtype) in js.items():
            assert ts[k][0] == shape
            assert str(ts[k][1]).removeprefix("torch.") == \
                np.dtype(dtype).name


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _train_batch(cfg, seed=1):
    tok = _tokens(cfg, 4, 16, seed)
    return {"tokens": tok, "labels": tok, **_modal(cfg, 4, seed + 100)}


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    params, host = _jax_params(arch)
    batch = _train_batch(jcfg)
    jgrads = jax.jit(jax.grad(lambda p: jax_get_model(jcfg).loss_fn(
        p, jcfg, batch, JAttnMode(kind="full"))))(params)
    model = params_from_jax(host, tcfg, "cpu").requires_grad_()
    get_model(tcfg).loss_fn(model, tcfg, {
        k: torch.from_numpy(v) for k, v in batch.items()},
        TA.AttnMode(kind="full")).backward()
    port = jax_tree({k: p.grad for k, p in model.named_parameters()}, tcfg)
    _close_per_leaf(port, jax.tree.map(np.asarray, jgrads))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One step of each package's train step at the reference's default
    optimizer settings: loss, grad norm, and every leaf after the update
    (whisper's cross-attention and both stacks' norms included)."""
    jcfg, tcfg = _configs(arch)
    params, host = _jax_params(arch)
    batch = _train_batch(jcfg)
    with make_local_mesh(1, 1) as mesh:
        jb = jax_make_train_step(jcfg, mesh, JParallel(),
                                 JShape("t", "train", 16, 4))
        jnew, _, jm = jb.fn(params, jopt.adamw_init(params), dict(batch))
    model = params_from_jax(host, tcfg, "cpu").requires_grad_()
    state = opt.adamw_init(dict(model.named_parameters()))
    tb = make_train_step(tcfg, ParallelConfig(),
                         ShapeConfig("t", "train", 16, 4))
    _, _, tm = tb.fn(model, state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    _close_per_leaf(params_to_jax(model), jax.tree.map(np.asarray, jnew))


def _with_modal(cfg, batches, seed=0):
    rng = np.random.default_rng(seed)
    for b in batches:
        yield {**b, **_modal(cfg, len(b["tokens"]), int(rng.integers(1e6)))}


@pytest.mark.parametrize("arch", ARCHS)
def test_ten_step_losses_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    _, host = _jax_params(arch)
    kw = dict(peak_lr=3e-3, warmup_steps=5, total_steps=10)
    jt = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(),
                  JShape("t", "train", 32, 4), jopt.OptimizerConfig(**kw))
    _, jl = jt.fit(_with_modal(jcfg, jdata.SyntheticCorpus(
        jcfg.vocab_size, 0).batches(4, 32, 10)), 10, state=jt.init_state(),
        log_every=0)
    tt = Trainer(tcfg, ParallelConfig(), ShapeConfig("t", "train", 32, 4),
                 opt.OptimizerConfig(**kw), device="cpu")
    _, tl = tt.fit(_with_modal(tcfg, tdata.SyntheticCorpus(
        tcfg.vocab_size, 0).batches(4, 32, 10)), 10,
        state=tt.state_from_jax(host), log_every=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


@functools.lru_cache(maxsize=None)
def _encdec_remat_grads(remat: bool, mode: str) -> list:
    """whisper's loss and gradients of one step under ``cfg.remat`` and
    ``remat_mode`` (kept: each case compares with the same remat=False
    run)."""
    _, tcfg = _configs(AUDIO)
    _, host = _jax_params(AUDIO)
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(tcfg).items()}
    cfg = dataclasses.replace(tcfg, remat=remat, remat_mode=mode)
    model = params_from_jax(host, cfg, "cpu").requires_grad_()
    loss = get_model(cfg).loss_fn(model, cfg, batch, TA.AttnMode(kind="full"))
    loss.backward()
    return [loss.detach()] + [p.grad for p in model.parameters()]


@pytest.mark.parametrize("mode", ["none", "nothing", "dots"])
def test_remat_changes_no_number_in_the_encoder_decoder(mode):
    """cfg.remat wraps each encoder and decoder layer in
    torch.utils.checkpoint as ``remat_mode`` says: the same loss and
    gradients, bit for bit."""
    assert all(torch.equal(a, b) for a, b in zip(
        _encdec_remat_grads(False, "none"), _encdec_remat_grads(True, mode)))


def test_encdec_checkpoint_crosses_packages(tmp_path):
    """A whisper trainer's checkpoint (``encoder`` and ``decoder`` stacks,
    ``enc_norm``) written by the JAX trainer restores in the port's, and
    the port's in the JAX trainer's, bit for bit (f32), parameters and
    moments alike."""
    jcfg, tcfg = (reduced(get_config(AUDIO)),
                  t_reduced(t_get_config(AUDIO)))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    shape = ("t", "train", 16, 2)
    jt = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(), JShape(*shape),
                  ckpt_dir=str(jdir), ckpt_every=2)
    js, _ = jt.fit(_with_modal(jcfg, jdata.SyntheticCorpus(
        jcfg.vocab_size, 0).batches(2, 16, 2)), 2, log_every=0)
    tt = Trainer(tcfg, ParallelConfig(), ShapeConfig(*shape),
                 ckpt_dir=str(jdir), device="cpu")
    ts = tt.maybe_restore()
    assert ts.step == 2 and int(ts.opt_state["count"]) == 2

    def pairs(port, ref):
        pf = dict(jax.tree_util.tree_flatten_with_path(port)[0])
        rf = dict(jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, ref))[0])
        assert set(pf) == set(rf)
        assert any("enc_norm" in str(p) for p in rf)
        return [(str(k), np.asarray(pf[k]), rf[k]) for k in rf]

    nu = jax.tree.map(lambda t: t.numpy(), jax_tree(ts.opt_state["nu"],
                                                    tcfg))
    for path, p, r in pairs(params_to_jax(ts.params), js.params) + pairs(
            nu, js.opt_state["nu"]):
        np.testing.assert_array_equal(p, r, err_msg=path)
    tt2 = Trainer(tcfg, ParallelConfig(), ShapeConfig(*shape),
                  ckpt_dir=str(tdir), ckpt_every=3, device="cpu")
    ts2, _ = tt2.fit(_with_modal(tcfg, tdata.SyntheticCorpus(
        tcfg.vocab_size, 0).batches(2, 16, 1)), 1, state=ts, log_every=0)
    js2 = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(), JShape(*shape),
                   ckpt_dir=str(tdir)).maybe_restore()
    assert js2.step == 3 and int(js2.opt_state["count"]) == 3
    assert jck.latest_step(tdir) == 3
    for path, p, r in pairs(params_to_jax(ts2.params), js2.params):
        np.testing.assert_array_equal(p, r, err_msg=path)


def test_train_lm_trains_each_new_family_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.train_lm --arch`` at the ci preset: the VLM
    and audio batches carry their stub inputs, falcon-mamba trains through
    ``SSMScan``; the loss falls."""
    from repro_torch import train_lm
    for arch in (VLM, AUDIO, "falcon-mamba-7b"):
        train_lm.main(["--device", "cpu", "--synthetic", "--steps", "6",
                       "--arch", arch, "--ckpt", str(tmp_path / arch)])
        out = capsys.readouterr().out
        assert "final loss" in out and arch in out
    with pytest.raises(ValueError, match="ci preset"):
        train_lm.model_for("full", AUDIO)
