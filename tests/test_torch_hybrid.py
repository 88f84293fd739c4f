"""The port's hybrid family (zamba2-7b: Mamba2 groups with one shared
attention+MLP block) against the JAX package's, on the CPU.

Parameters are the JAX ``init`` params carried across by
``models/convert.py::params_from_jax``; inputs and tokens are drawn with
numpy from a seed.  Everything is float32 at ``reduced(zamba2-7b)``: d_model
64, heads 4 of head_dim 16, d_inner 128 in 8 Mamba2 heads of 16, N 8, 2
groups of 2 layers; the JAX side runs under ``jax.jit``.  Tolerances,
stated once: Mamba2, the forward, loss, prefill, caches and decode within
1e-5 (float32 sums in other orders); gradients and one train step within
1e-5 of each leaf's largest magnitude; tokens equal; conversion and
checkpoints bit for bit.
"""
import dataclasses
import functools
import types

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
from repro.models import ssm as JS
from repro.serve.continuous import cache_batch_axes as jax_cache_batch_axes
from repro.serve.engine import greedy_reference as jax_greedy_reference
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer

from repro_torch.configs import ParallelConfig, ShapeConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.distributed.steps import make_train_step
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models import get_model, hybrid
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (decayed_names, jax_tree,
                                        params_from_jax, params_to_jax)
from repro_torch.serve import (ContinuousEngine, Request, ServeEngine,
                               greedy_reference)
from repro_torch.serve.continuous import cache_batch_axes
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs on one intra-op thread: at these sizes every
    operation is small, and when the suite's workers share the cores,
    threads waiting on each other made the training loop here many times
    slower than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs():
    return reduced(get_config(ARCH)), t_reduced(t_get_config(ARCH))


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    jcfg, _ = _configs()
    params = jax_get_model(jcfg).init(jax.random.key(seed), jcfg)
    return params, jax.tree.map(np.asarray, params)


def _models():
    jcfg, tcfg = _configs()
    params, host = _jax_params()
    return jcfg, tcfg, params, params_from_jax(host, tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close_per_leaf(port: dict, ref: dict, tol=1e-5):
    pf = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    rf = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert set(pf) == set(rf)
    for path, r in rf.items():
        p = pf[path]
        p = p.detach().numpy() if isinstance(p, torch.Tensor) else \
            np.asarray(p)
        r = np.asarray(r)
        assert p.shape == r.shape, path
        assert np.abs(p - r).max() <= tol * np.abs(r).max(), path


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
def _mamba2_params(seed):
    """One Mamba2 layer's JAX params with its zero and constant leaves
    (conv_b, A_log, D, dt_bias) drawn, so that each enters the check."""
    jcfg, tcfg = _configs()
    p = dict(JS.mamba2_init(jax.random.key(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    nh, ch = jcfg.ssm_heads, jcfg.d_inner + 2 * jcfg.ssm_state
    p["conv_b"] = jnp.asarray(_randn(rng, ch) * 0.1)
    p["A_log"] = jnp.asarray(_randn(rng, nh) * 0.5)
    p["D"] = jnp.asarray(_randn(rng, nh))
    p["dt_bias"] = jnp.asarray(_randn(rng, nh) * 0.5 - 2.0)
    p["norm_w"] = jnp.asarray(1 + _randn(rng, jcfg.d_inner) * 0.1)
    return jcfg, tcfg, p, {k: torch.from_numpy(np.array(v))
                           for k, v in p.items()}


def test_mamba2_ssm_inputs_match_jax():
    """The port hands the scan each head's dt and A repeated over the
    head's channels; the decay and input the JAX twin materialises per
    head follow from them."""
    jcfg, tcfg, jp, tp = _mamba2_params(1)
    b, s = 2, 7
    rng = np.random.default_rng(11)
    xbc = _randn(rng, b, s, jcfg.d_inner + 2 * jcfg.ssm_state)
    dt = _randn(rng, b, s, jcfg.ssm_heads)
    ja, jb, jc, jx = JS._mamba2_ssm(jp, jnp.asarray(xbc), jnp.asarray(dt),
                                    jcfg)
    dth, A, xh, Bm, Cm = TS._mamba2_ssm(tp, torch.from_numpy(xbc),
                                        torch.from_numpy(dt), tcfg)
    dtc, Ac = TS._mamba2_channels(dth, A, tcfg)
    assert dtc.dtype == Ac.dtype == torch.float32
    assert dtc.is_contiguous() and Ac.is_contiguous()
    assert tuple(dtc.shape) == (b, s, jcfg.d_inner)
    assert tuple(Ac.shape) == (jcfg.d_inner, jcfg.ssm_state)
    nh, hd = jcfg.ssm_heads, jcfg.ssm_head_dim
    decay = torch.exp(dtc[..., None] * Ac).view(b, s, nh, hd, -1)
    _close(decay, jnp.broadcast_to(ja[..., None, None], jb.shape))
    inp = ((dtc * xh)[..., None] * Bm[:, :, None, :]).view(jb.shape)
    _close(inp, jb)
    _close(Cm, jc)
    _close(xh.view(jx.shape), jx)


def test_mamba2_plain_scan_matches_jax_reference_scan():
    """The scan the port runs for Mamba2 (``ssm_scan``'s plain version on
    per-channel inputs) against the JAX package's sequential
    ``reference_scan`` over the materialised (B,S,nh,hd,N) decay and
    input: y = <h, C> at every step and the final state."""
    jcfg, tcfg, jp, tp = _mamba2_params(2)
    b, s = 2, 12
    rng = np.random.default_rng(12)
    xbc = _randn(rng, b, s, jcfg.d_inner + 2 * jcfg.ssm_state)
    dt = _randn(rng, b, s, jcfg.ssm_heads)
    ja, jb, jc, _ = JS._mamba2_ssm(jp, jnp.asarray(xbc), jnp.asarray(dt),
                                   jcfg)
    h0 = jnp.zeros(jb.shape[:1] + jb.shape[2:], jnp.float32)
    hs = JS.reference_scan(jnp.broadcast_to(ja[..., None, None], jb.shape),
                           jb, h0)
    jy = jnp.einsum("bshdn,bsn->bshd", hs, jc).reshape(b, s, -1)
    dth, A, xh, Bm, Cm = TS._mamba2_ssm(tp, torch.from_numpy(xbc),
                                        torch.from_numpy(dt), tcfg)
    y, h = scan_ops.ssm_scan(*TS._mamba2_channels(dth, A, tcfg), Bm, Cm, xh,
                             return_state=True)
    _close(y, jy)
    _close(h.view(hs.shape[:1] + hs.shape[2:]), hs[:, -1])


def test_mamba2_apply_and_decode_match_jax():
    """mamba2_apply, its final state, and mamba2_decode token by token
    (writing its state in place) against the JAX package's."""
    jcfg, tcfg, jp, tp = _mamba2_params(3)
    b, s = 2, 10
    x = _randn(np.random.default_rng(13), b, s, jcfg.d_model) * 0.3
    y, st = TS.mamba2_apply(tp, torch.from_numpy(x), tcfg, return_state=True)
    _close(y, _jit(JS.mamba2_apply, 2)(jp, jnp.asarray(x), jcfg))
    _close(TS.mamba2_apply(tp, torch.from_numpy(x), tcfg), y.numpy())
    jstate = JS.mamba2_state_init(b, jcfg, jnp.float32)
    tstate = TS.mamba2_state_init(b, tcfg, torch.float32)
    held = dict(tstate)
    jdecode = _jit(JS.mamba2_decode, 3)
    for t in range(s):
        jy, jstate = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jstate, jcfg)
        ty, tstate = TS.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      tstate, tcfg)
        _close(ty, jy)
        for k in ("conv", "h"):
            assert tstate[k] is held[k]                  # written in place
            _close(tstate[k], jstate[k])
    _close(st["conv"], jstate["conv"])
    _close(st["h"], jstate["h"])


def test_mamba2_takes_the_function_only_under_autograd():
    """Serving calls the wrapper directly; a forward that records gradients
    goes through ``SSMScan``, whose gradients reach A_log and dt_bias
    through the per-head repeat."""
    _, tcfg, _, tp = _mamba2_params(4)
    x = torch.from_numpy(_randn(np.random.default_rng(14), 2, 9,
                                tcfg.d_model))
    seen, apply = [], TS.SSMScan.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "ssm_scan", lambda *a, **kw: seen.append("wrapper")
                   or scan_ops.ssm_scan(*a, **kw))
        mp.setattr(TS.SSMScan, "apply", lambda *a: seen.append("function")
                   or apply(*a))
        with torch.inference_mode():
            TS.mamba2_apply(tp, x, tcfg)
            TS.mamba2_apply(tp, x, tcfg, return_state=True)
        lp = {k: v.clone().requires_grad_() for k, v in tp.items()}
        TS.mamba2_apply(lp, x, tcfg).sum().backward()
    assert seen == ["wrapper", "wrapper", "function"]
    assert all(float(lp[k].grad.abs().max()) > 0 for k in ("A_log",
                                                           "dt_bias", "D"))


BF16_TOL = 2e-2    # of the largest |JAX output|: the port's bf16 state
# rounds step by step where the JAX chunked scan rounds chunk-wise


def _bf16(cfg):
    return dataclasses.replace(cfg, ssm_scan_dtype="bfloat16")


def _near(port, ref, tol=BF16_TOL):
    """|port - ref| within ``tol`` of the largest |ref|; returns the ratio."""
    p = np.asarray(port.detach(), np.float64)
    r = np.asarray(ref, np.float64)
    err = float(np.abs(p - r).max() / np.abs(r).max())
    assert err <= tol, err
    return err


def test_mamba2_refuses_a_scan_dtype_other_than_float32():
    """Other than float32, bfloat16, float16 and float64: a name no JAX
    config sets raises (float16: tests/test_torch_float16.py).
    ssm_scan_dtype="bfloat16": mamba2_apply within BF16_TOL of the JAX
    package's (measured 1.2e-3) and not the f32 output; the
    training path's forward the same bits as serving's; a prefill hands
    decode the f32 path's state bit for bit; decode ignores the knob."""
    jcfg, tcfg, jp, tp = _mamba2_params(5)
    cfg = dataclasses.replace(tcfg, ssm_scan_dtype="float8_e4m3fn")
    with pytest.raises(NotImplementedError, match="ssm_scan_dtype"):
        TS.mamba2_apply(tp, torch.zeros(1, 3, cfg.d_model), cfg)
    with pytest.raises(NotImplementedError, match="ssm_scan_dtype"):
        hybrid.init(torch.Generator(), cfg)
    j16, t16 = _bf16(jcfg), _bf16(tcfg)
    x = torch.from_numpy(_randn(np.random.default_rng(15), 2, 40,
                                jcfg.d_model) * 0.5)
    with torch.no_grad():
        y, st = TS.mamba2_apply(tp, x, t16, return_state=True)
        y32, st32 = TS.mamba2_apply(tp, x, tcfg, return_state=True)
    _near(y, _jit(JS.mamba2_apply, 2)(jp, jnp.asarray(x.numpy()), j16))
    assert not torch.equal(y, y32)
    assert torch.equal(TS.mamba2_apply(tp, x, t16).detach(), y)
    for k in ("conv", "h"):
        assert torch.equal(st[k], st32[k])
    s16 = {k: v.clone() for k, v in st.items()}
    for t in range(3):
        d16, s16 = TS.mamba2_decode(tp, x[:, t:t + 1], s16, t16)
        d32, st32 = TS.mamba2_decode(tp, x[:, t:t + 1], st32, tcfg)
        assert torch.equal(d16, d32)
        assert all(torch.equal(s16[k], st32[k]) for k in s16)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_get_model_takes_the_hybrid_family_at_published_widths():
    cfg = t_get_config(ARCH)
    api = get_model(cfg)
    assert api.init is hybrid.init and api.decode_step is hybrid.decode_step
    assert (cfg.n_layers, cfg.shared_attn_period, cfg.head_dim,
            cfg.ssm_state) == (81, 9, 112, 64)
    assert hybrid._groups(cfg) == (9, 9)


def test_forward_and_loss_match_jax():
    jcfg, tcfg, params, model = _models()
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    toks, labels = _tokens(jcfg, 2, 9, 1), _tokens(jcfg, 2, 9, 2)
    with torch.inference_mode():
        logits = api.forward(model, tcfg, {"tokens": torch.from_numpy(toks)})
        loss = api.loss_fn(model, tcfg, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
    _close(logits, _jit(japi.forward, 1)(params, jcfg,
                                         {"tokens": jnp.asarray(toks)}))
    _close(loss, _jit(japi.loss_fn, 1)(params, jcfg, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}))


def _flat_cache(jc):
    """The JAX cache {"k", "v", "ssm": {"conv", "h"}} under the port's flat
    names."""
    return {"k": jc["k"], "v": jc["v"], **jc["ssm"]}


@pytest.mark.parametrize("plen", [2, 6])     # 2 < K - 1: the conv's pad
def test_prefill_and_decode_match_jax(plen):
    """Prefill, then three decode steps; every cache leaf within 1e-5 after
    each, written in place."""
    jcfg, tcfg, params, model = _models()
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    toks = _tokens(jcfg, 2, plen + 3, 3)
    jc, jl = _jit(japi.prefill, 1, 3)(
        params, jcfg, {"tokens": jnp.asarray(toks[:, :plen])}, 16)
    with torch.inference_mode():
        tc, tl = api.prefill(model, tcfg,
                             {"tokens": torch.from_numpy(toks[:, :plen])}, 16)
    _close(tl, jl)
    assert set(tc) == {"k", "v", "conv", "h"}
    for name, want in _flat_cache(jc).items():
        assert tuple(tc[name].shape) == want.shape
        _close(tc[name], want)
    jdecode = _jit(japi.decode_step, 1)
    held = dict(tc)
    for t in range(plen, plen + 3):
        jl, jc = jdecode(params, jcfg, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "positions": jnp.full((2,), t, jnp.int32)}, jc)
        with torch.inference_mode():
            tl, tc = api.decode_step(model, tcfg, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "positions": torch.full((2,), t)}, tc)
        _close(tl, jl)
        for name, want in _flat_cache(jc).items():
            assert tc[name] is held[name]                # written in place
            _close(tc[name], want)


def test_bf16_state_forward_prefill_and_decode_match_jax():
    """The hybrid at ssm_scan_dtype="bfloat16": logits, the loss, the
    prefill's cache and three decode steps within BF16_TOL of the JAX
    package's (measured at most 2.1e-3); the Mamba2
    states handed to decode in f32."""
    jcfg, tcfg, params, model = _models()
    jcfg, tcfg = _bf16(jcfg), _bf16(tcfg)
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    toks, labels = _tokens(jcfg, 2, 12, 1), _tokens(jcfg, 2, 12, 2)
    with torch.inference_mode():
        logits = api.forward(model, tcfg, {"tokens": torch.from_numpy(toks)})
        loss = api.loss_fn(model, tcfg, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
        tc, tl = api.prefill(model, tcfg,
                             {"tokens": torch.from_numpy(toks[:, :9])}, 16)
    _near(logits, _jit(japi.forward, 1)(params, jcfg,
                                        {"tokens": jnp.asarray(toks)}))
    _near(loss, _jit(japi.loss_fn, 1)(params, jcfg, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}))
    jc, jl = _jit(japi.prefill, 1, 3)(
        params, jcfg, {"tokens": jnp.asarray(toks[:, :9])}, 16)
    _near(tl, jl)
    for name, want in _flat_cache(jc).items():
        _near(tc[name], want)
    assert tc["h"].dtype == torch.float32
    jdecode = _jit(japi.decode_step, 1)
    for t in range(9, 12):
        jl, jc = jdecode(params, jcfg, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "positions": jnp.full((2,), t, jnp.int32)}, jc)
        with torch.inference_mode():
            tl, tc = api.decode_step(model, tcfg, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "positions": torch.full((2,), t)}, tc)
        _near(tl, jl)
        _near(tc["h"], jc["ssm"]["h"])


def test_cache_batch_axes_and_cache_init_match_jax():
    """The continuous engine's probe finds each leaf's batch axis where the
    JAX engine's finds it in the nested layout: 1 of k/v (G, B, smax, K,
    hd), 2 of conv/h (G, P, B, ...)."""
    jcfg, tcfg, params, model = _models()
    axes, spec = cache_batch_axes(tcfg, model, 24)
    jaxes, jspec = jax_cache_batch_axes(jcfg, params, 24)
    assert axes == _flat_cache(jaxes) == {"k": 1, "v": 1, "conv": 2, "h": 2}
    jcache = _flat_cache(jax_get_model(jcfg).cache_init(jcfg, 3, 24))
    cache = get_model(tcfg).cache_init(tcfg, 3, 24)
    for name, want in _flat_cache(jspec).items():
        assert tuple(spec[name].shape) == want.shape
        assert spec[name].device.type == "meta"
        assert tuple(cache[name].shape) == jcache[name].shape
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(jcache[name].dtype)


def test_init_matches_the_jax_shapes_and_dtypes():
    """A bf16 model drawn from a generator: every leaf in the JAX layout has
    the JAX init's shape and dtype (Mamba2's A_log, D and dt_bias f32);
    the parameter count is the config's; the same seed draws the same
    weights; serving models carry no gradient."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _configs())
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


def test_params_round_trip_and_decay_rule():
    """``params_to_jax(params_from_jax(tree))`` is ``tree`` bit for bit
    (bf16 too, A_log, D and dt_bias kept f32), and ``decayed_names``
    picks the JAX leaves of ``ndim >= 2``: every (G, P)-stacked Mamba2
    leaf, its norms and vectors included, but not the shared block's
    unstacked norms nor ``final_norm``."""
    _, tcfg, _, model = _models()
    _, host = _jax_params()
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
    assert {f"layers.1.0.{k}" for k in ("ln", "A_log", "D", "dt_bias",
                                        "conv_b", "norm_w")} <= dec
    assert not {"shared.ln1", "shared.ln2", "final_norm"} & dec
    assert "shared.attn.wq" in dec
    bf16 = params_from_jax(host, tcfg, "cpu", dtype="bfloat16")
    lp = bf16.layers[1][0]
    assert lp["A_log"].dtype == lp["D"].dtype == lp["dt_bias"].dtype == \
        torch.float32
    assert lp["in_proj"].dtype == bf16.shared["attn"]["wq"].dtype == \
        torch.bfloat16


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def _jax_oracle_forward_jitted():
    """The JAX greedy_reference over a jitted forward (one compile per
    length; eager JAX compiles every op per length): the same function."""
    import repro.serve.engine as jax_engine
    apis = {}

    def get_model_jit(cfg):
        if cfg not in apis:
            api = jax_get_model(cfg)
            apis[cfg] = api._replace(
                forward=jax.jit(api.forward, static_argnums=1))
        return apis[cfg]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "registry",
                   types.SimpleNamespace(get_model=get_model_jit))
        yield


def _requests(cfg, spec, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=m, uid=i)
            for i, (n, m) in enumerate(spec)]


@pytest.mark.parametrize("engine", ["static", "continuous"])
def test_engines_match_the_jax_greedy_output(engine,
                                             _jax_oracle_forward_jitted):
    """The static engine over length groups and the continuous engine with
    staggered admission (max_batch 2: requests join mid-decode into slots
    whose neighbour is elsewhere): every stream equals the port's
    greedy_reference and the JAX package's, token for token."""
    jcfg, tcfg, params, model = _models()
    reqs = _requests(tcfg, [(3, 4), (2, 5), (5, 3), (3, 2)])
    if engine == "static":
        out = ServeEngine(tcfg, model, max_batch=4,
                          max_seq=32).run_requests(reqs)
    else:
        out = ContinuousEngine(tcfg, model, max_batch=2, max_seq=32).run(reqs)
    for r in reqs:
        ref = greedy_reference(tcfg, model, r.prompt, r.max_new_tokens)
        np.testing.assert_array_equal(
            ref, jax_greedy_reference(jcfg, params, r.prompt,
                                      r.max_new_tokens))
        np.testing.assert_array_equal(out[r.uid], ref)


def test_serve_lm_serves_zamba2_on_the_cpu(capsys):
    """``python -m repro_torch.serve_lm --device cpu --arch zamba2-7b``:
    both acts, each checked against the oracle."""
    from repro_torch import serve_lm
    serve_lm.main(["--device", "cpu", "--arch", ARCH])
    out = capsys.readouterr().out
    assert "== oracle" in out and "[continuous]" in out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _train_batch(cfg, seed=1):
    tok = _tokens(cfg, 4, 16, seed)
    return {"tokens": tok, "labels": tok}


def test_gradients_match_jax():
    """``jax.grad`` of the JAX loss (its materialised Mamba2 scan) against
    the port's backward through ``SSMScan`` and the attention's plain path:
    every leaf, the shared block's (the sum of its two applications) and
    A_log, D and dt_bias included."""
    jcfg, tcfg = _configs()
    params, host = _jax_params()
    batch = _train_batch(jcfg)
    jgrads = jax.jit(jax.grad(lambda p: jax_get_model(jcfg).loss_fn(
        p, jcfg, batch)))(params)
    model = params_from_jax(host, tcfg, "cpu").requires_grad_()
    get_model(tcfg).loss_fn(model, tcfg, {
        k: torch.from_numpy(v) for k, v in batch.items()}).backward()
    port = jax_tree({k: p.grad for k, p in model.named_parameters()}, tcfg)
    _close_per_leaf(port, jax.tree.map(np.asarray, jgrads))


def test_train_step_matches_jax():
    """One step of each package's train step at the reference's default
    optimizer settings: loss, grad norm and every leaf after the update."""
    jcfg, tcfg = _configs()
    params, host = _jax_params()
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


@pytest.mark.parametrize("mode", ["none", "nothing", "dots"])
def test_remat_changes_no_number_and_runs_each_group_again(mode):
    """cfg.remat wraps each group in torch.utils.checkpoint as
    ``remat_mode`` says: the same loss and gradients bit for bit; under
    "nothing" and "dots" the recomputed forward runs each group's scans
    and shared attention once more (on the card: the kernels twice a
    layer, and twice a group, a step), under "none" it does not."""
    _, tcfg = _configs()
    (want, base), (grads, calls) = (_remat_step(False, "none"),
                                    _remat_step(True, mode))
    assert all(torch.equal(a, b) for a, b in zip(want, grads))
    g, _ = hybrid._groups(tcfg)
    again = 1 if mode == "none" else 2
    assert [base, calls] == [{"scan": tcfg.n_layers, "attend": g},
                             {"scan": again * tcfg.n_layers,
                              "attend": again * g}]


@functools.lru_cache(maxsize=None)
def _remat_step(remat: bool, mode: str) -> tuple:
    """(loss and gradients, scan and attention calls) of one step under
    ``cfg.remat`` and ``remat_mode`` (kept: each case compares with the
    same remat=False run)."""
    _, tcfg = _configs()
    _, host = _jax_params()
    cfg = dataclasses.replace(tcfg, remat=remat, remat_mode=mode)
    model = params_from_jax(host, cfg, "cpu").requires_grad_()
    n = {"scan": 0, "attend": 0}
    scan, attend = scan_ops.ssm_scan, hybrid.attn.attend

    def counting_scan(*a, **kw):
        n["scan"] += 1
        return scan(*a, **kw)

    def counting_attend(*a, **kw):
        n["attend"] += 1
        return attend(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scan_ops, "ssm_scan", counting_scan)
        mp.setattr(hybrid.attn, "attend", counting_attend)
        loss = get_model(cfg).loss_fn(model, cfg, {
            k: torch.from_numpy(v) for k, v in _train_batch(tcfg).items()})
        loss.backward()
    return [loss.detach()] + [p.grad for p in model.parameters()], n


def test_checkpoint_crosses_packages(tmp_path):
    """A zamba2 trainer's checkpoint (the (G, P) ``layers`` stack and the
    unstacked ``shared`` block) written by the JAX trainer restores in the
    port's, and the port's in the JAX trainer's, bit for bit (f32),
    parameters and moments alike."""
    jcfg, tcfg = _configs()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    shape = ("t", "train", 16, 2)
    jt = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(), JShape(*shape),
                  ckpt_dir=str(jdir), ckpt_every=2)
    js, _ = jt.fit(jdata.SyntheticCorpus(jcfg.vocab_size, 0).batches(
        2, 16, 2), 2, log_every=0)
    tt = Trainer(tcfg, ParallelConfig(), ShapeConfig(*shape),
                 ckpt_dir=str(jdir), device="cpu")
    ts = tt.maybe_restore()
    assert ts.step == 2 and int(ts.opt_state["count"]) == 2

    def pairs(port, ref):
        pf = dict(jax.tree_util.tree_flatten_with_path(port)[0])
        rf = dict(jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, ref))[0])
        assert set(pf) == set(rf)
        assert any("shared" in str(p) for p in rf)
        return [(str(k), np.asarray(pf[k]), rf[k]) for k in rf]

    nu = jax.tree.map(lambda t: t.numpy(), jax_tree(ts.opt_state["nu"],
                                                    tcfg))
    for path, p, r in pairs(params_to_jax(ts.params), js.params) + pairs(
            nu, js.opt_state["nu"]):
        np.testing.assert_array_equal(p, r, err_msg=path)
    tt2 = Trainer(tcfg, ParallelConfig(), ShapeConfig(*shape),
                  ckpt_dir=str(tdir), ckpt_every=3, device="cpu")
    ts2, _ = tt2.fit(tdata.SyntheticCorpus(tcfg.vocab_size, 0).batches(
        2, 16, 1), 1, state=ts, log_every=0)
    js2 = JTrainer(jcfg, make_local_mesh(1, 1), JParallel(), JShape(*shape),
                   ckpt_dir=str(tdir)).maybe_restore()
    assert js2.step == 3 and int(js2.opt_state["count"]) == 3
    for path, p, r in pairs(params_to_jax(ts2.params), js2.params):
        np.testing.assert_array_equal(p, r, err_msg=path)


def test_train_lm_trains_zamba2_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.train_lm --arch zamba2-7b --device cpu`` at
    the ci preset: two groups of two Mamba2 layers; the loss falls."""
    from repro_torch import train_lm
    train_lm.main(["--device", "cpu", "--synthetic", "--steps", "6",
                   "--arch", ARCH, "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and ARCH in out
