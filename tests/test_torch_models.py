"""The port's dense LM and SSM LM against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages; model
parameters are the JAX ``init`` params carried across by
``repro_torch.models.convert.params_from_jax``.  Everything is float32 at
the reduced widths the JAX tests use, so the two agree to float32 rounding:
1e-5 here.  The JAX side of the attention and model comparisons runs under
``jax.jit``: the same functions, compiled once per shape where eager JAX
compiles every op per shape and traces a ``lax.scan`` anew on every call.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs, reduced
from repro.models import attention as JA
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.serve.continuous import cache_batch_axes as jax_cache_batch_axes

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import attention as TA
from repro_torch.models import get_model, hybrid, ssm_lm
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.continuous import cache_batch_axes

TOL = dict(rtol=1e-5, atol=1e-5)
DENSE = [a for a in list_archs() if get_config(a).family == "dense"]
MOE = [a for a in list_archs() if get_config(a).family == "moe"]


def _np(x, dtype=np.float32):
    return np.asarray(x, dtype)


def _jit(fn, *static):
    """``fn`` under jax.jit, with the named or numbered arguments static."""
    names = tuple(a for a in static if isinstance(a, str))
    nums = tuple(a for a in static if isinstance(a, int))
    return jax.jit(fn, static_argnames=names, static_argnums=nums)


def _close(port, ref, **tol):
    np.testing.assert_allclose(_np(port.detach()), _np(ref), **(tol or TOL))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _configs(arch, n_layers=None):
    """Reduced configs of ``n_layers`` (default 2; an MoE arch keeps its
    reduced 4: two superblocks of llama4's period 2)."""
    if n_layers is None:
        n_layers = 4 if get_config(arch).family == "moe" else 2
    jcfg = dataclasses.replace(reduced(get_config(arch)), n_layers=n_layers)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)),
                               n_layers=n_layers)
    return jcfg, tcfg


def _models(arch, seed=0, n_layers=None):
    jcfg, tcfg = _configs(arch, n_layers)
    params = jax_get_model(jcfg).init(jax.random.key(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, model


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_configs_are_the_jax_configs():
    for arch in list_archs():
        assert dataclasses.asdict(t_get_config(arch)) == \
            dataclasses.asdict(get_config(arch))
        assert dataclasses.asdict(t_reduced(t_get_config(arch))) == \
            dataclasses.asdict(reduced(get_config(arch)))
        assert t_get_config(arch).param_count() == \
            get_config(arch).param_count()


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 4, 16)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x, w = _randn(rng, *shape), _randn(rng, shape[-1])
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def test_rope():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 64, (2, 7)).astype(np.int32)
    x = _randn(rng, 2, 7, 4, 16)
    js, jc = JL.rope_sincos(jnp.asarray(pos), 16, 1e4)
    ts, tc = TL.rope_sincos(torch.from_numpy(pos), 16, 1e4)
    _close(ts, js)
    _close(tc, jc)
    _close(TL.apply_rope(torch.from_numpy(x), ts, tc),
           JL.apply_rope(jnp.asarray(x), js, jc))


def test_mlp_apply():
    rng = np.random.default_rng(2)
    p = {k: _randn(rng, *s) * 0.1 for k, s in
         (("wg", (16, 32)), ("wi", (16, 32)), ("wo", (32, 16)))}
    x = _randn(rng, 2, 5, 16)
    _close(TL.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x)),
           JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)))


@pytest.mark.parametrize("tie", [True, False])
def test_logits_apply(tie):
    rng = np.random.default_rng(3)
    p = {"embedding": _randn(rng, 40, 16)}
    if not tie:
        p["lm_head"] = _randn(rng, 16, 40)
    x = _randn(rng, 2, 3, 16)
    _close(TL.logits_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), tie),
           JL.logits_apply({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), tie))
    tok = rng.integers(0, 40, (2, 3))
    _close(TL.embed_apply({"embedding": torch.from_numpy(p["embedding"])},
                          torch.from_numpy(tok)),
           JL.embed_apply({"embedding": jnp.asarray(p["embedding"])},
                          jnp.asarray(tok)))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss(masked):
    rng = np.random.default_rng(4)
    logits = _randn(rng, 2, 6, 30) * 3
    labels = rng.integers(0, 30, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32) if masked else None
    got = TL.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    want = JL.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    _close(got, want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _qkv(seed, b, s, h, kh, hd, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (_randn(rng, b, s, h, hd), _randn(rng, b, sk, kh, hd),
            _randn(rng, b, sk, kh, hd))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_qkv_project(qk_norm):
    rng = np.random.default_rng(5)
    p = {"wq": _randn(rng, 16, 4, 8) * 0.3, "wk": _randn(rng, 16, 2, 8) * 0.3,
         "wv": _randn(rng, 16, 2, 8) * 0.3}
    if qk_norm:
        p["q_norm"] = _randn(rng, 8)
        p["k_norm"] = _randn(rng, 8)
    x = _randn(rng, 2, 5, 16)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    got = TA.qkv_project({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), torch.from_numpy(pos.copy()),
                         1e6, qk_norm, 1e-6)
    want = _jit(JA.qkv_project, 3, 4, 5)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), 1e6, qk_norm, 1e-6)
    for g, w in zip(got, want, strict=True):
        _close(g, w)


@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("s", [32, 96, 128])
def test_attend_full(h, kh, s):
    q, k, v = _qkv(0, 2, s, h, kh, 32)
    _close(TA.attend_full(*map(torch.from_numpy, (q, k, v)), causal=True),
           _jit(JA.attend_full, "causal")(*map(jnp.asarray, (q, k, v)),
                                          causal=True))


def test_attend_full_non_causal_and_suffix_aligned():
    q, k, v = _qkv(1, 2, 5, 4, 2, 16, sk=12)
    for causal in (False, True):
        _close(TA.attend_full(*map(torch.from_numpy, (q, k, v)),
                              causal=causal),
               _jit(JA.attend_full, "causal")(*map(jnp.asarray, (q, k, v)),
                                              causal=causal))


@pytest.mark.parametrize("causal", [True, False])
def test_attend_blockwise_long(causal):
    """S > 512: both packages' ``attend`` take the blockwise path."""
    q, k, v = _qkv(2, 1, 1024, 4, 2, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = _jit(JA.attend_blockwise, "causal")(jq, jk, jv, causal=causal)
    _close(TA.attend_blockwise(tq, tk, tv, causal=causal), want)
    _close(TA.attend(tq, tk, tv, causal=causal, mode=TA.AttnMode()),
           _jit(JA.attend, "causal", "mode")(jq, jk, jv, causal=causal,
                                             mode=JA.AttnMode()))


def test_attend_blockwise_small_blocks_matches_jax():
    q, k, v = _qkv(3, 2, 96, 8, 2, 32)
    _close(TA.attend_blockwise(*map(torch.from_numpy, (q, k, v)),
                               causal=True, q_block=32, kv_block=32),
           _jit(JA.attend_blockwise, "causal", "q_block", "kv_block")(
               *map(jnp.asarray, (q, k, v)), causal=True, q_block=32,
               kv_block=32))


def test_attend_decode_and_cache_update():
    b, s, h, kh, hd, smax = 2, 12, 4, 2, 16, 20
    q, k, v = _qkv(4, b, s, h, kh, hd)
    kc = np.zeros((b, smax, kh, hd), np.float32)
    vc = np.zeros((b, smax, kh, hd), np.float32)
    kc[:, :s - 1], vc[:, :s - 1] = k[:, :-1], v[:, :-1]
    pos = np.full((b,), s - 1, np.int32)
    jk, jv = JA.cache_update(jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(k[:, -1:]), jnp.asarray(v[:, -1:]),
                             jnp.asarray(pos))
    tk, tv = TA.cache_update(torch.from_numpy(kc), torch.from_numpy(vc),
                             torch.from_numpy(k[:, -1:]),
                             torch.from_numpy(v[:, -1:]),
                             torch.from_numpy(pos))
    _close(tk, jk)
    _close(tv, jv)
    lengths = np.asarray([s, s - 3], np.int32)
    _close(TA.attend_decode(torch.from_numpy(q[:, -1:]), tk, tv,
                            torch.from_numpy(lengths)),
           jax.jit(JA.attend_decode)(jnp.asarray(q[:, -1:]), jk, jv,
                                     jnp.asarray(lengths)))


def test_cache_update_writes_only_each_row():
    kc = torch.zeros(3, 8, 2, 4)
    vc = torch.zeros(3, 8, 2, 4)
    new = torch.ones(3, 1, 2, 4)
    TA.cache_update(kc, vc, new, new, torch.tensor([0, 3, 7]))
    for i, p in enumerate([0, 3, 7]):
        assert float(kc[i, p].sum()) == float(kc[i].sum()) == 8


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _batch(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-8b", *MOE])
def test_forward_and_loss_match_jax(arch):
    jcfg, tcfg, params, model = _models(arch)
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    toks = _batch(jcfg, 2, 9, 1)
    labels = _batch(jcfg, 2, 9, 2)
    with torch.inference_mode():
        logits = api.forward(model, tcfg, {"tokens": torch.from_numpy(toks)})
        loss = api.loss_fn(model, tcfg, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
    _close(logits, _jit(japi.forward, 1)(params, jcfg,
                                         {"tokens": jnp.asarray(toks)}))
    _close(loss, _jit(japi.loss_fn, 1)(params, jcfg, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}))


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-8b", *MOE])
def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, params, model = _models(arch)
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    toks = _batch(jcfg, 2, 9, 3)
    jdecode = _jit(japi.decode_step, 1)
    jc, jl = _jit(japi.prefill, 1, 3)(
        params, jcfg, {"tokens": jnp.asarray(toks[:, :6])}, 16)
    with torch.inference_mode():
        tc, tl = api.prefill(model, tcfg,
                             {"tokens": torch.from_numpy(toks[:, :6])}, 16)
    _close(tl, jl)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])
    for t in range(6, 9):
        jl, jc = jdecode(params, jcfg, {
            "tokens": jnp.asarray(toks[:, t:t + 1]),
            "positions": jnp.full((2,), t, jnp.int32)}, jc)
        with torch.inference_mode():
            tl, tc = api.decode_step(model, tcfg, {
                "tokens": torch.from_numpy(toks[:, t:t + 1]),
                "positions": torch.full((2,), t)}, tc)
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-8b", *MOE])
def test_cache_batch_axes_match_jax(arch):
    jcfg, tcfg, params, model = _models(arch)
    axes, spec = cache_batch_axes(tcfg, model, 24)
    jaxes, jspec = jax_cache_batch_axes(jcfg, params, 24)
    assert axes == dict(jaxes)
    for name in ("k", "v"):
        assert tuple(spec[name].shape) == jspec[name].shape
        assert spec[name].device.type == "meta"


def test_init_draws_the_jax_shapes_from_a_generator():
    jcfg, tcfg = _configs("qwen3-8b")
    jparams = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    ref = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    gen = torch.Generator().manual_seed(7)
    model = get_model(tcfg).init(gen, tcfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in ref.named_parameters()}
    assert TT.param_count(model) == tcfg.param_count()
    again = get_model(tcfg).init(torch.Generator().manual_seed(7), tcfg)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    emb = model.embed["embedding"]
    assert float(emb.abs().max()) <= 2.0 / tcfg.vocab_size ** 0.5
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("module", [TT, ssm_lm])
def test_transformer_and_ssm_lm_refuse_a_hybrid_config(module):
    """Every family has its module (the hybrid's: ``models/hybrid.py``);
    the transformer and the Mamba1 LM refuse zamba2's config, naming its
    family."""
    cfg = t_reduced(t_get_config("zamba2-7b"))
    assert get_model(cfg).init is hybrid.init
    with pytest.raises(NotImplementedError, match="'hybrid'"):
        module.init(torch.Generator(), cfg)


# ---------------------------------------------------------------------------
# the MoE family: qwen2-moe-a2.7b (every layer MoE) and llama4-maverick
# (period 2: a dense layer, then an MoE layer) at the reduced widths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_get_model_takes_the_moe_family_at_published_widths(arch):
    cfg = t_get_config(arch)
    api = get_model(cfg)
    assert api.init is TT.init and api.prefill is TT.prefill
    assert api.decode_step is TT.decode_step


@pytest.mark.parametrize("arch", ["qwen3-8b", *MOE])
def test_cache_init_matches_jax(arch):
    jcfg, tcfg = _configs(arch)
    jc = jax_get_model(jcfg).cache_init(jcfg, 3, 24)
    tc = get_model(tcfg).cache_init(tcfg, 3, 24)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).removeprefix("torch.") == \
            str(jc[name].dtype)
        assert not tc[name].any()


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_matches_the_jax_shapes_and_dtypes(arch):
    """A bf16 model drawn from a generator: every leaf in the JAX layout has
    the shape and dtype of the JAX init's (``eval_shape``), the router and
    the shared gate f32; the parameter count is the config's."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _configs(arch))
    want = jax.eval_shape(lambda: jax_get_model(jcfg).init(
        jax.random.key(0), jcfg))
    model = get_model(tcfg).init(torch.Generator().manual_seed(3), tcfg)
    from repro_torch.models.convert import jax_tree
    got = jax_tree(dict(model.named_parameters()), tcfg)
    want_flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(got_flat) == set(want_flat)
    for path, leaf in want_flat.items():
        t = got_flat[path]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
    for layer in model.layers:
        if layer.group == "moe":
            assert layer.moe["router"].dtype == torch.float32
            assert layer.moe["shared_gate"].dtype == torch.float32
            assert layer.moe["wg"].dtype == torch.bfloat16
    assert TT.param_count(model) == tcfg.param_count()


@pytest.mark.parametrize("arch", MOE)
def test_moe_params_round_trip_and_decay_rule(arch):
    """``params_to_jax(params_from_jax(tree))`` is ``tree`` bit for bit, and
    the names ``decayed_names`` picks are the JAX leaves of ``ndim >= 2``:
    every per-layer tensor (an MoE layer's ``ln`` is (n_super, d))."""
    from repro_torch.models.convert import (decayed_names, jax_tree,
                                            params_to_jax)
    jcfg, tcfg, params, model = _models(arch)
    host = jax.tree.map(np.asarray, params)
    back = params_to_jax(model)
    want_flat = dict(jax.tree_util.tree_flatten_with_path(host)[0])
    got_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got_flat) == set(want_flat)
    for path, leaf in want_flat.items():
        np.testing.assert_array_equal(got_flat[path], leaf, err_msg=str(path))
    named = dict(model.named_parameters())
    dec = decayed_names(named, tcfg)
    flags = jax_tree({k: torch.full_like(p, float(k in dec))
                      for k, p in named.items()}, tcfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(flags)[0]:
        assert bool((leaf == 1).all()) == (want_flat[path].ndim >= 2), path
    assert "final_norm" not in dec
    assert any(k.endswith("moe.ln") for k in dec)
    assert any(k.endswith("moe.shared.wg") for k in dec)


# ---------------------------------------------------------------------------
# the SSM family: Mamba1 blocks and the falcon-mamba LM at the reduced
# widths (d_model 64, d_inner 128, N 8, 4 layers, f32)
# ---------------------------------------------------------------------------
SSM = "falcon-mamba-7b"


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _mamba_params(seed=0):
    """JAX ``mamba1_init`` params, with the leaves it sets to constants
    (conv_b, dt_bias, A_log, D) drawn at random so they are tested too."""
    jcfg, tcfg = _configs(SSM, 4)
    p = dict(JS.mamba1_init(jax.random.key(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    di, st = jcfg.d_inner, jcfg.ssm_state
    p["conv_b"] = jnp.asarray(_randn(rng, di) * 0.1)
    p["dt_bias"] = jnp.asarray(_randn(rng, di) * 0.5 - 2.0)
    p["A_log"] = p["A_log"] + jnp.asarray(_randn(rng, di, st) * 0.1)
    p["D"] = jnp.asarray(_randn(rng, di))
    return jcfg, tcfg, p, _t(p)


def test_causal_conv_and_conv_step_match_jax():
    rng = np.random.default_rng(10)
    x, w, b = _randn(rng, 2, 9, 6), _randn(rng, 4, 6), _randn(rng, 6)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    _close(TS._causal_conv(tx, tw, tb),
           JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    state = np.zeros((2, 3, 6), np.float32)
    jstate, tstate = jnp.asarray(state), torch.from_numpy(state)
    for t in range(9):
        jy, jstate = JS._conv_step(jstate, jnp.asarray(x[:, t]),
                                   jnp.asarray(w), jnp.asarray(b))
        ty, tstate = TS._conv_step(tstate, tx[:, t], tw, tb)
        _close(ty, jy)
        _close(tstate, jstate)


def test_mamba1_ssm_inputs_match_jax():
    """The port hands dt, A, Bm, Cm to the scan; the decay and input the
    JAX twin materialises follow from them."""
    jcfg, tcfg, jp, tp = _mamba_params(1)
    x_conv = _randn(np.random.default_rng(11), 2, 7, jcfg.d_inner)
    ja, jb, jc = JS._mamba1_ssm_inputs(jp, jnp.asarray(x_conv), jcfg)
    dt, A, Bm, Cm = TS._mamba1_ssm_inputs(tp, torch.from_numpy(x_conv), tcfg)
    assert dt.dtype == A.dtype == torch.float32
    _close(torch.exp(dt[..., None] * A), ja)
    _close((dt * torch.from_numpy(x_conv))[..., None] * Bm[:, :, None, :], jb)
    _close(Cm, jc)


def test_mamba1_apply_and_decode_match_jax():
    """mamba1_apply, its final state, and mamba1_decode token by token
    (writing its state in place) against the JAX package's."""
    jcfg, tcfg, jp, tp = _mamba_params(2)
    b, s = 2, 10
    x = _randn(np.random.default_rng(12), b, s, jcfg.d_model) * 0.3
    y, st = TS.mamba1_apply(tp, torch.from_numpy(x), tcfg, return_state=True)
    _close(y, _jit(JS.mamba1_apply, 2)(jp, jnp.asarray(x), jcfg))
    _close(TS.mamba1_apply(tp, torch.from_numpy(x), tcfg), y.numpy())
    jstate = JS.mamba1_state_init(b, jcfg, jnp.float32)
    tstate = TS.mamba1_state_init(b, tcfg, torch.float32)
    held = {k: v for k, v in tstate.items()}
    jdecode = _jit(JS.mamba1_decode, 3)
    for t in range(s):
        jy, jstate = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jstate, jcfg)
        ty, tstate = TS.mamba1_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      tstate, tcfg)
        _close(ty, jy)
        for k in ("conv", "h"):
            assert tstate[k] is held[k]                  # written in place
            _close(tstate[k], jstate[k])
    _close(st["conv"], jstate["conv"])
    _close(st["h"], jstate["h"])


def test_reference_scan_matches_jax():
    rng = np.random.default_rng(13)
    a = 1 / (1 + np.exp(-_randn(rng, 2, 12, 5, 3)))
    b, h0 = _randn(rng, 2, 12, 5, 3), _randn(rng, 2, 5, 3)
    _close(TS.reference_scan(*map(torch.from_numpy, (a, b, h0))),
           JS.reference_scan(*map(jnp.asarray, (a, b, h0))))


def test_ssm_lm_forward_and_loss_match_jax():
    jcfg, tcfg, params, model = _models(SSM, n_layers=4)
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    toks, labels = _batch(jcfg, 2, 9, 1), _batch(jcfg, 2, 9, 2)
    with torch.inference_mode():
        logits = api.forward(model, tcfg, {"tokens": torch.from_numpy(toks)})
        loss = api.loss_fn(model, tcfg, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
    _close(logits, _jit(japi.forward, 1)(params, jcfg,
                                         {"tokens": jnp.asarray(toks)}))
    _close(loss, _jit(japi.loss_fn, 1)(params, jcfg, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}))


@pytest.mark.parametrize("plen", [2, 6])     # 2 < K - 1: the left pad
def test_ssm_lm_prefill_and_decode_match_jax(plen):
    jcfg, tcfg, params, model = _models(SSM, n_layers=4)
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    toks = _batch(jcfg, 2, plen + 3, 3)
    jc, jl = _jit(japi.prefill, 1, 3)(
        params, jcfg, {"tokens": jnp.asarray(toks[:, :plen])}, 16)
    with torch.inference_mode():
        tc, tl = api.prefill(model, tcfg,
                             {"tokens": torch.from_numpy(toks[:, :plen])}, 16)
    _close(tl, jl)
    for name in ("conv", "h"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])
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
        for name in ("conv", "h"):
            assert tc[name] is held[name]                # written in place
            _close(tc[name], jc[name])


def test_ssm_cache_batch_axes_and_cache_init_match_jax():
    jcfg, tcfg, params, model = _models(SSM, n_layers=4)
    axes, spec = cache_batch_axes(tcfg, model, 24)
    jaxes, jspec = jax_cache_batch_axes(jcfg, params, 24)
    assert axes == dict(jaxes) == {"conv": 1, "h": 1}
    jcache = jax_get_model(jcfg).cache_init(jcfg, 3, 24)
    cache = get_model(tcfg).cache_init(tcfg, 3, 24)
    for name in ("conv", "h"):
        assert tuple(spec[name].shape) == jspec[name].shape
        assert spec[name].device.type == "meta"
        assert tuple(cache[name].shape) == jcache[name].shape
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(jcache[name].dtype)
    # a Mamba cache does not grow with the sequence budget
    assert {k: v.shape for k, v in get_model(tcfg).cache_init(
        tcfg, 3, 4096).items()} == {k: v.shape for k, v in cache.items()}


def test_ssm_init_draws_the_jax_shapes_from_a_generator():
    jcfg, tcfg = _configs(SSM, 4)
    jparams = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    ref = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    model = get_model(tcfg).init(torch.Generator().manual_seed(7), tcfg)
    shapes = {n: (tuple(p.shape), p.dtype)
              for n, p in model.named_parameters()}
    assert shapes == {n: (tuple(p.shape), p.dtype)
                      for n, p in ref.named_parameters()}
    assert TT.param_count(model) == tcfg.param_count() == \
        jcfg.param_count()
    again = get_model(tcfg).init(torch.Generator().manual_seed(7), tcfg)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    assert not any(p.requires_grad for p in model.parameters())
    bf16 = dataclasses.replace(tcfg, dtype="bfloat16")
    layer = get_model(bf16).init(torch.Generator().manual_seed(7),
                                 bf16).layers[0]
    assert layer["A_log"].dtype == layer["D"].dtype == torch.float32
    assert layer["in_proj"].dtype == layer["dt_bias"].dtype == torch.bfloat16


def test_params_from_jax_bf16_keeps_A_log_and_D_f32():
    jcfg, tcfg = _configs(SSM, 2)
    tree = jax.tree.map(np.asarray,
                        jax_get_model(jcfg).init(jax.random.key(1), jcfg))
    model = params_from_jax(tree, tcfg, "cpu", dtype="bfloat16")
    for layer in model.layers:
        assert layer["A_log"].dtype == layer["D"].dtype == torch.float32
        assert layer["dt_bias"].dtype == layer["x_proj"].dtype == \
            torch.bfloat16
    np.testing.assert_array_equal(model.layers[1]["A_log"].numpy(),
                                  tree["layers"]["A_log"][1])
    assert model.embed["embedding"].dtype == torch.bfloat16


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


def test_ssm_scan_dtype_other_than_float32_raises():
    """Other than the dtypes the JAX package computes (float32, bfloat16,
    float16, and float64 as f32; tests/test_torch_float16.py): a name no
    JAX config sets raises, naming itself; bfloat16 is honoured."""
    _, tcfg = _configs(SSM, 2)
    cfg = dataclasses.replace(tcfg, ssm_scan_dtype="float8_e4m3fn")
    with pytest.raises(NotImplementedError, match="'float8_e4m3fn'"):
        get_model(cfg).init(torch.Generator(), cfg)
    _, _, _, tp = _mamba_params(3)
    with pytest.raises(NotImplementedError, match="no config of the JAX"):
        TS.mamba1_apply(tp, torch.zeros(1, 3, cfg.d_model), cfg)
    get_model(_bf16(tcfg)).init(torch.Generator(), _bf16(tcfg))


def test_mamba1_bf16_state_apply_prefill_and_decode_match_jax():
    """ssm_scan_dtype="bfloat16": mamba1_apply within BF16_TOL of the JAX
    package's (measured 2.3e-4), and not the f32 output; the training
    path's forward the same bits as serving's; a prefill hands decode the
    f32 path's state bit for bit (the JAX prefill's f32 second pass); decode
    ignores the knob (bit for bit the f32 config's)."""
    jcfg, tcfg, jp, tp = _mamba_params(2)
    j16, t16 = _bf16(jcfg), _bf16(tcfg)
    x = torch.from_numpy(_randn(np.random.default_rng(14), 2, 40,
                                jcfg.d_model) * 0.5)
    with torch.no_grad():
        y, st = TS.mamba1_apply(tp, x, t16, return_state=True)
        y32, st32 = TS.mamba1_apply(tp, x, tcfg, return_state=True)
    _near(y, _jit(JS.mamba1_apply, 2)(jp, jnp.asarray(x.numpy()), j16))
    assert not torch.equal(y, y32)
    assert torch.equal(TS.mamba1_apply(tp, x, t16).detach(), y)
    for k in ("conv", "h"):
        assert torch.equal(st[k], st32[k])
    s16 = {k: v.clone() for k, v in st.items()}
    for t in range(3):
        xt = x[:, t:t + 1]
        d16, s16 = TS.mamba1_decode(tp, xt, s16, t16)
        d32, st32 = TS.mamba1_decode(tp, xt, st32, tcfg)
        assert torch.equal(d16, d32)
        assert all(torch.equal(s16[k], st32[k]) for k in s16)


def test_ssm_lm_bf16_state_forward_prefill_and_decode_match_jax():
    """ssm_lm at ssm_scan_dtype="bfloat16": logits, the loss, the prefill's
    cache and three decode steps within BF16_TOL of the JAX package's
    (measured at most 5.9e-3: the logits)."""
    jcfg, tcfg, params, model = _models(SSM, n_layers=4)
    jcfg, tcfg = _bf16(jcfg), _bf16(tcfg)
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    toks, labels = _batch(jcfg, 2, 12, 1), _batch(jcfg, 2, 12, 2)
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
    for name in ("conv", "h"):
        _near(tc[name], jc[name])
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
        _near(tc["h"], jc["h"])
