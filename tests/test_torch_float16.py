"""float16: the models at ``dtype="float16"`` and the scan's
``ssm_scan_dtype="float16"`` against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and fed to both packages; model
parameters are the JAX ``init`` params at f16 carried across by
``params_from_jax``.  Held here:

* every arch of ``list_archs()`` at ``dtype="float16"``, reduced to 2
  layers (MoE 4): logits within F16_TOL of the largest |JAX logit|
  (measured at most 2.6e-3, zamba2-7b); the SSM families also with the
  scan's state in f16, through prefill and decode (2.1e-3);
* the plain f16-state scan against the JAX ``reference_scan`` at f16, every
  state bit for bit.  XLA's CPU backend computes an f16 ``a * h + b`` in
  f32 and rounds once, where it stores the result (pinned below); the
  port's ``ref.mul_add`` does the same;
* ``ssm_scan_chunked`` at f16 against the JAX ``_assoc_scan_chunked`` at
  f16, chunks 8, 128 and 1024 with an S that none divides: within one f16
  ulp of the largest state, and at most CHUNKED_SHARE of the states not
  bit for bit (2 of 7200 on the inputs below).  Inside the associative scan
  XLA keeps a product in f32 where its fusion recomputes it from the
  inputs and rounds it where a fusion stores it, so which products are
  rounded depends on how XLA fuses the scan's levels; the port rounds
  each combine's outputs, as XLA does for all but a few.  That the
  compilation is the cause is held too: run op by op (``jax.disable_jit``)
  the JAX scan gives bit for bit the port's chunked scan with each
  operation rounded;
* ``SSMScan``'s f16 gradients against ``jax.grad`` within GRAD_TOL
  (5.1e-4);
* a loss and its gradients at ``dtype="float16"`` for qwen3-8b and
  falcon-mamba-7b against ``jax.value_and_grad`` (2.8e-3);
* ``ssm_scan_dtype="float64"`` giving the f32 mode's result exactly (the
  JAX package never enables x64, so its float64 scan runs in f32), and a
  name no JAX config sets still raising.

A state is read through y with C one-hot in it, as in
``test_torch_ssm_bf16.py``, and the JAX scans get the decays torch
computes (XLA's CPU ``exp`` and torch's differ by an f32 ulp on some
values).  The JAX side runs under ``jax.jit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs, reduced
from repro.models import get_model as jax_get_model
from repro.models import registry as JR
from repro.models import ssm as JS

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import mul_add
from repro_torch.models import get_model
from repro_torch.models import registry as TR
from repro_torch.models import ssm as TS
from repro_torch.models.convert import (F32_LEAVES, named_from_jax,
                                        params_from_jax)

F16 = torch.float16
F16_TOL = 5e-3          # of the largest |JAX output| (logits: 2.6e-3)
CHUNKED_SHARE = 1e-3    # states of the chunked scan not bit for bit
GRAD_TOL = 1e-2         # of each input's largest |JAX gradient|
SSM_ARCHS = ["falcon-mamba-7b", "zamba2-7b"]


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _configs(arch, **kw):
    """Reduced configs of 2 layers (an MoE arch 4) at dtype float16 and
    ``kw``."""
    n_layers = 4 if get_config(arch).family == "moe" else 2
    kw = {"n_layers": n_layers, "dtype": "float16", **kw}
    return (dataclasses.replace(reduced(get_config(arch)), **kw),
            dataclasses.replace(t_reduced(t_get_config(arch)), **kw))


def _models(arch, seed=0, **kw):
    jcfg, tcfg = _configs(arch, **kw)
    params = jax_get_model(jcfg).init(jax.random.key(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, model


def _batches(jcfg, tcfg, b, s, seed, train=False):
    """The same batch for both packages: tokens (and labels), and a VLM's or
    an audio model's stub frontend inputs."""
    shapes = JR.train_batch_shapes if train else JR.prefill_batch_shapes
    t_shapes = TR.train_batch_shapes if train else TR.prefill_batch_shapes
    return (JR.make_concrete_batch(shapes(jcfg, b, s),
                                   np.random.default_rng(seed),
                                   jcfg.vocab_size),
            TR.make_concrete_batch(t_shapes(tcfg, b, s),
                                   np.random.default_rng(seed),
                                   tcfg.vocab_size))


def _jax_h(cache):
    """The SSM state of a JAX cache: ``h``, under ``ssm`` in the hybrid's."""
    return cache["ssm"]["h"] if "ssm" in cache else cache["h"]


def _near(port, ref, tol=F16_TOL):
    """|port - ref| within ``tol`` of the largest |ref|; returns the
    ratio."""
    p = np.asarray(port.detach().float(), np.float64)
    r = np.asarray(ref, np.float64)
    assert p.shape == r.shape
    err = float(np.abs(p - r).max() / np.abs(r).max())
    assert err <= tol, err
    return err


# ---------------------------------------------------------------------------
# the models at dtype float16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_forward_at_float16_matches_jax(arch):
    jcfg, tcfg, params, model = _models(arch)
    jb, tb = _batches(jcfg, tcfg, 2, 9, 1)
    want = _jit(jax_get_model(jcfg).forward, 1)(params, jcfg, jb)
    assert want.dtype == jnp.float16
    with torch.inference_mode():
        got = get_model(tcfg).forward(model, tcfg, tb)
    assert got.dtype == F16
    _near(got, want)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_families_with_a_float16_state_match_jax(arch):
    """dtype and ssm_scan_dtype float16: logits, the loss, a prefill's
    logits and cache and three decode steps within F16_TOL of the JAX
    package's; the cache's state f32, as the JAX prefill's."""
    jcfg, tcfg, params, model = _models(arch, ssm_scan_dtype="float16")
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    jb, tb = _batches(jcfg, tcfg, 2, 12, 2, train=True)
    with torch.inference_mode():
        logits = api.forward(model, tcfg, tb)
        loss = api.loss_fn(model, tcfg, tb)
        tc, tl = api.prefill(model, tcfg, {"tokens": tb["tokens"][:, :9]},
                             16)
    _near(logits, _jit(japi.forward, 1)(params, jcfg, jb))
    _near(loss, _jit(japi.loss_fn, 1)(params, jcfg, jb))
    jc, jl = _jit(japi.prefill, 1, 3)(
        params, jcfg, {"tokens": jb["tokens"][:, :9]}, 16)
    _near(tl, jl)
    assert tc["h"].dtype == torch.float32
    _near(tc["h"], _jax_h(jc))
    jdecode = _jit(japi.decode_step, 1)
    for t in range(9, 12):
        jl, jc = jdecode(params, jcfg, {
            "tokens": jb["tokens"][:, t:t + 1],
            "positions": jnp.full((2,), t, jnp.int32)}, jc)
        with torch.inference_mode():
            tl, tc = api.decode_step(model, tcfg, {
                "tokens": tb["tokens"][:, t:t + 1],
                "positions": torch.full((2,), t)}, tc)
        _near(tl, jl)
        _near(tc["h"], _jax_h(jc))


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b"])
def test_loss_and_gradients_at_float16_match_jax(arch):
    """One loss and its gradients at dtype float16 against
    ``jax.value_and_grad``: the loss within F16_TOL, each leaf's gradient
    (f16, as JAX's) within GRAD_TOL of the leaf's largest |JAX gradient|."""
    jcfg, tcfg, params, model = _models(arch)
    jb, tb = _batches(jcfg, tcfg, 2, 12, 3, train=True)
    japi, api = jax_get_model(jcfg), get_model(tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, jcfg, jb)))(params)
    model.requires_grad_()
    loss = api.loss_fn(model, tcfg, tb)
    loss.backward()
    _near(loss, jloss)
    want = named_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert p.grad.dtype == p.dtype, name
        _near(p.grad, want[name].astype(np.float32), GRAD_TOL)


def test_params_from_jax_carries_float16_leaves():
    """A JAX f16 model's leaves cross as f16, bit for bit; the leaves the
    JAX init keeps in f32 stay f32."""
    for arch in ("zamba2-7b", "qwen2-moe-a2.7b"):
        jcfg, tcfg = _configs(arch)
        tree = jax.tree.map(np.asarray, jax_get_model(jcfg).init(
            jax.random.key(1), jcfg))
        src = named_from_jax(tree, tcfg)
        model = params_from_jax(tree, tcfg, "cpu")
        keep = F32_LEAVES.get(tcfg.family, ())
        for name, p in model.named_parameters():
            assert p.dtype == (torch.float32 if src[name].dtype == np.float32
                               else F16), name
            np.testing.assert_array_equal(p.numpy(), src[name])
        assert any(p.dtype == torch.float32 and n.rsplit(".", 1)[-1] in keep
                   for n, p in model.named_parameters())


def test_stub_frontend_inputs_stay_bf16_at_float16():
    """Both registries give a VLM's patches and an audio model's frames in
    bf16 whatever the model dtype."""
    for arch in ("internvl2-1b", "whisper-medium"):
        jcfg, tcfg = _configs(arch)
        (name, (_, jdt)), = [(k, v) for k, v in JR.prefill_batch_shapes(
            jcfg, 1, 4).items() if k != "tokens"]
        assert jdt == jnp.bfloat16
        assert TR.prefill_batch_shapes(tcfg, 1, 4)[name][1] == torch.bfloat16


# ---------------------------------------------------------------------------
# the scan with an f16 state
# ---------------------------------------------------------------------------
def _inputs(b, s, d, n, seed):
    rng = np.random.default_rng(seed)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, d)))) * 0.3) \
        .astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal((d, n))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    return dt, A, Bm, Cm, x


def _ab(dt, A, Bm, x):
    """The decay and the input as the port's scans compute them, in f32,
    as JAX f16 arrays."""
    dt, A, Bm, x = map(torch.from_numpy, (dt, A, Bm, x))
    a = torch.exp(dt[..., None] * A)
    b = (dt * x)[..., None] * Bm[:, :, None, :]
    return (jnp.asarray(a.numpy()).astype(jnp.float16),
            jnp.asarray(b.numpy()).astype(jnp.float16))


def _one_hot(cm, k):
    out = np.zeros_like(cm)
    out[..., k] = 1
    return torch.from_numpy(out)


def _states(scan, dt, A, Bm, Cm, x):
    """Every state (B, S, D, N) of ``scan`` (a function returning y), each
    read through y with C one-hot in it."""
    t = [torch.from_numpy(v) for v in (dt, A, Bm, x)]
    return torch.stack([scan(t[0], t[1], t[2], _one_hot(Cm, k), t[3])
                        for k in range(A.shape[1])], dim=-1)


def test_jax_f16_scan_rounds_a_multiply_add_once():
    """What the port follows: the JAX ``reference_scan`` at f16 is the
    recurrence rounded once a step (``mul_add``), not once an operation,
    and the two differ on these inputs."""
    dt, A, Bm, _, x = _inputs(2, 300, 6, 4, 0)
    a, b = _ab(dt, A, Bm, x)
    want = np.asarray(jax.jit(JS.reference_scan)(
        a, b, jnp.zeros((2, 6, 4), jnp.float16)).astype(jnp.float32))
    ta, tb = (torch.from_numpy(np.asarray(v).astype(np.float16))
              for v in (a, b))
    once = torch.zeros(2, 6, 4, dtype=F16)
    twice = once.clone()
    ones, twos = [], []
    for t in range(300):
        once = mul_add(ta[:, t], once, tb[:, t])
        twice = ta[:, t] * twice + tb[:, t]
        ones.append(once)
        twos.append(twice)
    np.testing.assert_array_equal(torch.stack(ones, 1).float().numpy(), want)
    assert not np.array_equal(torch.stack(twos, 1).float().numpy(), want)


def test_plain_f16_state_equals_jax_reference_scan_bit_for_bit():
    dt, A, Bm, Cm, x = _inputs(2, 300, 6, 4, 0)
    a, b = _ab(dt, A, Bm, x)
    want = np.asarray(jax.jit(JS.reference_scan)(
        a, b, jnp.zeros((2, 6, 4), jnp.float16)).astype(jnp.float32))
    got = _states(lambda *t: ops.ssm_scan_plain(*t, state_dtype=F16),
                  dt, A, Bm, Cm, x)
    np.testing.assert_array_equal(got.numpy(), want)
    y, h = ops.ssm_scan_plain(*map(torch.from_numpy, (dt, A, Bm, Cm, x)),
                              return_state=True, state_dtype=F16)
    np.testing.assert_array_equal(h.numpy(), want[:, -1])
    c16 = Cm.astype(np.float16).astype(np.float32)
    np.testing.assert_allclose(y.numpy(), np.einsum("bscn,bsn->bsc", want,
                                                    c16), rtol=0, atol=1e-6)


# (B, S, D, N, chunk): the JAX chunk rule makes chunks of 5, 100 and 750
CHUNKED_SHAPES = [(2, 100, 8, 4, 8), (1, 300, 6, 4, 128),
                  (1, 1500, 4, 4, 1024)]


@pytest.mark.parametrize("shape", CHUNKED_SHAPES)
def test_ssm_scan_chunked_f16_states_match_jax(shape):
    """The JAX chunk rule (5, 100 and 750 steps here); every state within
    one f16 ulp of the largest, all but CHUNKED_SHARE of them bit for
    bit."""
    b, s, d, n, chunk = shape
    dt, A, Bm, Cm, x = _inputs(b, s, d, n, s)
    a, bb = _ab(dt, A, Bm, x)
    hs, _ = jax.jit(JS._assoc_scan_chunked, static_argnums=3)(
        a, bb, jnp.zeros((b, d, n), jnp.float16), chunk)
    want = np.asarray(hs.astype(jnp.float32))
    got = _states(lambda *t: ops.ssm_scan_chunked(*t, chunk=chunk,
                                                  state_dtype=F16),
                  dt, A, Bm, Cm, x).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -11 * np.abs(want).max()
    assert np.mean(got != want) <= CHUNKED_SHARE
    y = ops.ssm_scan_chunked(*map(torch.from_numpy, (dt, A, Bm, Cm, x)),
                             chunk=chunk, state_dtype=F16)
    np.testing.assert_allclose(y.numpy(), np.einsum(
        "bscn,bsn->bsc", got, Cm.astype(np.float16).astype(np.float32)),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", CHUNKED_SHAPES)
def test_ssm_scan_chunked_f16_is_the_jax_scan_op_by_op(shape, monkeypatch):
    """Where the chunked scan's states are not bit for bit, XLA's
    compilation is the cause, not the port's order of operations.  Run op
    by op (``jax.disable_jit``: each operation's result stored, so rounded
    to f16), ``_assoc_scan_chunked`` gives bit for bit the states of the
    port's chunked scan with each operation rounded (``mul_add`` as ``a * h
    + b`` in f16); compiled, it gives other states on these inputs, which
    the port's rounding once a multiply-add (the test above) follows."""
    b, s, d, n, chunk = shape
    dt, A, Bm, Cm, x = _inputs(b, s, d, n, s)
    a, bb = _ab(dt, A, Bm, x)
    h0 = jnp.zeros((b, d, n), jnp.float16)
    with jax.disable_jit():
        eager = np.asarray(JS._assoc_scan_chunked(a, bb, h0, chunk)[0]
                           .astype(jnp.float32))
    jitted = np.asarray(_jit(JS._assoc_scan_chunked, 3)(a, bb, h0, chunk)[0]
                        .astype(jnp.float32))
    monkeypatch.setattr(ops, "mul_add", lambda a, h, b: a * h + b)
    got = _states(lambda *t: ops.ssm_scan_chunked(*t, chunk=chunk,
                                                  state_dtype=F16),
                  dt, A, Bm, Cm, x).numpy()
    np.testing.assert_array_equal(got, eager)
    assert np.mean(jitted != eager) > 0.1


def test_ssm_scan_function_f16_gradients_match_jax():
    b, s, d, n, chunk = 1, 96, 6, 8, 32
    dt, A, Bm, Cm, x = _inputs(b, s, d, n, 2)
    g = np.random.default_rng(3).standard_normal((b, s, d)).astype(np.float32)

    def loss(dt, A, Bm, Cm, x):
        a = jnp.exp(dt[..., None] * A).astype(jnp.float16)
        bb = ((dt * x)[..., None] * Bm[:, :, None, :]).astype(jnp.float16)
        hs, _ = JS._assoc_scan_chunked(a, bb, jnp.zeros((b, d, n),
                                                        jnp.float16), chunk)
        y = jnp.einsum("bscn,bsn->bsc", hs, Cm.astype(jnp.float16),
                       preferred_element_type=jnp.float32)
        return jnp.sum(y * g)
    want = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(dt, A, Bm, Cm, x)
    ins = [torch.from_numpy(v).requires_grad_() for v in (dt, A, Bm, Cm, x)]
    got = torch.autograd.grad(ops.SSMScan.apply(*ins, F16, chunk), ins,
                              torch.from_numpy(g))
    for name, gp, gj in zip(("dt", "A", "Bm", "Cm", "x"), got, want):
        _near(gp, np.asarray(gj), GRAD_TOL)
    # and they are the f16 scan's, not the f32 one's
    f32 = torch.autograd.grad(ops.SSMScan.apply(*ins), ins,
                              torch.from_numpy(g))
    assert not all(torch.equal(a, b) for a, b in zip(got, f32))


def test_mamba1_and_mamba2_float16_state_prefill_hands_decode_f32():
    """A prefill with an f16 state computes y from the f16 scan (not the
    f32 one) and hands decode the f32 mode's state bit for bit; decode
    ignores the knob."""
    for arch, apply, decode in (
            ("falcon-mamba-7b", TS.mamba1_apply, TS.mamba1_decode),
            ("zamba2-7b", TS.mamba2_apply, TS.mamba2_decode)):
        _, tcfg = _configs(arch, dtype="float32")
        t16 = dataclasses.replace(tcfg, ssm_scan_dtype="float16")
        init = TS.mamba1_init if arch == "falcon-mamba-7b" else \
            TS.mamba2_init
        p = init(torch.Generator().manual_seed(0), tcfg, torch.float32)
        x = torch.randn(2, 40, tcfg.d_model,
                        generator=torch.Generator().manual_seed(1)) * 0.5
        with torch.no_grad():
            y, st = apply(p, x, t16, return_state=True)
            y32, st32 = apply(p, x, tcfg, return_state=True)
            assert not torch.equal(y, y32)
            assert torch.equal(apply(p, x, t16), y)
            assert all(torch.equal(st[k], st32[k]) for k in st)
            s16 = {k: v.clone() for k, v in st.items()}
            for t in range(3):
                d16, s16 = decode(p, x[:, t:t + 1], s16, t16)
                d32, st32 = decode(p, x[:, t:t + 1], st32, tcfg)
                assert torch.equal(d16, d32)


def test_scan_dtype_float64_is_the_f32_mode():
    """"float64" runs the f32 mode (the JAX package computes it in f32:
    x64 is never enabled): the port's forward the float32 config's bit for
    bit, the JAX package's float64 forward its float32 one's, and the two
    packages agree."""
    for arch in SSM_ARCHS:
        jcfg, tcfg, params, model = _models(arch, dtype="float32")
        j64, t64 = (dataclasses.replace(c, ssm_scan_dtype="float64")
                    for c in (jcfg, tcfg))
        jb, tb = _batches(jcfg, tcfg, 2, 9, 4)
        with torch.inference_mode():
            got = get_model(t64).forward(model, t64, tb)
            assert torch.equal(got, get_model(tcfg).forward(model, tcfg, tb))
        with pytest.warns(UserWarning, match="float64"):
            want = _jit(jax_get_model(j64).forward, 1)(params, j64, jb)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(
            _jit(jax_get_model(jcfg).forward, 1)(params, jcfg, jb)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        assert TS.scan_mode(t64) == TS.scan_mode(tcfg)


def test_a_scan_dtype_no_jax_config_sets_still_raises():
    _, tcfg = _configs("falcon-mamba-7b")
    cfg = dataclasses.replace(tcfg, ssm_scan_dtype="int8")
    with pytest.raises(NotImplementedError, match="'int8'.*no config"):
        get_model(cfg).init(torch.Generator(), cfg)
    t = list(map(torch.from_numpy, _inputs(1, 4, 2, 2, 4)))
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        ops.ssm_scan(*t, state_dtype=torch.float64)
