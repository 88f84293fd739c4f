"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's ``repro/models/moe.py``, on the CPU.

Inputs are drawn with numpy from a seed; expert weights are the JAX
``moe_init`` draws carried across as tensors.  The configs are the reduced
qwen2-moe-a2.7b (4 experts, top-2, a shared expert) and llama4-maverick
(4 experts, top-1, a shared expert), at their capacity factor 4.0, where no
pair drops, and at 0.05, where pairs drop and both packages must drop the
same ones.  Float32 throughout: outputs and gradients within 1e-5, gates
within 1e-6; integer routing and dispatch bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import moe as JM

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import moe as TM

MOE = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(arch, **kw):
    return (dataclasses.replace(reduced(get_config(arch)), **kw),
            dataclasses.replace(t_reduced(t_get_config(arch)), **kw))


def _params(jcfg, seed=0, dtype=jnp.float32):
    p = JM.moe_init(jax.random.key(seed), jcfg, dtype)
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cfg_name", ["qwen2-moe-a2.7b", "llama4",
                                      "qwen2-moe-reduced", "llama4-reduced",
                                      "cf-0.05"])
def test_capacity_matches_jax(cfg_name):
    arch = MOE[0] if cfg_name.startswith("qwen") else MOE[1]
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    if cfg_name.endswith("reduced"):
        jcfg, tcfg = reduced(jcfg), t_reduced(tcfg)
    if cfg_name == "cf-0.05":
        jcfg, tcfg = _configs(MOE[0], capacity_factor=0.05)
    for t in [1, 2, 7, 8, 15, 16, 17, 31, 32, 33, 100, 127, 512, 1000, 1023,
              2048, 4096, 8191, 8192, 12345]:
        assert TM.capacity(t, tcfg) == JM.capacity(t, jcfg), t


@pytest.mark.parametrize("arch", MOE)
def test_route_matches_jax(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg)
    x = _x((37, 64))
    jidx, jg = JM.route(jp, jnp.asarray(x), jcfg)
    tidx, tg = TM.route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=1e-5)


def test_route_ties_go_to_the_lower_index_as_in_jax():
    """Gates [.25, .25, .25, .25, .1, .25] at k = 3 (logits log of them,
    through a one-hot x), and an all-zero router (every gate 1/E): JAX's
    top_k takes the lowest indices among equals, and so must the port."""
    gates = np.asarray([.25, .25, .25, .25, .1, .25], np.float32)
    cfgs = []
    for e, k in ((6, 3), (4, 2), (60, 4)):
        jcfg, tcfg = _configs(MOE[0], n_experts=e, top_k=k)
        cfgs.append((jcfg, tcfg, e, k))
    for jcfg, tcfg, e, k in cfgs:
        router = np.zeros((64, e), np.float32)
        if e == 6:
            router[0] = np.log(gates)
        x = np.zeros((5, 64), np.float32)
        x[:, 0] = 1.0
        jidx, jg = JM.route({"router": jnp.asarray(router)}, jnp.asarray(x),
                            jcfg)
        tidx, tg = TM.route({"router": torch.from_numpy(router)},
                            torch.from_numpy(x), tcfg)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tidx.numpy()[0], np.arange(k))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("t,k,e", [(6, 1, 2), (37, 2, 4), (64, 4, 60),
                                   (300, 1, 128)])
def test_dispatch_indices_bit_equal(t, k, e):
    if (t, k, e) == (6, 1, 2):      # tests/test_moe.py's fixed case
        idx = np.asarray([[0], [1], [0], [0], [1], [0]], np.int32)
    else:
        idx = np.random.default_rng(t).integers(0, e, (t, k)).astype(
            np.int32)
    cap = 2
    je, jpos = JM.dispatch_indices(jnp.asarray(idx), e, cap)
    te, tpos = TM.dispatch_indices(torch.from_numpy(idx).long(), e, cap)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    if t == 6:
        assert list(tpos.numpy()[te.numpy() == 0]) == [0, 1, 2, 3]
        assert list(tpos.numpy()[te.numpy() == 1]) == [0, 1]


def _dropped(mod, p, x, cfg):
    xt = x.reshape(-1, x.shape[-1])
    c = mod.capacity(xt.shape[0], cfg)
    idx, _ = mod.route(p, xt, cfg)
    _, pos = mod.dispatch_indices(idx, cfg.n_experts, c)
    return np.asarray(pos) >= c


@pytest.mark.parametrize("cf", [4.0, 0.05])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_jax(arch, cf):
    jcfg, tcfg = _configs(arch, capacity_factor=cf)
    jp, tp = _params(jcfg)
    x = _x((4, 8, 64))
    want = np.asarray(JM.moe_ffn(jp, jnp.asarray(x), jcfg))
    got = TM.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jdrop = _dropped(JM, jp, jnp.asarray(x), jcfg)
    tdrop = _dropped(TM, tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tdrop, jdrop)
    assert tdrop.any() == (cf < 1)


def test_capacity_depends_on_the_call():
    """At cf 0.05 a batched call drops pairs that the same tokens keep in a
    call of their own (the capacity comes from the call's token count):
    both packages drop the same pairs in the batch, and keep them alone."""
    jcfg, tcfg = _configs(MOE[0], capacity_factor=0.05)
    jp, tp = _params(jcfg)
    x = _x((32, 64), seed=3)
    drop = _dropped(TM, tp, torch.from_numpy(x), tcfg).reshape(32, -1)
    np.testing.assert_array_equal(
        drop.reshape(-1), _dropped(JM, jp, jnp.asarray(x), jcfg))
    lost = np.flatnonzero(drop.any(-1))[:2]      # tokens that lost a pair
    assert len(lost) == 2
    for mod, p, arr, cfg in ((JM, jp, jnp.asarray, jcfg),
                             (TM, tp, torch.from_numpy, tcfg)):
        assert not _dropped(mod, p, arr(x[lost]), cfg).any()
    batched = TM.moe_ffn(tp, torch.from_numpy(x), tcfg)[lost].numpy()
    alone = TM.moe_ffn(tp, torch.from_numpy(x[lost]), tcfg).numpy()
    jalone = np.asarray(JM.moe_ffn(jp, jnp.asarray(x[lost]), jcfg))
    np.testing.assert_allclose(alone, jalone, **TOL)
    assert not np.allclose(batched, alone, **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_dense_oracle_matches_jax_and_moe_ffn(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg)
    x = _x((3, 5, 64), seed=2)
    want = np.asarray(JM.moe_ffn_dense_oracle(jp, jnp.asarray(x), jcfg))
    got = TM.moe_ffn_dense_oracle(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(TM.moe_ffn(tp, torch.from_numpy(x),
                                          tcfg).numpy(), want, **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_dense_oracle_with_the_dropped_pairs_masked_is_moe_ffn(arch):
    """``keep``: the oracle without the pairs moe_ffn drops at cf 0.05 (the
    check chip_smoke.py makes at qwen2-moe's widths on the card)."""
    _, tcfg = _configs(arch, capacity_factor=0.05)
    _, tp = _params(_configs(arch)[0])
    x = torch.from_numpy(_x((64, 64), seed=4))
    keep = torch.from_numpy(~_dropped(TM, tp, x, tcfg)).reshape(64, -1)
    assert not keep.all()
    torch.testing.assert_close(TM.moe_ffn_dense_oracle(tp, x, tcfg, keep),
                               TM.moe_ffn(tp, x, tcfg), **TOL)


@pytest.mark.parametrize("cf", [4.0, 0.05])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_gradients_match_jax(arch, cf):
    """d(sum of the output times a fixed cotangent) with respect to x and
    every leaf, within 1e-5 times the larger of 1 and each one's largest
    magnitude.  (At top-1 the router's gradient is rounding noise in both
    packages: its one gate is renormalised to exactly 1.)"""
    jcfg, tcfg = _configs(arch, capacity_factor=cf)
    jp, tp = _params(jcfg)
    x = _x((2, 9, 64), seed=5)
    ct = _x((2, 9, 64), seed=6)
    jgx, jgp = jax.grad(lambda xx, pp: jnp.sum(
        JM.moe_ffn(pp, xx, jcfg) * ct), argnums=(0, 1))(jnp.asarray(x), jp)
    xt = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.requires_grad_() for k, v in tp.items()
              if isinstance(v, torch.Tensor)}
    shared = {k: v.requires_grad_() for k, v in tp.get("shared", {}).items()}
    (TM.moe_ffn(tp, xt, tcfg) * torch.from_numpy(ct)).sum().backward()
    pairs = [(xt.grad, jgx)] + [(v.grad, jgp[k]) for k, v in leaves.items()]
    pairs += [(v.grad, jgp["shared"][k]) for k, v in shared.items()]
    for got, want in pairs:
        want = np.asarray(want)
        assert got is not None and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1))


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_shapes_and_dtypes_match_jax(arch):
    """In a bf16 model the router and the shared gate stay f32, as the JAX
    init keeps them; every other leaf takes the model dtype."""
    jcfg, tcfg = _configs(arch, dtype="bfloat16")
    want = jax.eval_shape(lambda: JM.moe_init(jax.random.key(0), jcfg,
                                              jnp.bfloat16))
    got = TM.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == sum(len(v) if isinstance(v, dict) else 1
                            for v in got.values())
    for path, leaf in flat:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
    assert got["router"].dtype == got["shared_gate"].dtype == torch.float32
    again = TM.moe_init(torch.Generator().manual_seed(0), tcfg,
                        torch.bfloat16)
    assert torch.equal(got["wo"], again["wo"])
    # one expert's slice at a time, each with the stack's fan-in
    std = 1 / np.sqrt(tcfg.n_experts * tcfg.d_model)
    assert float(got["wg"].float().std()) == pytest.approx(std, rel=0.1)


def test_gates_renormalized_and_drops_graceful():
    """Twins of tests/test_moe.py: gates sum to one; at cf 0.05 the
    dropped pairs pass through as 0 and the output stays finite."""
    jcfg, tcfg = _configs(MOE[0], capacity_factor=0.05)
    _, tp = _params(jcfg)
    _, gates = TM.route(tp, torch.from_numpy(_x((16, 64), seed=2)), tcfg)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-5)
    out = TM.moe_ffn(tp, torch.from_numpy(_x((4, 8, 64))), tcfg)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("arch", MOE)
def test_dispatch_is_a_fixed_number_of_operations(arch):
    """One scatter, three batched products and one gather a call, however
    many experts: no loop over experts."""
    counts = {}

    class Count(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", str(func))
            counts[name] = counts.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    for e in (4, 60):
        jcfg, tcfg = _configs(arch, n_experts=e)
        _, tp = _params(jcfg)
        counts.clear()
        with Count():
            TM.moe_ffn(tp, torch.from_numpy(_x((2, 8, 64))), tcfg)
        assert counts.get("bmm") == 3, counts
        assert counts.get("index_copy") == 1, counts
        assert counts.get("index_select") == 1, counts


def test_moe_ffn_runs_on_meta_tensors():
    """``cache_batch_axes`` probes prefill on the model's meta twin: the
    dispatch must need no data (no sync, no data-dependent shape)."""
    jcfg, tcfg = _configs(MOE[1])
    _, tp = _params(jcfg)
    meta = jax.tree.map(lambda t: t.to("meta"), tp)
    out = TM.moe_ffn(meta, torch.empty((3, 5, 64), device="meta"), tcfg)
    assert out.shape == (3, 5, 64) and out.device.type == "meta"
