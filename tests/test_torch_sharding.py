"""The port's sharding rules, mesh context and gradient compression against
the JAX package's, on the CPU.

``param_specs`` on every arch, full and reduced, over shape-only meshes
(the JAX tests' ``FakeMesh``; the port's ``MeshShape``) and four
``ParallelConfig``s; ``batch_specs`` and ``cache_specs`` likewise, the
latter with ``tests/test_sharding_rules.py``'s zamba2 (1, 524288) and
qwen3 (128, 32768) cases; ``_filter`` and ``constrain``; int8 block
quantisation and the compressed mean over 4 logical CPU ranks against
the JAX function under ``jax.vmap(axis_name="data")``.  Specs, quantised
values, scales and compressed means are compared exactly: the JAX side
runs op by op (under ``jax.jit`` XLA rewrites the division by 127 as a
multiplication, and the scales move by an ulp).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st

from repro.configs import ParallelConfig as JParallel
from repro.configs import get_config as jget
from repro.configs import list_archs
from repro.configs import reduced as jreduced
from repro.distributed import compression as jcomp
from repro.distributed import context as jctx
from repro.distributed import sharding as jsh
from repro.models import registry as jreg

from repro_torch.configs import ParallelConfig, get_config, reduced
from repro_torch.core import logical_devices
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import context as tctx
from repro_torch.distributed import sharding as tsh
from repro_torch.models import registry as treg

MESHES = [((16, 16), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((8, 1), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
PARALLEL = [{}, {"fsdp": False}, {"tensor_parallel": False},
            {"fsdp_axes": ("pod", "data")}]


class FakeMesh:
    """Shape-only mesh stand-in for the JAX rules (``test_sharding_rules``)."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _meshes():
    return [(FakeMesh(shape, names), tsh.MeshShape(names, shape))
            for shape, names in MESHES]


def _jax_flat(tree, prefix=()):
    """A JAX tree of specs or ShapeDtypeStructs as "/"-path -> leaf."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch, small):
    jcfg = jreduced(jget(arch)) if small else jget(arch)
    tcfg = reduced(get_config(arch)) if small else get_config(arch)
    return (jcfg, tcfg, jreg.eval_params_shape(jcfg),
            treg.eval_params_shape(tcfg))


@pytest.mark.parametrize("small", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_jax(arch, small):
    """Every leaf's spec, on every mesh and ParallelConfig: the same tree
    of shapes in the JAX layout, the same spec at every path."""
    jcfg, tcfg, jshape, tshape = _shapes(arch, small)
    jflat, tflat = _jax_flat(jshape), tsh.flat_paths(tshape)
    assert {k: tuple(v.shape) for k, v in jflat.items()} == \
        {k: tuple(v.shape) for k, v in tflat.items()}
    for jm, tm in _meshes():
        for kw in PARALLEL:
            want = {k: tuple(v) for k, v in _jax_flat(jsh.param_specs(
                jshape, jm, JParallel(**kw), jcfg)).items()}
            got = tsh.flat_paths(tsh.param_specs(tshape, tm,
                                                 ParallelConfig(**kw), tcfg))
            assert got == want, (tm, kw)
            assert tsh.opt_specs(None, got)["count"] == ()


def test_reduced_moe_stacked_layer_axis_takes_the_expert_rule():
    """The reduced qwen2-moe has 4 layers and 4 experts: the stacked
    ``shared`` MLP (4, 64, 128) matches the expert rule, so ``model``
    splits its layer axis, in both packages."""
    jcfg, tcfg, jshape, tshape = _shapes("qwen2-moe-a2.7b", True)
    jm, tm = FakeMesh((2, 2), ("data", "model")), \
        tsh.MeshShape(("data", "model"), (2, 2))
    got = tsh.param_specs(tshape, tm, ParallelConfig(), tcfg)
    want = jsh.param_specs(jshape, jm, JParallel(), jcfg)
    for name in ("wg", "wi", "wo"):
        assert tuple(tshape["blocks"]["moe"]["shared"][name].shape)[0] == 4
        assert got["blocks"]["moe"]["shared"][name][0] == "model"
        assert got["blocks"]["moe"]["shared"][name] == \
            tuple(want["blocks"]["moe"]["shared"][name])


@pytest.mark.parametrize("arch", list_archs())
def test_batch_specs_match_jax(arch):
    jcfg, tcfg = jget(arch), get_config(arch)
    for b in (1, 2, 3, 8, 32, 256):
        jshapes = jreg.train_batch_shapes(jcfg, b, 64)
        tshapes = treg.train_batch_shapes(tcfg, b, 64)
        for jm, tm in _meshes():
            for kw in PARALLEL + [{"dp_axes": ("data",)}]:
                want = {k: tuple(v) for k, v in jsh.batch_specs(
                    jshapes, jm, JParallel(**kw)).items()}
                assert tsh.batch_specs(tshapes, tm,
                                       ParallelConfig(**kw)) == want


CACHE_CASES = [(1, 64), (2, 128), (8, 96), (128, 32768)]


@pytest.mark.parametrize("small", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_jax(arch, small):
    jcfg, tcfg, _, _ = _shapes(arch, small)
    cases = CACHE_CASES + ([(1, 524288)] if arch == "zamba2-7b" else [])
    for b, smax in cases:
        jc = jreg.eval_cache_shape(jcfg, b, smax)
        tc = treg.eval_cache_shape(tcfg, b, smax)
        assert {k: tuple(v.shape) for k, v in _jax_flat(jc).items()} == \
            {k: tuple(v.shape) for k, v in tsh.flat_paths(tc).items()}
        for jm, tm in _meshes():
            for kw in PARALLEL:
                want = {k: tuple(v) for k, v in _jax_flat(jsh.cache_specs(
                    jcfg, jc, jm, JParallel(**kw))).items()}
                got = tsh.flat_paths(tsh.cache_specs(tcfg, tc, tm,
                                                     ParallelConfig(**kw)))
                assert got == want, (b, smax, tm, kw)


def test_cache_specs_named_cases():
    """``test_sharding_rules.py``'s two cache cases, held in the port."""
    mesh = tsh.MeshShape(("data", "model"), (16, 16))
    cfg = get_config("zamba2-7b")
    k = tsh.cache_specs(cfg, treg.eval_cache_shape(cfg, 1, 524288), mesh,
                        ParallelConfig())["k"]
    assert k[-3] is not None and k[-2] == "model" and k[-4] is None
    cfg = get_config("qwen3-8b")
    k = tsh.cache_specs(cfg, treg.eval_cache_shape(cfg, 128, 32768), mesh,
                        ParallelConfig())["k"]
    assert k[-4] == "data" and k[-3] == "model" and k[-2] is None


ENTRIES = [None, "data", "model", "pod", "nope", ("data", "model"),
           ("pod", "data"), ("model", "data"), ("pod", "nope", "model")]
SIZES = [{}, {"data": 4}, {"data": 2, "model": 3},
         {"pod": 2, "data": 16, "model": 16}, {"data": 1, "model": 8}]


def test_filter_matches_jax():
    for entry in ENTRIES:
        for sizes in SIZES:
            for dim in (1, 2, 3, 6, 12, 16, 48, 512, 1000):
                assert tctx._filter(entry, sizes, dim) == \
                    jctx._filter(entry, sizes, dim), (entry, sizes, dim)


def test_constrain_matches_jax(monkeypatch):
    """The spec each package's ``constrain`` applies (the JAX one's handed
    to ``with_sharding_constraint``, caught here), under every context;
    the port's returns ``x`` itself."""
    seen = []
    monkeypatch.setattr(jctx.jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    specs = [("data", None, "model"), (("pod", "data"), "model", None),
             (None, None, None), ("model", "data")]
    for sizes in SIZES:
        for shape in ((8, 6, 16), (3, 16, 12), (32, 1, 48)):
            for spec in specs:
                x = torch.zeros(shape)
                seen.clear()
                with jctx.axes_ctx(sizes):
                    jctx.constrain(jnp.zeros(shape), *spec)
                with tctx.axes_ctx(sizes):
                    assert tctx.constrain(x, *spec) is x
                    got = tctx.constrained_spec(x, *spec)
                assert ([got] if got is not None else []) == seen
    with pytest.raises(ValueError):
        with tctx.axes_ctx({"data": 2}):
            tctx.constrain(torch.zeros(4), "data", None)


def test_axes_ctx_nests_and_is_thread_local():
    import threading
    mesh = tsh.MeshShape(("data", "model"), (2, 2))
    assert tctx.current_mesh() is None and tctx.current_axes() == {}
    with tctx.axes_ctx(mesh, "shardmap", ("data",)):
        assert tctx.current_mesh() is mesh
        assert tctx.current_axes() == {"data": 2, "model": 2}
        assert (tctx.current_moe_impl(), tctx.current_dp()) == \
            ("shardmap", ("data",))
        with tctx.axes_ctx({"data": 8}):
            assert tctx.current_mesh() is None
            assert tctx.current_axes() == {"data": 8}
            assert tctx.current_moe_impl() == "gspmd"
        assert tctx.current_mesh() is mesh
        other = []
        t = threading.Thread(target=lambda: other.append(
            (tctx.current_mesh(), tctx.current_axes())))
        t.start()
        t.join()
        assert other == [(None, {})]
    assert tctx.current_mesh() is None and tctx.current_dp() == \
        ("pod", "data")


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(st.integers(1, 2000), st.integers(0, 10_000), st.booleans())
def test_quantize_int8_bit_equal_to_jax(n, seed, zero_block):
    x = np.random.default_rng(seed).normal(size=(n,)).astype(np.float32) * 3
    if zero_block:
        x[:256] = 0          # an all-zero block: the scale floor
    jq, js, jm = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts, tm = tcomp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tm == (tuple(jm[0]), jm[1])
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(tq, ts, tm).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, jm)))


def test_quantize_keeps_the_shape_and_bounds_the_error():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 5, 37)).astype(np.float32))
    q, s, meta = tcomp.quantize_int8(x)
    assert q.dtype == torch.int8 and q.shape == (3, 256) and s.shape == (3,)
    back = tcomp.dequantize_int8(q, s, meta)
    assert back.shape == x.shape
    bound = s.repeat_interleave(256)[:x.numel()] / 2 + 1e-6
    assert bool(((back - x).abs().reshape(-1) <= bound).all())


@pytest.mark.parametrize("n", [5000, 4096, 7])
def test_compressed_psum_mean_bit_equal_to_jax_vmap(n):
    """Three calls with error feedback over 4 logical CPU ranks: means and
    errors bit-equal to the JAX function under ``jax.vmap`` with a named
    axis, each rank's mean the same, and within the JAX test's 0.02 of the
    exact mean."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(4, n)).astype(np.float32) * 3
    x[1, :min(n, 256)] = 0
    step = jax.vmap(lambda xl, e: jcomp.compressed_psum_mean(
        xl, "data", error=e), axis_name="data")
    devices = logical_devices(4, "cpu")
    je, te = jnp.zeros_like(x), None
    for it in range(3):
        xi = x * (it + 1) + it
        jm, je = step(jnp.asarray(xi), je)
        tm, te = tcomp.compressed_psum_mean(
            [torch.from_numpy(r) for r in xi], devices, te)
        for r in range(4):
            np.testing.assert_array_equal(tm[r].numpy(), np.asarray(jm[r]))
            np.testing.assert_array_equal(te[r].numpy(), np.asarray(je[r]))
            assert torch.equal(tm[r], tm[0])
        want = xi.mean(0)
        assert np.abs(tm[0].numpy() - want).max() < \
            0.02 * np.abs(want).max()


def test_tree_compressed_psum_mean_threads_errors():
    rng = np.random.default_rng(1)
    devices = logical_devices(2, "cpu")
    trees = [{"a": torch.from_numpy(rng.normal(size=(300,)).astype(
        np.float32)), "b": {"c": torch.from_numpy(rng.normal(
            size=(4, 70)).astype(np.float32))}} for _ in range(2)]
    means, errs = tcomp.tree_compressed_psum_mean(trees, devices)
    m2, e2 = tcomp.tree_compressed_psum_mean(trees, devices, errs)
    for path in (("a",), ("b", "c")):
        def leaf(t):
            for k in path:
                t = t[k]
            return t
        m, e = tcomp.compressed_psum_mean([leaf(t) for t in trees], devices)
        assert torch.equal(leaf(means[1]), m[1])
        assert torch.equal(leaf(errs[0]), e[0])
        m, _ = tcomp.compressed_psum_mean([leaf(t) for t in trees], devices,
                                          e)
        assert torch.equal(leaf(m2[0]), m[0])
    assert tcomp.wire_bytes(torch.zeros(300)) == 2 * 256 * 2 + 2 * 4
