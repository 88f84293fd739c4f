"""The port's kernels against the JAX package's: radix_partition,
flash_attention and ssm_scan.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them.
radix_partition's outputs are integers and are compared bit-exact;
flash_attention's and ssm_scan's at the tolerances of
``tests/test_kernels.py``.  The CUDA kernels themselves run only on the
card: ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.kernels.radix_partition.ops import radix_partition as jax_radix
from repro.kernels.radix_partition.ref import (
    destinations_ref as jax_destinations_ref,
)
from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.radix_partition.ops import (
    MAX_BUCKETS, radix_partition, radix_partition_plain,
)
from repro_torch.kernels.radix_partition.ref import destinations_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref as ssm_ref


def _buckets(n, n_buckets, seed):
    return np.random.default_rng(seed).integers(0, n_buckets, n,
                                                dtype=np.int32)


def _port(b, n_buckets):
    dest, hist = radix_partition(torch.from_numpy(b), n_buckets)
    assert dest.dtype == hist.dtype == torch.int32
    return dest.numpy(), hist.numpy()


def _jax_ref(b, n_buckets):
    d, h = jax_destinations_ref(jnp.asarray(b), n_buckets)
    return np.asarray(d), np.asarray(h)


@pytest.mark.parametrize("n,buckets,block", [
    (256, 4, 64), (1000, 16, 256), (64, 8, 64), (513, 7, 128)])
def test_radix_partition_sweep_matches_jax(n, buckets, block):
    b = _buckets(n, buckets, 3)
    dest, hist = _port(b, buckets)
    dref, href = _jax_ref(b, buckets)
    np.testing.assert_array_equal(hist, href)
    np.testing.assert_array_equal(dest, dref)
    assert sorted(dest.tolist()) == list(range(n))
    if n <= 64:   # the sweep case tests/test_kernels.py runs in tier-1
        jd, jh = jax_radix(jnp.asarray(b), buckets, block=block,
                           interpret=True)
        np.testing.assert_array_equal(dest, np.asarray(jd))
        np.testing.assert_array_equal(hist, np.asarray(jh))


def test_radix_partition_is_stable_like_jax():
    b = np.asarray([1, 0, 1, 0, 1], np.int32)
    d, _ = _port(b, 2)
    assert d[1] < d[3]
    assert d[0] < d[2] < d[4]
    jd, _ = jax_radix(jnp.asarray(b), 2, block=64, interpret=True)
    np.testing.assert_array_equal(d, np.asarray(jd))


@pytest.mark.parametrize("n", [1, 5, 64, 100, 129])
def test_radix_partition_single_bucket_is_identity(n):
    b = np.zeros(n, np.int32)
    d, h = _port(b, 1)
    np.testing.assert_array_equal(d, np.arange(n))
    np.testing.assert_array_equal(h, [n])
    jd, jh = jax_radix(jnp.asarray(b), 1, block=64, interpret=True)
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_array_equal(h, np.asarray(jh))


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=1, max_value=600),
       st.integers(min_value=1, max_value=9),
       st.sampled_from([16, 64, 128, 256]),
       st.integers(min_value=0, max_value=2**31 - 1))
def test_radix_partition_matches_jax_property(n, buckets, block, seed):
    """Same strategy as the JAX property test: the port's dest/hist equal
    the JAX oracle bit-for-bit for arbitrary sizes and bucket counts."""
    b = _buckets(n, buckets, seed)
    dest, hist = _port(b, buckets)
    dref, href = _jax_ref(b, buckets)
    np.testing.assert_array_equal(hist, href)
    np.testing.assert_array_equal(dest, dref)


@pytest.mark.parametrize("n,buckets", [(1, 2), (300, 5), (4097, 65)])
def test_torch_ref_matches_jax_ref(n, buckets):
    b = _buckets(n, buckets, n)
    d, h = destinations_ref(torch.from_numpy(b), buckets)
    dref, href = _jax_ref(b, buckets)
    np.testing.assert_array_equal(d.numpy(), dref)
    np.testing.assert_array_equal(h.numpy(), href)


def test_plain_version_is_what_the_cpu_path_runs():
    b = _buckets(777, 6, 1)
    t = torch.from_numpy(b)
    before = radix_partition.launches
    d1, h1 = radix_partition(t, 6)
    d2, h2 = radix_partition_plain(t, 6)
    assert torch.equal(d1, d2) and torch.equal(h1, h2)
    assert radix_partition.launches == before     # no kernel on the CPU


@pytest.mark.parametrize("bad,n_buckets,err", [
    (torch.zeros(4, dtype=torch.int64), 2, ValueError),
    (torch.zeros((2, 2), dtype=torch.int32), 2, ValueError),
    (torch.zeros(8, dtype=torch.int32)[::2], 2, ValueError),
    (torch.zeros(4, dtype=torch.int32), MAX_BUCKETS + 1, ValueError),
    (torch.zeros(4, dtype=torch.int32), 0, ValueError),
    (np.zeros(4, np.int32), 2, TypeError),
    (torch.zeros(4, dtype=torch.int32, device="meta"), 2, ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, n_buckets, err):
    with pytest.raises(err):
        radix_partition(bad, n_buckets)


def test_plain_version_rejects_out_of_range_buckets():
    with pytest.raises(ValueError):
        radix_partition_plain(torch.tensor([0, 3], dtype=torch.int32), 3)



def test_kernel_build_names_a_missing_nvcc(monkeypatch, tmp_path):
    """Without nvcc on PATH or under $CUDA_HOME the build says so."""
    from repro_torch.kernels import _nvcc
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _nvcc.nvcc_path()


def test_kernel_build_takes_its_constants_from_the_wrapper(monkeypatch,
                                                           tmp_path):
    """nvcc gets TILE and MAX_BUCKETS from ops.py as -D flags (the source
    defines neither), and the entry point's signature is set once."""
    import subprocess
    import types
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.radix_partition import ops
    cmds = []

    def fake_nvcc(cmd, **_):
        cmds.append(cmd)
        (tmp_path / cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_nvcc, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_nvcc.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_nvcc.ctypes, "CDLL", lambda _: types.SimpleNamespace(
        radix_partition_launch=types.SimpleNamespace()))
    monkeypatch.setattr(_nvcc, "_loaded", {})
    monkeypatch.setattr(_nvcc, "build_log", {})
    monkeypatch.setattr(ops, "_entry", None)
    fn = ops.load()
    assert ops.load() is fn and len(cmds) == 1
    assert f"-DTILE={ops.TILE}" in cmds[0]
    assert f"-DMAX_BUCKETS={ops.MAX_BUCKETS}" in cmds[0]
    assert len(fn.argtypes) == 8
    src = ops._SOURCE.read_text()
    assert "#define TILE" not in src and "#define MAX_BUCKETS" not in src


# ---------------------------------------------------------------------------
# flash_attention: the port's plain version (what a CPU tensor runs) against
# the JAX kernel in interpret mode and the JAX oracle
# ---------------------------------------------------------------------------


def _attn_inputs(b, s, h, kh, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd))]


def _jax_oracle(q, k, v, dtype):
    """The JAX attention_ref, under jax.jit (one compile per shape where
    eager JAX compiles each of its ops per shape)."""
    q, k, v = (jnp.moveaxis(jnp.asarray(x, dtype), 2, 1) for x in (q, k, v))
    ref = jax.jit(jax_attn_ref, static_argnames="causal")(q, k, v,
                                                         causal=True)
    return np.asarray(jnp.moveaxis(ref, 1, 2), np.float32)


def _port_attn(fn, q, k, v, dtype):
    out = fn(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
             causal=True)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


def test_flash_attention_matches_jax_kernel_and_oracle():
    """(b,s,h,kh,hd) = (1,128,4,4,32) f32, the case tests/test_kernels.py
    runs in tier-1, at its tolerance."""
    q, k, v = _attn_inputs(1, 128, 4, 4, 32, np.float32)
    got = _port_attn(fa.flash_attention, q, k, v, torch.float32)
    kern = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, q_block=128,
                                kv_block=128, interpret=True))
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, _jax_oracle(q, k, v, jnp.float32),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,s,h,kh,hd", [
    (2, 256, 8, 2, 64),      # GQA 4x
    (1, 130, 8, 8, 32),      # unaligned seq
    (2, 384, 6, 3, 128),     # large head_dim
    (1, 17, 4, 1, 16),       # ragged, smallest head_dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep_matches_jax_oracle(b, s, h, kh, hd, dtype):
    q, k, v = _attn_inputs(b, s, h, kh, hd, dtype, seed=s)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    got = _port_attn(fa.flash_attention_plain, q, k, v,
                     getattr(torch, dtype))
    np.testing.assert_allclose(got, _jax_oracle(q, k, v, getattr(jnp, dtype)),
                               atol=tol, rtol=tol)


def test_flash_attention_cpu_path_is_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in
               _attn_inputs(1, 40, 4, 2, 16, np.float32))
    before = fa.flash_attention.launches
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention_plain(q, k, v))
    assert fa.flash_attention.launches == before     # no kernel on the CPU


@pytest.mark.parametrize("q_shape,kv_shape,dtype,causal", [
    ((1, 8, 4, 48), (1, 8, 4, 48), torch.float32, True),    # head_dim 48
    ((1, 8, 4, 256), (1, 8, 4, 256), torch.float32, True),  # above the max
    ((1, 8, 4, 16), (1, 12, 4, 16), torch.float32, True),   # causal Sq != Sk
    ((1, 8, 4, 16), (1, 8, 3, 16), torch.float32, False),   # 4 % 3 heads
    ((1, 8, 4, 16), (1, 8, 4, 16), torch.float16, True),    # dtype
    ((8, 4, 16), (8, 4, 16), torch.float32, True),          # 3-D
])
def test_flash_attention_rejects_what_the_kernel_does_not_take(
        q_shape, kv_shape, dtype, causal):
    q = torch.zeros(q_shape, dtype=dtype)
    kv = torch.zeros(kv_shape, dtype=dtype)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv, causal=causal)
    with pytest.raises(ValueError):
        fa.flash_attention_plain(q, kv, kv, causal=causal)


def test_flash_attention_rejects_mixed_inputs_and_other_devices():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        fa.flash_attention(*(torch.zeros(1, 8, 4, 16, device="meta"),) * 3)
    with pytest.raises(ValueError):      # head dim not contiguous
        fa.flash_attention(q, q, torch.zeros(1, 8, 16, 4).transpose(2, 3))
    with pytest.raises(TypeError):
        fa.flash_attention(np.zeros((1, 8, 4, 16)), q, q)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16)[..., :64],  # stride
    lambda: torch.zeros(1 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)[1:]
    .view(1, 8, 2, 64),                                               # pointer
])
def test_flash_attention_rejects_unaligned_bf16_rows(make):
    """The bf16 kernel copies rows 16 bytes a thread; f32 takes any rows."""
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    kv = make()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, kv, kv)
    assert fa.flash_attention(q.float(), kv.float(), kv.float()).shape == \
        q.shape
    f32 = torch.zeros(1, 8, 2, 68)[..., :64]
    assert fa.flash_attention(q.float(), f32, f32).shape == q.shape


def test_flash_attention_non_causal_takes_other_lengths():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 5, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 12, 2, 16))
                             .astype(np.float32)) for _ in range(2))
    want = jax_attn_ref(*(jnp.moveaxis(jnp.asarray(x.numpy()), 2, 1)
                          for x in (q, k, v)), causal=False)
    np.testing.assert_allclose(
        fa.flash_attention(q, k, v, causal=False).numpy(),
        np.asarray(jnp.moveaxis(want, 1, 2)), atol=2e-5, rtol=2e-5)


def test_flash_attention_build_takes_its_constants_from_the_wrapper(
        monkeypatch, tmp_path):
    """nvcc gets the tile sizes and the largest head dim from ops.py as -D
    flags (the source defines none of them), and the entry point's
    signature is set once."""
    import subprocess
    import types
    from repro_torch.kernels import _nvcc
    cmds = []

    def fake_nvcc(cmd, **_):
        cmds.append(cmd)
        (tmp_path / cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_nvcc, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_nvcc.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_nvcc.ctypes, "CDLL", lambda _: types.SimpleNamespace(
        flash_attention_launch=types.SimpleNamespace()))
    monkeypatch.setattr(_nvcc, "_loaded", {})
    monkeypatch.setattr(_nvcc, "build_log", {})
    monkeypatch.setattr(fa, "_entry", None)
    fn = fa.load()
    assert fa.load() is fn and len(cmds) == 1
    for name in ("BLOCK_Q", "BLOCK_K", "MAX_HEAD_DIM"):
        assert f"-D{name}={getattr(fa, name)}" in cmds[0]
        assert f"#define {name}" not in fa._SOURCE.read_text()
    assert len(fn.argtypes) == 15


# ---------------------------------------------------------------------------
# ssm_scan: the port's plain version (what a CPU tensor runs) against the
# JAX kernel in interpret mode, the JAX oracle, and the JAX chunked scan's
# final state
# ---------------------------------------------------------------------------
SSM_TOL = dict(atol=1e-5, rtol=1e-5)       # tests/test_kernels.py, f32


def _ssm_inputs(b, s, d, n, seed=0, dtypes=("float32",) * 4):
    """dt (softplus of a normal, as the JAX test draws it), A < 0, Bm, Cm,
    x as numpy f32; each of dt, Bm, Cm, x rounded to ``dtypes``' entry
    (float32 or bfloat16) so both packages see the same values."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d))))
    A = -np.exp(rng.standard_normal((d, n)) * 0.3)
    Bm, Cm, x = (rng.standard_normal(shape) for shape in
                 ((b, s, n), (b, s, n), (b, s, d)))
    out = {"A": torch.from_numpy(A.astype(np.float32))}
    for name, arr, dtype in zip(("dt", "Bm", "Cm", "x"), (dt, Bm, Cm, x),
                                dtypes, strict=True):
        out[name] = torch.from_numpy(arr.astype(np.float32)).to(
            getattr(torch, dtype))
    return out


def _ssm_args(t):
    return t["dt"], t["A"], t["Bm"], t["Cm"], t["x"]


def _jax_ssm(t):
    return [jnp.asarray(a.float().numpy()) for a in _ssm_args(t)]


@pytest.mark.parametrize("b,s,d,n,dblk,chunk", [
    (1, 64, 32, 8, 16, 16), (2, 128, 64, 16, 32, 64), (1, 96, 48, 4, 48, 32)])
def test_ssm_scan_sweep_matches_jax(b, s, d, n, dblk, chunk):
    """The JAX sweep shapes, f32, at its tolerance.  The JAX kernel runs in
    interpret mode on the case tests/test_kernels.py runs in tier-1; every
    case is held to the JAX oracle."""
    t = _ssm_inputs(b, s, d, n, seed=s)
    got = ssm_ops.ssm_scan(*_ssm_args(t))
    assert got.dtype == torch.float32 and got.shape == (b, s, d)
    jargs = _jax_ssm(t)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax.jit(jax_ssm_ref)(*jargs)), **SSM_TOL)
    if s <= 64:
        kern = jax_ssm_scan(*jargs, d_block=dblk, chunk=chunk, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(kern), **SSM_TOL)


@pytest.mark.parametrize("b,s,d,n", [(1, 77, 100, 16), (2, 300, 40, 5),
                                     (1, 1, 3, 1)])
@pytest.mark.parametrize("dtypes", [
    ("float32",) * 4,
    ("float32", "bfloat16", "bfloat16", "bfloat16"),   # the model's mix
    ("bfloat16", "float32", "bfloat16", "float32"),
])
def test_ssm_scan_ragged_and_mixed_dtypes_match_jax(b, s, d, n, dtypes):
    """S and D that are no chunk or block multiple, and each input in its
    own dtype: both sides compute in f32 from the same values."""
    t = _ssm_inputs(b, s, d, n, seed=d, dtypes=dtypes)
    got, h = ssm_ops.ssm_scan(*_ssm_args(t), return_state=True)
    jargs = _jax_ssm(t)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax.jit(jax_ssm_ref)(*jargs)), **SSM_TOL)
    assert h.dtype == torch.float32 and h.shape == (b, d, n)


@pytest.mark.parametrize("b,s,d,n,chunk", [(2, 40, 24, 8, 8), (1, 77, 16, 16,
                                                               32)])
def test_ssm_scan_final_state_matches_jax_chunked_scan(b, s, d, n, chunk):
    """The state after the last step equals the h_final of the JAX
    package's chunked associative scan (what the JAX prefill hands to
    decode) over the materialised decay and input."""
    from repro.models.ssm import _assoc_scan_chunked
    t = _ssm_inputs(b, s, d, n, seed=5)
    _, h = ssm_ops.ssm_scan(*_ssm_args(t), return_state=True)
    dt, A, Bm, _, x = _jax_ssm(t)
    a = jnp.exp(dt[..., None] * A)
    bb = (dt * x)[..., None] * Bm[:, :, None, :]
    _, h_final = jax.jit(_assoc_scan_chunked, static_argnums=3)(
        a, bb, jnp.zeros((b, d, n), jnp.float32), chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_final), **SSM_TOL)


def test_ssm_torch_ref_matches_jax_ref():
    t = _ssm_inputs(2, 33, 20, 6, seed=9)
    np.testing.assert_allclose(
        ssm_ref(*_ssm_args(t)).numpy(),
        np.asarray(jax.jit(jax_ssm_ref)(*_jax_ssm(t))), **SSM_TOL)


def test_ssm_scan_cpu_path_is_the_plain_version():
    t = _ssm_inputs(1, 20, 12, 4, seed=2)
    before = ssm_ops.ssm_scan.launches
    y, h = ssm_ops.ssm_scan(*_ssm_args(t), return_state=True)
    yp, hp = ssm_ops.ssm_scan_plain(*_ssm_args(t), return_state=True)
    assert torch.equal(y, yp) and torch.equal(h, hp)
    assert torch.equal(ssm_ops.ssm_scan(*_ssm_args(t)), yp)
    assert ssm_ops.ssm_scan.launches == before       # no kernel on the CPU


def test_ssm_scan_reads_strided_column_slices():
    """Bm and Cm as column slices of one (B,S,E) tensor, as the model's
    x_db gives them."""
    t = _ssm_inputs(2, 30, 16, 8, seed=4)
    x_db = torch.cat([torch.zeros(2, 30, 5), t["Bm"], t["Cm"]], dim=-1)
    _, bm, cm = x_db.split([5, 8, 8], dim=-1)
    assert not bm.is_contiguous()
    args = (t["dt"], t["A"], bm, cm, t["x"])
    assert torch.equal(ssm_ops.ssm_scan(*args),
                       ssm_ops.ssm_scan(*_ssm_args(t)))


def test_ssm_scan_meta_in_meta_out_without_a_launch():
    """The serving engines probe prefill on the meta device: the wrapper
    returns meta results of the right shapes and launches nothing."""
    t = {k: v.to("meta") for k, v in _ssm_inputs(2, 5, 12, 8).items()}
    before = ssm_ops.ssm_scan.launches
    y, h = ssm_ops.ssm_scan(*_ssm_args(t), return_state=True)
    assert y.device.type == h.device.type == "meta"
    assert y.shape == (2, 5, 12) and h.shape == (2, 12, 8)
    assert y.dtype == h.dtype == torch.float32
    assert ssm_ops.ssm_scan(*_ssm_args(t)).shape == (2, 5, 12)
    assert ssm_ops.ssm_scan.launches == before


def _bad_ssm(name, value):
    t = _ssm_inputs(1, 8, 6, 4)
    t[name] = value(t[name])
    return _ssm_args(t)


@pytest.mark.parametrize("args,err", [
    (_bad_ssm("dt", lambda a: a.half()), ValueError),            # dtype
    (_bad_ssm("x", lambda a: a[0]), ValueError),                 # 2-D x
    (_bad_ssm("A", lambda a: a[None]), ValueError),              # 3-D A
    (_bad_ssm("Bm", lambda a: a[:, :4]), ValueError),            # S differs
    (_bad_ssm("A", lambda a: torch.zeros(6, ssm_ops.MAX_STATE + 1)),
     ValueError),                                                # N too big
    (_bad_ssm("x", lambda a: torch.zeros(1, 6, 8).transpose(1, 2)),
     ValueError),                                                # strided
    (_bad_ssm("Cm", lambda a: a.to("meta")), ValueError),        # devices
    (_bad_ssm("dt", lambda a: a.numpy()), TypeError),
])
def test_ssm_scan_rejects_what_the_kernel_does_not_take(args, err):
    with pytest.raises(err):
        ssm_ops.ssm_scan(*args)
    with pytest.raises(err):
        ssm_ops.ssm_scan_plain(*args)


def test_ssm_scan_build_takes_its_constants_from_the_wrapper(monkeypatch,
                                                             tmp_path):
    """nvcc gets the block shape, the largest state size, the chunk and the
    step group from ops.py as -D flags (the source defines none of them), and the entry
    point's signature is set once."""
    import subprocess
    import types
    from repro_torch.kernels import _nvcc
    cmds = []

    def fake_nvcc(cmd, **_):
        cmds.append(cmd)
        (tmp_path / cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_nvcc, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_nvcc.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_nvcc.ctypes, "CDLL", lambda _: types.SimpleNamespace(
        ssm_scan_launch=types.SimpleNamespace()))
    monkeypatch.setattr(_nvcc, "_loaded", {})
    monkeypatch.setattr(_nvcc, "build_log", {})
    monkeypatch.setattr(ssm_ops, "_entry", None)
    fn = ssm_ops.load()
    assert ssm_ops.load() is fn and len(cmds) == 1
    for name in ("THREADS", "LANES", "MAX_STATE", "CHUNK", "GROUP"):
        assert f"-D{name}={getattr(ssm_ops, name)}" in cmds[0]
        assert f"#define {name}" not in ssm_ops._SOURCE.read_text()
    assert len(fn.argtypes) == 14
