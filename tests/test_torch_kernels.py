"""The port's kernels against the JAX package's: radix_partition,
flash_attention, ssm_scan and bitonic_sort.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them.
radix_partition's and bitonic_sort's outputs (payloads included) are
compared bit-exact; flash_attention's and ssm_scan's at the tolerances of
``tests/test_kernels.py``.  The CUDA kernels themselves run only on the
card: ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st

from repro.kernels.bitonic_sort.ops import bitonic_sort as jax_bitonic
from repro.kernels.bitonic_sort.ref import sort_ref as jax_sort_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.kernels.radix_partition.ops import radix_partition as jax_radix
from repro.kernels.radix_partition.ref import (
    destinations_ref as jax_destinations_ref,
)
from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_ref
from repro_torch.kernels.bitonic_sort import ops as bs
from repro_torch.kernels.bitonic_sort.ref import sort_ref as torch_sort_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.radix_partition.ops import (
    MAX_BUCKETS, SMALL_BUCKETS, TILE, radix_partition, radix_partition_plain,
)
from repro_torch.kernels.radix_partition.ref import destinations_ref
from repro_torch.kernels.ssm_scan import accuracy as ssm_accuracy
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


def _radix_inputs(n, n_buckets, dist, seed=0):
    """uniform ids, the same sorted (long runs), or 90 % of the rows in one
    hot bucket, as the card's tests and ``ab radix_partition`` draw them."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, n_buckets, n, dtype=np.int32)
    if dist == "sorted":
        return np.sort(b)
    if dist == "hot":
        return np.where(rng.random(n) < 0.9, n_buckets // 2, b).astype(
            np.int32)
    return b


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 2 * TILE + 3])
@pytest.mark.parametrize("buckets,dist", [
    (SMALL_BUCKETS, "uniform"), (SMALL_BUCKETS + 1, "sorted"), (5, "hot")])
def test_radix_partition_at_tile_boundaries_matches_jax_kernel(n, buckets,
                                                               dist):
    """The wrapper at the kernel's tile edges and on both sides of its
    register/shared-memory boundary against the JAX kernel in interpret
    mode (whose blocks do not line up with the tiles)."""
    b = _radix_inputs(n, buckets, dist, seed=n)
    dest, hist = _port(b, buckets)
    jd, jh = jax_radix(jnp.asarray(b), buckets, block=1024, interpret=True)
    np.testing.assert_array_equal(dest, np.asarray(jd))
    np.testing.assert_array_equal(hist, np.asarray(jh))


def test_radix_partition_reads_an_unaligned_view_like_jax():
    """A view one row into its storage (the card's kernel reads it from a
    4-byte offset) gives what the JAX kernel gives for the same rows."""
    base = torch.from_numpy(_radix_inputs(TILE + 6, 7, "uniform", seed=9))
    view = base[1:TILE + 2]
    assert view.is_contiguous() and view.storage_offset() == 1
    d, h = radix_partition(view, 7)
    jd, jh = jax_radix(jnp.asarray(view.numpy()), 7, block=1024,
                       interpret=True)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


def test_radix_partition_scratch_covers_every_tile():
    """The scratch holds two words per (tile, bucket) for the tiles of n
    rows starting up to 3 rows past a 16-byte boundary, then B sums and the
    ticket (the look-back's layout; the per-chunk counts of up to
    SMALL_BUCKETS buckets need at most B words a tile)."""
    from repro_torch.kernels.radix_partition.ops import scratch_words
    for n, b in ((1, 2), (TILE - 3, 5), (TILE - 2, 5), (35_000_000, 1024)):
        tiles = -(-(n + 3) // TILE)
        assert scratch_words(n, b) == 2 * b * tiles + b + 1
    assert -(-(TILE - 2 + 3) // TILE) == 2      # a shifted view adds a tile


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
    # a meta tensor takes the plain version, behind the same checks
    (torch.zeros(4, dtype=torch.int16, device="meta"), 2, ValueError),
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
    """nvcc gets TILE, THREADS, SMALL_BUCKETS and MAX_BUCKETS from ops.py as
    -D flags (the source defines none of them), and the entry point's
    signature (buckets, dest, hist, scratch, n, B, stream) is set once."""
    import ctypes
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
    for name in ("TILE", "THREADS", "SMALL_BUCKETS", "MAX_BUCKETS"):
        assert f"-D{name}={getattr(ops, name)}" in cmds[0]
    assert fn.argtypes == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    src = ops._SOURCE.read_text()
    for name in ("TILE", "THREADS", "SMALL_BUCKETS", "MAX_BUCKETS"):
        assert f"#define {name}" not in src


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


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_head_dim_112_matches_jax_kernel_and_oracle(
        causal):
    """zamba2-7b's shared attention (hd 112, which the card runs on the
    hd-128 tiles) at (b,s,h,kh) = (1,128,4,4) f32, causal and not: the
    port's CPU path against the JAX kernel in interpret mode (its blocks
    span the whole of hd) and the JAX oracle, at the f32 tolerance."""
    q, k, v = _attn_inputs(1, 128, 4, 4, 112, np.float32, seed=112)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal).numpy()
    kern = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, q_block=64,
                                kv_block=64, interpret=True))
    ref = jax.jit(jax_attn_ref, static_argnames="causal")(
        *(jnp.moveaxis(jnp.asarray(x), 2, 1) for x in (q, k, v)),
        causal=causal)
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jnp.moveaxis(ref, 1, 2)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,s,h,kh,hd", [
    (2, 256, 8, 2, 64),      # GQA 4x
    (1, 130, 8, 8, 32),      # unaligned seq
    (2, 384, 6, 3, 128),     # large head_dim
    (1, 17, 4, 1, 16),       # ragged, smallest head_dim
    (1, 129, 4, 2, 112),     # zamba2's head_dim, past a 128-row tile
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
    with pytest.raises(ValueError):      # q and k on meta, v on the CPU
        fa.flash_attention(*(torch.zeros(1, 8, 4, 16, device="meta"),) * 2,
                           q)
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
    """nvcc gets the tile sizes, the kv ring's depth and the largest head
    dim from ops.py as -D flags (the source defines none of them), and the
    entry point's signature is set once."""
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
    for name in ("BLOCK_Q", "BLOCK_K", "WG_BLOCK_Q", "WG_BLOCK_K",
                 "KV_STAGES", "MAX_HEAD_DIM"):
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
    """nvcc gets the block shape, the lanes a channel, each build's largest
    state size and the chunk from ops.py as -D flags (the source defines
    none of them); each build is made once, with its entry point's
    signature set, and a state size takes the first build large enough for
    it."""
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
    monkeypatch.setattr(ssm_ops, "_entries", {})
    fn = ssm_ops.load()
    assert ssm_ops.load(16) is fn and len(cmds) == 1
    assert ssm_ops.load(17) is not fn and ssm_ops.load(64) is ssm_ops.load(33)
    assert len(cmds) == len(ssm_ops.BUILDS) == 2
    for cmd, max_state in zip(cmds, ssm_ops.BUILDS, strict=True):
        assert f"-DMAX_STATE={max_state}" in cmd
        for name in ("THREADS", "LANES", "CHUNK"):
            assert f"-D{name}={getattr(ssm_ops, name)}" in cmd
    for name in ("THREADS", "LANES", "MAX_STATE", "CHUNK"):
        assert f"#define {name}" not in ssm_ops._SOURCE.read_text()
    # 9 pointers, B, S, D, N, the state's mode, the stream
    assert len(fn.argtypes) == 15
    assert ssm_ops.build_for(16) == ssm_ops.BUILDS[0]
    assert ssm_ops.build_for(17) == ssm_ops.build_for(64) == ssm_ops.BUILDS[1]
    for n in (0, ssm_ops.MAX_STATE + 1):
        with pytest.raises(ValueError):
            ssm_ops.build_for(n)


@pytest.mark.parametrize("b,s,d,n", [
    (1, 64, 32, 8), (2, 128, 64, 16), (1, 96, 48, 4),        # the JAX sweep
    (1, 77, 100, 16), (2, 300, 40, 5), (1, 1, 3, 1),          # ragged
    (1, 17, 70, 12), (2, 40, 20, 33), (1, 33, 24, 64)])       # N up to 64
def test_ssm_scan_kernel_order_matches_jax_ref(b, s, d, n):
    """The kernel's layout and summation order, replayed on the CPU
    (``ops.kernel_order``: states split over a channel's lanes, y summed
    through the transpose-reduce, lane l holding step t + l), equals the
    port's oracle and the JAX oracle at the f32 tolerance, y and final
    state, for every build a state size can take."""
    t = _ssm_inputs(b, s, d, n, seed=s + n)
    yr, hr = ssm_ref(*_ssm_args(t), return_state=True)
    yj = np.asarray(jax.jit(jax_ssm_ref)(*_jax_ssm(t)))
    builds = [(m, ssm_ops.LANES) for m in ssm_ops.BUILDS if n <= m]
    builds += [(builds[0][0], lanes) for lanes in (4, 16)
               if builds[0][0] % lanes == 0 and lanes != ssm_ops.LANES]
    for max_state, lanes in builds:
        y, h = ssm_ops.kernel_order(*_ssm_args(t), max_state=max_state,
                                    lanes=lanes)
        assert y.shape == (b, s, d) and h.shape == (b, d, n)
        np.testing.assert_allclose(y.numpy(), yr.numpy(), **SSM_TOL)
        np.testing.assert_allclose(y.numpy(), yj, **SSM_TOL)
        np.testing.assert_allclose(h.numpy(), hr.numpy(), **SSM_TOL)


@pytest.mark.parametrize("kind", ssm_accuracy.KINDS)
@pytest.mark.parametrize("b,s,d,n", [(1, 64, 32, 8), (2, 77, 40, 64)])
def test_ssm_scan_float64_witness_matches_the_oracles(kind, b, s, d, n):
    """The checks' inputs and their float64 witness on the CPU: the inputs
    have the kernel's shapes and dtypes, Bm and Cm column slices of one
    x_db (a Mamba2 layer's: of one xbc_conv, with x, each head's dt and A
    repeated over its channels); the float64 scan agrees with the port's
    oracle and the JAX oracle at the f32 tolerance; and the oracle holds
    the bound that the check at zamba2's width puts on the kernel
    (``held_to_f64``)."""
    gen = torch.Generator().manual_seed(s)
    args = ssm_accuracy.inputs(b, s, d, n, ssm_accuracy.MODEL_MIX, kind,
                               gen=gen, dt_rank=7, head_dim=8)
    dt, A, bm, cm, x = args
    assert [t.dtype for t in (dt, x, bm, cm)] == \
        list(ssm_accuracy.MODEL_MIX)
    assert A.shape == (d, n) and bm.shape == cm.shape == (b, s, n)
    assert bm.stride(1) == cm.stride(1) == \
        (d if kind == "mamba2" else 7) + 2 * n
    if kind == "long":
        assert torch.equal(A[0], -torch.arange(1.0, n + 1))
    if kind == "mamba2":
        assert torch.equal(dt.view(b, s, d // 8, 8),
                           dt[..., ::8, None].expand(b, s, d // 8, 8))
        assert torch.equal(A, A[::8].repeat_interleave(8, dim=0))
        assert torch.equal(A, A[:, :1].expand(d, n))
        assert x.stride(1) == d + 2 * n
    y64, h64, size = ssm_accuracy.scan_f64(*args)
    assert y64.dtype == torch.float64 and size.shape == y64.shape
    assert bool((size >= y64.abs()).all())
    plain = ssm_ref(*args, return_state=True)
    np.testing.assert_allclose(y64.numpy(), plain[0].numpy(), **SSM_TOL)
    np.testing.assert_allclose(h64.numpy(), plain[1].numpy(), **SSM_TOL)
    yj = jax.jit(jax_ssm_ref)(*(jnp.asarray(t.float().numpy())
                                for t in args))
    np.testing.assert_allclose(y64.numpy(), np.asarray(yj), **SSM_TOL)
    assert ssm_accuracy.held_to_f64(plain, (y64, h64, size)) <= 1
    assert ssm_accuracy.over_bound(plain[0], y64) <= 1
    assert ssm_accuracy.parse_shape(f"{b},{s},{d},{n},f32,long") == \
        (b, s, d, n, ssm_accuracy.F32_MIX, "long")


@pytest.mark.parametrize("module,argv", [
    ("repro_torch.kernels.ab", ["bitonic_sort", "--other-define",
                                "REG_BITS=5"]),
    ("repro_torch.kernels.bitonic_sort.op_costs", []),
    ("repro_torch.kernels.ab", ["ssm_scan"]),
    ("repro_torch.kernels.ab", ["radix_partition", "--shape",
                                "4097,5,hot"]),
    ("repro_torch.kernels.ab", ["radix_partition", "--probe",
                                "--other-define", "TILE=2048"]),
    ("repro_torch.kernels.ssm_scan.accuracy", ["--shape", "1,64,32,8"]),
])
def test_bitonic_sort_measurement_scripts_need_a_card(module, argv):
    """The timing scripts refuse to run without CUDA (no CPU number is ever
    reported as a device's)."""
    import importlib
    with pytest.raises(SystemExit, match="no CUDA device"):
        importlib.import_module(module).main(argv)


def test_flash_attention_ab_needs_a_card():
    """The old-against-new timing script refuses to run without CUDA."""
    from repro_torch.kernels import ab
    with pytest.raises(SystemExit, match="no CUDA device"):
        ab.main(["flash_attention", "--other-source", str(fa._SOURCE),
                 "--other-define", "KV_STAGES=3"])


# ---------------------------------------------------------------------------
# bitonic_sort: the port's plain version (what a CPU tensor runs) runs the
# JAX kernel's network stage by stage, so keys and payloads equal the JAX
# kernel's in interpret mode bit for bit
# ---------------------------------------------------------------------------
def _sort_keys(rows, n, dtype, seed=0):
    """Keys as tests/test_kernels.py draws them (ints in [-500, 500), normal
    floats), from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-500, 500, (rows, n)).astype(np.int32)
    return rng.standard_normal((rows, n)).astype(np.float32)


def _jax_sort(keys, payload=None):
    ks, ps = jax_bitonic(jnp.asarray(keys), None if payload is None
                         else jnp.asarray(payload), interpret=True)
    return np.asarray(ks), np.asarray(ps)


def _same_bits(a, b):
    """Equal as stored: NaN equals NaN and -0.0 differs from +0.0."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("rows,n", [(1, 16), (3, 17), (1, 64), (4, 100),
                                    (2, 256)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_bitonic_sort_plain_equals_jax_kernel_bit_for_bit(rows, n, dtype):
    keys = _sort_keys(rows, n, dtype, seed=n)
    ks, ps = bs.bitonic_sort_plain(torch.from_numpy(keys))
    assert ks.dtype == getattr(torch, dtype) and ps.dtype == torch.int32
    jk, jp = _jax_sort(keys)
    assert _same_bits(ks.numpy(), jk) and _same_bits(ps.numpy(), jp)
    # keys equal both oracles; the payload regathers them
    kr, _ = jax_sort_ref(jnp.asarray(keys), jnp.asarray(jp))
    tr, _ = torch_sort_ref(torch.from_numpy(keys), ps)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(kr))
    np.testing.assert_array_equal(ks.numpy(), tr.numpy())
    np.testing.assert_array_equal(
        np.take_along_axis(keys, ps.numpy(), -1), ks.numpy())


def test_bitonic_sort_plain_carries_a_payload_like_jax():
    keys = _sort_keys(3, 40, "float32", seed=4)
    payload = np.random.default_rng(5).integers(
        -9, 9, (3, 40)).astype(np.int32)
    ks, ps = bs.bitonic_sort_plain(torch.from_numpy(keys),
                                   torch.from_numpy(payload))
    jk, jp = _jax_sort(keys, payload)
    assert _same_bits(ks.numpy(), jk) and _same_bits(ps.numpy(), jp)


# The CUDA kernel runs the network in passes of ops that ops.plan encodes.
# _plan_model executes those ops as the kernel does (a thread's registers in
# its window, lanes, moves through shared memory, each op's direction rule),
# so the schedule and its encoding are checked here against the plain
# version; the kernel itself runs only on the card.
_PATTERN = [sum(1 << r for r in range(32) if r >> b & 1) for b in range(5)]


def _deposit(vals, bits):
    out = np.zeros(np.shape(vals), np.int64)
    for i, b in enumerate(bits):
        out |= ((vals >> i) & 1).astype(np.int64) << b
    return out


def _plan_model(keys, payload=None):
    rows, n = keys.shape
    m = bs._next_pow2(n)
    log_m, total = m.bit_length() - 1, rows * m
    e, threads = 1 << bs.REG_BITS, bs.THREADS
    t, r = np.arange(threads)[:, None], np.arange(e)[None, :]
    big = (np.iinfo if keys.dtype.kind == "i" else np.finfo)(keys.dtype).max
    flat_k, flat_p = np.empty(total, keys.dtype), np.empty(total, np.int32)

    def local(w):        # (thread, register) -> local index in window w
        return (t & ((1 << w) - 1)) | (r << w) | ((t >> w) << (w + bs.REG_BITS))
    for i, (owned, w, ops) in enumerate(bs.plan(log_m)):
        ctas = -(-total // bs.CHUNK)
        base = _deposit(np.arange(ctas), [b for b in range(63)
                                          if b not in owned])

        def flat(w):
            return base[:, None, None] + _deposit(local(w), owned)[None]
        f = flat(w)
        if i == 0:         # the caller's keys, the pad, arange(n)
            row, idx = f >> log_m, f & (m - 1)
            inb = (f < total) & (idx < n)
            ri, ii = np.where(inb, row, 0), np.where(inb, idx, 0)
            k = np.where(inb, keys[ri, ii], big).astype(keys.dtype)
            p = np.where(inb, ii if payload is None else payload[ri, ii],
                         -1).astype(np.int32)
        else:
            k, p = flat_k[f], flat_p[f]
        for op in ops:
            kind, arg = op & 3, (op >> 2) & 15
            dkind, darg = (op >> 6) & 3, (op >> 8) & 63
            count = ((op >> 14) & 7) + 1
            if kind == bs.OP_RELAYOUT or op & bs.MOVE_FIRST:
                sk = np.empty((ctas, bs.CHUNK), k.dtype)
                sp = np.empty((ctas, bs.CHUNK), np.int32)
                sk[:, local(w)], sp[:, local(w)] = k, p
                w = arg if kind == bs.OP_RELAYOUT else (op >> 18) & 15
                k, p = sk[:, local(w)], sp[:, local(w)]
                if kind == bs.OP_RELAYOUT:
                    continue
            if dkind == bs.DIR_ASC:
                mask = np.zeros((1, 1, 1), np.int64)
            elif dkind == bs.DIR_REG:
                mask = np.full((1, 1, 1), _PATTERN[darg])
            elif dkind == bs.DIR_THREAD:
                mask = -((t[None] >> darg) & 1)
            else:          # DIR_CTA
                mask = -((base[:, None, None] >> darg) & 1)
            desc = ((mask >> r[None]) & 1).astype(bool)
            if kind == bs.OP_REG:     # a run of strides arg, arg - 1, ..
                for q in range(arg, arg - count, -1):
                    lo = np.asarray([x for x in range(e) if not x >> q & 1])
                    hi = lo | (1 << q)
                    a, b = k[..., lo], k[..., hi]
                    pa, pb = p[..., lo], p[..., hi]
                    keep = np.where(desc[..., lo], a >= b, a <= b)
                    k, p = k.copy(), p.copy()
                    k[..., lo], k[..., hi] = np.where(keep, a, b), \
                        np.where(keep, b, a)
                    p[..., lo], p[..., hi] = np.where(keep, pa, pb), \
                        np.where(keep, pb, pa)
            else:          # OP_SHFL: the partner lane's element
                for lb in range(arg, arg - count, -1):
                    partner = np.arange(threads) ^ (1 << lb)
                    pk, pp = k[:, partner], p[:, partner]
                    high = ((t >> lb) & 1).astype(bool)[None]
                    a, b = np.where(high, pk, k), np.where(high, k, pk)
                    keep = np.where(desc, a >= b, a <= b)
                    k, p = np.where(keep, k, pk), np.where(keep, p, pp)
        f = flat(w)
        flat_k[f[f < total]], flat_p[f[f < total]] = k[f < total], \
            p[f < total]
    return flat_k.reshape(rows, m)[:, :n], flat_p.reshape(rows, m)[:, :n]


@pytest.mark.parametrize("rows,n", [(1, 2), (3, 17), (2, 1000), (1, 8192),
                                    (2, 8193), (1, 1 << 16), (1, 1 << 18)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_bitonic_sort_kernel_plan_equals_plain_bit_for_bit(rows, n, dtype):
    """Ties, NaN, signed zeros and the pad's value among the keys; one case
    in four carries a payload."""
    rng = np.random.default_rng(n)
    if dtype == "int32":
        keys = rng.integers(-5, 5, (rows, n)).astype(np.int32)
        keys[rng.random((rows, n)) < 0.05] = np.iinfo(np.int32).max
    else:
        keys = rng.standard_normal((rows, n)).astype(np.float32)
        u = rng.random((rows, n))
        keys[u < 0.05], keys[(u >= 0.05) & (u < 0.1)] = np.nan, -0.0
        keys[(u >= 0.1) & (u < 0.15)] = 0.0
    payload = (rng.integers(-9, 9, (rows, n)).astype(np.int32)
               if n % 4 == 1 else None)
    km, pm = _plan_model(keys, payload)
    kp, pp = bs.bitonic_sort_plain(
        torch.from_numpy(keys),
        None if payload is None else torch.from_numpy(payload))
    assert _same_bits(km, kp.numpy()) and _same_bits(pm, pp.numpy())


def test_bitonic_sort_kernel_plan_cuts_the_network_into_owned_runs():
    for log_m in range(1, 31):
        ps = bs.passes(log_m)
        assert [st for _, run in ps for st in run] == bs.network(log_m)
        for owned, run in ps:
            assert len(owned) == bs.LOG_CHUNK and owned == sorted(owned)
            assert set(range(bs.COALESCE_BITS)) <= set(owned)
            assert {j for _, j in run} <= set(owned)
        assert all(len(ops) <= bs.MAX_OPS for _, _, ops in bs.plan(log_m))
        if log_m > bs.LOG_CHUNK:    # the first pass the kernel compiles in
            assert bs.plan(log_m)[0][1:] == (bs.FIRST_W0, bs.FIRST_OPS)
    assert len(bs.passes(18)) == 8          # the benchmark's rows of 2^18


@pytest.mark.parametrize("keys,want_keys,want_payload", [
    # +inf in a padded row: the pad (finfo.max, payload -1) takes its place
    ([[np.inf, 1, 2]], [[1, 2, np.finfo(np.float32).max]], [[1, 2, -1]]),
    # a row holding NaN comes back unsorted
    ([[np.nan, 1, -0.0, 0, 3, -1, np.nan, 2]],
     [[-1, 3, 0, np.nan, 1, np.nan, -0.0, 2]], None),
])
def test_bitonic_sort_reference_edges_on_floats(keys, want_keys,
                                                want_payload):
    keys = np.asarray(keys, np.float32)
    ks, ps = bs.bitonic_sort(torch.from_numpy(keys))
    assert _same_bits(ks.numpy(), np.asarray(want_keys, np.float32))
    if want_payload is not None:
        np.testing.assert_array_equal(ps.numpy(), want_payload)
    jk, jp = _jax_sort(keys)
    assert _same_bits(ks.numpy(), jk) and _same_bits(ps.numpy(), jp)


def test_bitonic_sort_int32_max_ties_with_the_pad():
    """INT32_MAX keys tie with the pad, so the trimmed payload may hold -1
    where the pad was kept."""
    imax = np.iinfo(np.int32).max
    keys = np.asarray([[imax, imax, 1]], np.int32)     # padded to 4
    ks, ps = bs.bitonic_sort(torch.from_numpy(keys))
    np.testing.assert_array_equal(ks.numpy(), [[1, imax, imax]])
    np.testing.assert_array_equal(ps.numpy(), [[2, 0, -1]])
    jk, jp = _jax_sort(keys)
    assert _same_bits(ks.numpy(), jk) and _same_bits(ps.numpy(), jp)


@pytest.mark.parametrize("shape", [(3, 0), (2, 1), (0, 5), (0, 0)])
def test_bitonic_sort_pads_and_trims_empty_and_single_rows(shape):
    keys = torch.zeros(shape, dtype=torch.int32)
    before = bs.bitonic_sort.launches
    ks, ps = bs.bitonic_sort(keys)
    assert ks.shape == ps.shape == shape and ps.dtype == torch.int32
    assert bs.bitonic_sort.launches == before
    if shape[0]:     # the JAX kernel's grid cannot take 0 rows
        jk, jp = _jax_sort(keys.numpy())
        assert _same_bits(ks.numpy(), jk) and _same_bits(ps.numpy(), jp)
    if shape == (2, 1):
        assert ps.tolist() == [[0], [0]]     # the default payload


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.int16,
                                   torch.bfloat16, torch.uint8])
def test_bitonic_sort_plain_takes_any_real_dtype_on_the_cpu(dtype):
    keys = torch.from_numpy(_sort_keys(3, 37, "int32", seed=7) % 200 + 20)
    keys = keys.to(dtype)
    ks, ps = bs.bitonic_sort(keys)
    assert ks.dtype == dtype
    assert torch.equal(ks, torch.sort(keys, dim=-1).values)
    assert torch.equal(torch.take_along_dim(keys, ps.long(), -1), ks)


def test_bitonic_sort_cpu_path_is_the_plain_version():
    keys = torch.from_numpy(_sort_keys(2, 50, "float32", seed=2))
    before = bs.bitonic_sort.launches
    got, want = bs.bitonic_sort(keys), bs.bitonic_sort_plain(keys)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bs.bitonic_sort.launches == before     # no kernel on the CPU


def test_bitonic_sort_torch_ref_matches_jax_ref():
    keys = _sort_keys(4, 300, "int32", seed=11) // 50      # many ties
    payload = np.broadcast_to(np.arange(300, dtype=np.int32), (4, 300))
    tk, tp = torch_sort_ref(torch.from_numpy(keys),
                            torch.from_numpy(payload.copy()))
    jk, jp = jax_sort_ref(jnp.asarray(keys), jnp.asarray(payload))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("keys,payload,err", [
    (torch.zeros(2, 3, 4), None, ValueError),                   # 3-D
    (torch.zeros(2, 4, dtype=torch.bool), None, ValueError),
    (torch.zeros(2, 4, dtype=torch.complex64), None, ValueError),
    (torch.zeros(2, 4), torch.zeros(2, 4), ValueError),         # f32 payload
    (torch.zeros(2, 4), torch.zeros(2, 5, dtype=torch.int32), ValueError),
    # a meta tensor takes the plain version, behind the same checks
    (torch.zeros(2, 4, dtype=torch.bool, device="meta"), None, ValueError),
    (np.zeros((2, 4)), None, TypeError),
])
def test_bitonic_sort_rejects_what_it_does_not_take(keys, payload, err):
    with pytest.raises(err):
        bs.bitonic_sort(keys, payload)


def test_bitonic_sort_build_takes_its_constants_from_the_wrapper(
        monkeypatch, tmp_path):
    """nvcc gets the chunk, the register window and the op capacity from
    ops.py as -D flags (the source defines none of them), and the entry
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
        bitonic_sort_launch=types.SimpleNamespace()))
    monkeypatch.setattr(_nvcc, "_loaded", {})
    monkeypatch.setattr(_nvcc, "build_log", {})
    monkeypatch.setattr(bs, "_entry", None)
    fn = bs.load()
    assert bs.load() is fn and len(cmds) == 1
    for name in ("LOG_CHUNK", "REG_BITS", "MAX_OPS"):
        assert f"-D{name}={getattr(bs, name)}" in cmds[0]
        assert f"#define {name}" not in bs._SOURCE.read_text()
    assert len(fn.argtypes) == 12
