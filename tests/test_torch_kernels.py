"""The port's radix_partition against the JAX package's.

On the CPU the port's wrapper takes its plain PyTorch version; the JAX
kernel runs in interpret mode, as ``tests/test_kernels.py`` runs it.  All
outputs are integers and are compared bit-exact.  The CUDA kernel itself
runs only on the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st

from repro.kernels.radix_partition.ops import radix_partition as jax_radix
from repro.kernels.radix_partition.ref import (
    destinations_ref as jax_destinations_ref,
)
from repro_torch.kernels.radix_partition.ops import (
    MAX_BUCKETS, radix_partition, radix_partition_plain,
)
from repro_torch.kernels.radix_partition.ref import destinations_ref


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
