"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the dataframe path on logical ranks of ``cuda:0``.

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  This file imports neither JAX nor the JAX package, so it runs on a
machine that has only the port's dependencies:

    python -m pytest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.dataframe import reference as R
from repro_torch.kernels.radix_partition.ops import (
    MAX_BUCKETS, radix_partition, radix_partition_plain,
)
from repro_torch.kernels.radix_partition.ref import destinations_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1, 1000, 4097, 1 << 20])
@pytest.mark.parametrize("buckets", [2, 5, 65, MAX_BUCKETS])
def test_radix_partition_kernel_matches_plain(cuda, n, buckets):
    b = torch.from_numpy(np.random.default_rng(n).integers(
        0, buckets, n, dtype=np.int32)).to(cuda)
    before = radix_partition.launches
    d, h = radix_partition(b, buckets)
    torch.cuda.synchronize()
    assert radix_partition.launches == before + 1
    dp, hp = radix_partition_plain(b, buckets)
    assert torch.equal(d, dp) and torch.equal(h, hp)
    dr, hr = destinations_ref(b, buckets)
    assert torch.equal(d, dr) and torch.equal(h, hr)


def test_radix_partition_kernel_is_stable(cuda):
    b = torch.tensor([1, 0, 1, 0, 1], dtype=torch.int32, device=cuda)
    d, h = radix_partition(b, 2)
    assert d.tolist() == [2, 0, 3, 1, 4] and h.tolist() == [2, 3]


def test_dist_ops_on_logical_cuda_ranks(cuda):
    from repro_torch.core import build_communicator, logical_devices
    from repro_torch.dataframe import ops_dist as D
    comm = build_communicator(logical_devices(4, cuda))
    rng = np.random.default_rng(42)
    a = {"k": rng.integers(0, 300, 1200).astype(np.int32),
         "v": rng.normal(size=1200).astype(np.float32)}
    b = {"k": rng.integers(0, 300, 900).astype(np.int32),
         "w": rng.normal(size=900).astype(np.float32)}
    ta, tb = D.shard_table(comm, a, 700), D.shard_table(comm, b, 700)
    before = radix_partition.launches
    out, ovf = D.make_dist_sort(comm, "k")(ta)
    assert not bool(ovf)
    np.testing.assert_array_equal(D.collect_table(out)["k"],
                                  R.ref_sort(a, "k")["k"])
    out, ovf = D.make_dist_join(comm, "k", out_factor=8.0)(ta, tb)
    assert not bool(ovf)
    np.testing.assert_array_equal(
        R.sorted_rows(D.collect_table(out)),
        R.sorted_rows(R.ref_join_inner(a, b, "k")))
    out, ovf = D.make_dist_groupby_sum(comm, "k", ["v"])(ta)
    got = D.collect_table(out)
    ref = R.ref_groupby_sum(a, "k", ["v"])
    o = np.argsort(got["k"])
    np.testing.assert_array_equal(got["k"][o], ref["k"])
    np.testing.assert_allclose(got["v"][o], ref["v"], rtol=1e-5, atol=1e-5)
    # four ranks pack once per shuffle: 4 (sort) + 8 (join) + 4 (groupby)
    assert radix_partition.launches - before == 16


def test_etl_pipelines_on_the_card(cuda):
    from repro_torch import etl
    before = radix_partition.launches
    runs = etl.run(rows=20_000, sort_sleep=0.0, join_sleep=0.0, n_ranks=4,
                   device=cuda, timeout=300)
    for res, _ in runs.values():
        assert res[("sort", "merge")] == "merged(20000 rows over 2 ranks)"
    assert radix_partition.launches > before


def test_radix_bucket_on_the_card_verifies(cuda):
    from repro_torch.dataframe.shuffle import radix_bucket
    rng = np.random.default_rng(0)
    cols = {"key": rng.integers(0, 97, 100_000, dtype=np.int32)}
    tgt = rng.integers(0, 8, 100_000, dtype=np.int32)
    chunks, hist = radix_bucket(cols, tgt, 8, device=cuda, verify=True)
    for j, c in enumerate(chunks):
        np.testing.assert_array_equal(c["key"], cols["key"][tgt == j])
