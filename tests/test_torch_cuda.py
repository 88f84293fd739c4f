"""The port on the card: each CUDA kernel against its plain PyTorch
version, the dataframe path on logical ranks of ``cuda:0``, and the serving
engines' tokens against the port's oracle (dense and SSM families).

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  This file imports neither JAX nor the JAX package, so it runs on a
machine that has only the port's dependencies:

    python -m pytest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.dataframe import reference as R
from repro_torch.kernels.bitonic_sort import ops as bs
from repro_torch.kernels.bitonic_sort.ref import sort_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.radix_partition.ops import (
    MAX_BUCKETS, radix_partition, radix_partition_plain,
)
from repro_torch.kernels.radix_partition.ref import destinations_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops

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


# the sweep of tests/test_kernels.py plus the smallest and a ragged length
ATTN_SWEEP = [(1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 130, 8, 8, 32),
              (2, 384, 6, 3, 128), (1, 1, 4, 2, 16), (1, 17, 8, 2, 128)]


@pytest.mark.parametrize("b,s,h,kh,hd", ATTN_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, s, h, kh, hd, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(),
                               fa.flash_attention_plain(q, k, v).float(),
                               atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        # the plain version in f32 leaves only the kernel's own roundings
        torch.testing.assert_close(
            out.float(), fa.flash_attention_plain(q.float(), k.float(),
                                                  v.float()),
            atol=4e-3, rtol=2e-2)


# every head dim the kernel takes, batch 2, lengths that end inside, on and
# past a 128-row tile, GQA groups 1 and 4
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 129, 300, 2048])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_attention_bf16_kernel_across_head_dims(cuda, hd, s, group):
    gen = torch.Generator(device=cuda).manual_seed(hd * s + group)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).bfloat16()
               for shape in ((2, s, 4, hd), (2, s, 4 // group, hd),
                             (2, s, 4 // group, hd)))
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(),
                               fa.flash_attention_plain(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(
        out.float(), fa.flash_attention_plain(q.float(), k.float(),
                                              v.float()),
        atol=4e-3, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_non_causal_and_strided(cuda, dtype):
    """Other kv lengths without the mask; q read through its strides (a
    head-sliced view) and k/v as slices of a wider head dim.  The f32
    kernel takes rows at any alignment; the bf16 kernel copies rows with
    TMA, which needs 16-byte aligned rows, so a row stride of 68 elements
    raises."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 70, 8, 64, generator=gen, device=cuda).to(dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    widths = (72,) if dtype == torch.bfloat16 else (68, 72)
    for width in widths:
        k, v = (torch.randn(2, 150, 2, width, generator=gen, device=cuda)
                .to(dtype)[..., :64] for _ in range(2))
        for qq in (q[:, :, ::2], q[:, :, :4]):
            out = fa.flash_attention(qq, k, v, causal=False)
            torch.testing.assert_close(
                out.float(), fa.flash_attention_plain(qq, k, v,
                                                      causal=False).float(),
                atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        k = torch.zeros(2, 150, 2, 68, dtype=dtype, device=cuda)[..., :64]
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention(q, k, k, causal=False)


def test_flash_attention_kernel_raises_not_falls_back(cuda):
    q = torch.zeros(1, 8, 4, 48, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 16, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 9, 4, 16, device=cuda),
                           torch.zeros(1, 9, 4, 16, device=cuda))


def test_f32_token_check_at_reduced_widths(cuda):
    """Prefill through the kernel plus plain decode, in the continuous
    engine, against a full forward through the kernel per token (the
    port's greedy_reference).  TF32 stays off: the products are full f32."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import ContinuousEngine, greedy_reference
    from repro_torch.serve_lm import make_requests
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(reduced(get_config("qwen3-8b")), n_layers=2)
    params = get_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    reqs = make_requests(cfg, [30, 7, 19], [6, 6, 6])
    before = fa.flash_attention.launches
    out = ContinuousEngine(cfg, params, max_batch=2, max_seq=64).run(reqs)
    assert fa.flash_attention.launches - before == 2 * len(reqs)
    for r in reqs:
        np.testing.assert_array_equal(
            out[r.uid], greedy_reference(cfg, params, r.prompt,
                                         r.max_new_tokens))


def test_serve_lm_on_the_card(cuda):
    from repro_torch import serve_lm
    before = fa.flash_attention.launches, radix_partition.launches
    serve_lm.main(["--device", str(cuda)])
    assert fa.flash_attention.launches > before[0]
    assert radix_partition.launches > before[1]


# the sweep of tests/test_kernels.py plus ragged S and D
SSM_SWEEP = [(1, 64, 32, 8), (2, 128, 64, 16), (1, 96, 48, 4),
             (1, 77, 100, 16), (2, 300, 40, 5)]
SSM_MIXES = {"f32": (torch.float32,) * 4,
             # dt, x, Bm, Cm as the model gives them
             "model": (torch.float32, torch.bfloat16, torch.bfloat16,
                       torch.bfloat16),
             "other": (torch.bfloat16, torch.float32, torch.float32,
                       torch.bfloat16)}


def _ssm_inputs(cuda, b, s, d, n, mix, seed=0):
    """dt = softplus(normal), A < 0, and Bm, Cm as column slices of one
    (B, S, 7 + 2N) tensor, as the model's x_db gives them."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    t_dt, t_x, t_b, t_c = SSM_MIXES[mix]
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, d, generator=gen, device=cuda)).to(t_dt)
    A = -torch.exp(0.3 * torch.randn(d, n, generator=gen, device=cuda))
    x_db = torch.randn(b, s, 7 + 2 * n, generator=gen, device=cuda)
    _, bm, cm = x_db.split([7, n, n], dim=-1)
    x = torch.randn(b, s, d, generator=gen, device=cuda).to(t_x)
    return dt, A, bm.to(t_b), cm.to(t_c), x


@pytest.mark.parametrize("b,s,d,n", SSM_SWEEP)
@pytest.mark.parametrize("mix", sorted(SSM_MIXES))
def test_ssm_scan_kernel_matches_plain(cuda, b, s, d, n, mix):
    """y and the final state at the f32 tolerance of tests/test_kernels.py:
    both sides compute in f32 from the same values, whatever their
    dtypes."""
    args = _ssm_inputs(cuda, b, s, d, n, mix, seed=s)
    before = ssm_ops.ssm_scan.launches
    y, h = ssm_ops.ssm_scan(*args, return_state=True)
    torch.cuda.synchronize()
    assert ssm_ops.ssm_scan.launches == before + 1
    assert y.shape == (b, s, d) and h.shape == (b, d, n)
    yp, hp = ssm_ops.ssm_scan_plain(*args, return_state=True)
    torch.testing.assert_close(y, yp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ssm_ops.ssm_scan(*args), y, atol=0, rtol=0)


def test_ssm_scan_kernel_at_the_serving_width(cuda):
    """(1, 2048, 8192, 16), the longest prefill of falcon-mamba-7b."""
    args = _ssm_inputs(cuda, 1, 2048, 8192, 16, "model")
    y, h = ssm_ops.ssm_scan(*args, return_state=True)
    yp, hp = ssm_ops.ssm_scan_plain(*args, return_state=True)
    torch.testing.assert_close(y, yp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hp, atol=1e-5, rtol=1e-5)


def test_ssm_scan_kernel_raises_not_falls_back(cuda):
    dt, A, bm, cm, x = _ssm_inputs(cuda, 1, 8, 16, 4, "f32")
    with pytest.raises(ValueError):
        ssm_ops.ssm_scan(dt.half(), A, bm, cm, x)
    with pytest.raises(ValueError):
        ssm_ops.ssm_scan(dt, torch.zeros(16, ssm_ops.MAX_STATE + 1,
                                         device=cuda), bm, cm, x)
    with pytest.raises(ValueError):
        ssm_ops.ssm_scan(dt, A, bm.cpu(), cm, x)


def test_ssm_f32_token_check_at_reduced_widths(cuda, monkeypatch):
    """falcon-mamba at reduced widths in f32: prefill through the kernel
    plus plain decode, in the continuous engine, against a full forward
    through the kernel per token.  TF32 off: the conv goes through cuDNN."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import ContinuousEngine, greedy_reference
    from repro_torch.serve_lm import make_requests
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(reduced(get_config("falcon-mamba-7b")),
                              n_layers=2)
    params = get_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    reqs = make_requests(cfg, [30, 2, 19], [6, 6, 6])
    before = ssm_ops.ssm_scan.launches
    out = ContinuousEngine(cfg, params, max_batch=2, max_seq=64).run(reqs)
    assert ssm_ops.ssm_scan.launches - before == 2 * len(reqs)
    for r in reqs:
        np.testing.assert_array_equal(
            out[r.uid], greedy_reference(cfg, params, r.prompt,
                                         r.max_new_tokens))


def test_serve_lm_serves_falcon_mamba_on_the_card(cuda):
    from repro_torch import serve_lm
    before = ssm_ops.ssm_scan.launches, radix_partition.launches
    serve_lm.main(["--device", str(cuda), "--arch", "falcon-mamba-7b"])
    assert ssm_ops.ssm_scan.launches > before[0]
    assert radix_partition.launches > before[1]


# the JAX sweep (tests/test_kernels.py), then rows that end inside, on and
# past one CTA's chunk, a row of 2^20 keys, 64 rows, and the main shape of
# benchmarks/bench_kernels.py
SORT_SWEEP = [(1, 64), (4, 100), (2, 256), (3, 17), (1, bs.CHUNK - 1),
              (1, bs.CHUNK), (2, bs.CHUNK + 1), (1, 1 << 20), (64, 1000),
              (4, 1 << 18)]


def _sort_keys(cuda, rows, n, dtype, kind, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if kind == "ties":
        k = torch.randint(-3, 3, (rows, n), generator=gen, device=cuda)
    elif dtype == torch.int32:
        k = torch.randint(0, 1 << 30, (rows, n), generator=gen, device=cuda)
    else:
        k = torch.randn(rows, n, generator=gen, device=cuda)
    k = k.to(dtype)
    if kind == "edges":       # signed zeros, NaN, the dtype's extremes
        lo, hi = ((torch.iinfo if dtype == torch.int32 else torch.finfo)(
            dtype).min, (torch.iinfo if dtype == torch.int32 else
                         torch.finfo)(dtype).max)
        special = [lo, hi, 0, hi]
        if dtype == torch.float32:
            special += [-0.0, float("nan"), float("inf"), -float("inf")]
        pick = torch.randint(0, len(special), (rows, n), generator=gen,
                             device=cuda)
        where = torch.rand(rows, n, generator=gen, device=cuda) < 0.3
        k = torch.where(where, torch.tensor(special, dtype=dtype,
                                            device=cuda)[pick], k)
    return k


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("rows,n", SORT_SWEEP)
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("kind", ["random", "ties", "edges"])
def test_bitonic_sort_kernel_matches_plain_bit_for_bit(cuda, rows, n, dtype,
                                                       kind):
    keys = _sort_keys(cuda, rows, n, dtype, kind, seed=n)
    before = bs.bitonic_sort.launches
    ks, ps = bs.bitonic_sort(keys)
    torch.cuda.synchronize()
    assert bs.bitonic_sort.launches == before + 1
    kp, pp = bs.bitonic_sort_plain(keys)
    assert torch.equal(_bits(ks), _bits(kp)) and torch.equal(ps, pp)
    if kind != "edges":       # NaN leaves a row unsorted, as in the reference
        kr, _ = sort_ref(keys, pp)
        assert torch.equal(ks, kr)
        assert torch.equal(torch.take_along_dim(keys, ps.long(), -1), kr)


def test_bitonic_sort_kernel_takes_a_payload(cuda):
    keys = _sort_keys(cuda, 3, 5000, torch.float32, "random")
    payload = torch.randint(-9, 9, (3, 5000), dtype=torch.int32, device=cuda)
    ks, ps = bs.bitonic_sort(keys, payload)
    kp, pp = bs.bitonic_sort_plain(keys, payload)
    assert torch.equal(ks, kp) and torch.equal(ps, pp)


def test_bitonic_sort_kernel_raises_not_falls_back(cuda):
    for dtype in (torch.int64, torch.float64, torch.bfloat16):
        with pytest.raises(ValueError, match="int32 or float32"):
            bs.bitonic_sort(torch.zeros(2, 8, dtype=dtype, device=cuda))
    with pytest.raises(ValueError):
        bs.bitonic_sort(torch.zeros(2, 8, device=cuda),
                        torch.zeros(2, 8, dtype=torch.int32))
    before = bs.bitonic_sort.launches
    for shape in ((0, 5), (3, 0), (2, 1)):       # nothing to sort
        ks, ps = bs.bitonic_sort(torch.ones(shape, device=cuda))
        assert ks.shape == ps.shape == shape
    assert bs.bitonic_sort.launches == before
