"""The port on the card: each CUDA kernel against its plain PyTorch
version, the dataframe path on logical ranks of ``cuda:0``, the serving
engines' tokens against the port's oracle (dense, MoE, SSM, VLM and audio
families), and training on the card (the kernels' autograd Functions).

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
    MAX_BUCKETS, SMALL_BUCKETS, TILE, radix_partition, radix_partition_plain,
)
from repro_torch.kernels.radix_partition.ref import destinations_ref
from repro_torch.kernels.ssm_scan import accuracy
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


def _radix_ids(cuda, n, buckets, dist, seed=0):
    """uniform ids, the same sorted (long runs), 90 % of the rows in one hot
    bucket, or every row in one bucket."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, buckets, n, dtype=np.int32)
    if dist == "sorted":
        b = np.sort(b)
    elif dist == "hot":
        b = np.where(rng.random(n) < 0.9, buckets // 2, b).astype(np.int32)
    elif dist == "one":
        b = np.full(n, buckets - 1, np.int32)
    return torch.from_numpy(b).to(cuda)


def _radix_expected(b, buckets):
    """The plain version over the rows whose id lies in [0, buckets); the
    others get dest -1 and are not counted."""
    ok = (b >= 0) & (b < buckets)
    dest = torch.full_like(b, -1)
    d, h = radix_partition_plain(b[ok].contiguous(), buckets)
    dest[ok] = d
    return dest, h


# each strategy's edges: from B = 8 / 9 on, a warp of the small strategy
# scans more than one bucket; SMALL_BUCKETS / SMALL_BUCKETS + 1 change the
# strategy
RADIX_STRATEGY_B = [2, 3, 4, 5, 8, 9, SMALL_BUCKETS, SMALL_BUCKETS + 1, 65,
                    MAX_BUCKETS]
RADIX_EDGE_N = [3, 1001, TILE - 1, TILE, TILE + 1, 2 * TILE + 3]


@pytest.mark.parametrize("n", RADIX_EDGE_N)
@pytest.mark.parametrize("buckets", RADIX_STRATEGY_B)
@pytest.mark.parametrize("dist", ["uniform", "sorted", "hot", "one"])
def test_radix_partition_kernel_across_strategies_and_tiles(cuda, n, buckets,
                                                            dist):
    b = _radix_ids(cuda, n, buckets, dist, seed=n + buckets)
    d, h = radix_partition(b, buckets)
    dp, hp = radix_partition_plain(b, buckets)
    assert torch.equal(d, dp) and torch.equal(h, hp)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("buckets", [5, SMALL_BUCKETS + 1])
def test_radix_partition_kernel_reads_unaligned_views(cuda, offset, buckets):
    """A view 4, 8 or 12 bytes past a 16-byte boundary is read and written
    around its 16-byte body, never as if aligned; its storage is left as it
    was."""
    n = 2 * TILE + 5
    base = _radix_ids(cuda, n + 8, buckets, "uniform", seed=offset)
    keep = base.clone()
    view = base[offset:offset + n]
    assert view.data_ptr() % 16 == 4 * offset % 16
    d, h = radix_partition(view, buckets)
    dp, hp = radix_partition_plain(view, buckets)
    assert torch.equal(d, dp) and torch.equal(h, hp)
    assert torch.equal(base, keep)


@pytest.mark.parametrize("buckets", [5, SMALL_BUCKETS + 1, MAX_BUCKETS])
def test_radix_partition_kernel_leaves_out_of_range_ids(cuda, buckets):
    """Ids outside [0, B) are neither counted nor placed: dest -1."""
    n = 3 * TILE + 7
    b = _radix_ids(cuda, n, buckets, "uniform", seed=buckets)
    bad = torch.tensor([-1, buckets, buckets + 7, -2 ** 31, 2 ** 31 - 1],
                       dtype=torch.int32, device=cuda)
    rows = torch.arange(0, n, 5, device=cuda)
    b[rows] = bad[rows % len(bad)]
    d, h = radix_partition(b, buckets)
    de, he = _radix_expected(b, buckets)
    assert torch.equal(d, de) and torch.equal(h, he)
    assert int(h.sum()) == n - len(rows)


@pytest.mark.parametrize("n,buckets", [(1 << 22, 5), (1 << 21, MAX_BUCKETS)])
def test_radix_partition_kernel_repeats_bit_identical(cuda, n, buckets):
    b = _radix_ids(cuda, n, buckets, "hot", seed=n)
    first = radix_partition(b, buckets)
    again = radix_partition(b, buckets)
    assert all(torch.equal(x, y) for x, y in zip(first, again, strict=True))
    dp, hp = radix_partition_plain(b, buckets)
    assert torch.equal(first[0], dp) and torch.equal(first[1], hp)


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
# |kernel - plain| <= tol + tol * |plain| by dtype: the plain version rounds
# the scores to a 2-byte dtype as the JAX einsum does, the kernel keeps
# them in f32
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 4e-3}
# a 2-byte result against the plain version in f32 (only the kernel's own
# roundings, P and the output, are left): (atol, rtol)
ATTN_F32_TOL = {torch.bfloat16: (4e-3, 2e-2), torch.float16: (1e-3, 4e-3)}


def _holds_to_f32_plain(out, q, k, v, causal=True):
    atol, rtol = ATTN_F32_TOL[out.dtype]
    torch.testing.assert_close(
        out.float(), fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                              causal=causal),
        atol=atol, rtol=rtol)


@pytest.mark.parametrize("b,s,h,kh,hd", ATTN_SWEEP)
@pytest.mark.parametrize("dtype", list(ATTN_TOL))
def test_flash_attention_kernel_matches_plain(cuda, b, s, h, kh, hd, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(),
                               fa.flash_attention_plain(q, k, v).float(),
                               atol=tol, rtol=tol)
    if dtype != torch.float32:
        _holds_to_f32_plain(out, q, k, v)


# every head dim the kernel takes, batch 2, lengths that end inside, on and
# past a 128-row tile, GQA groups 1 and 4
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 129, 300, 2048])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_attention_f16_kernel_across_head_dims(cuda, hd, s, group):
    """The f16 mode of the tensor-core kernel, as the bf16 one below."""
    gen = torch.Generator(device=cuda).manual_seed(hd * s + group)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).half()
               for shape in ((2, s, 4, hd), (2, s, 4 // group, hd),
                             (2, s, 4 // group, hd)))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == torch.float16
    tol = ATTN_TOL[torch.float16]
    torch.testing.assert_close(out.float(),
                               fa.flash_attention_plain(q, k, v).float(),
                               atol=tol, rtol=tol)
    _holds_to_f32_plain(out, q, k, v)


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


@pytest.mark.parametrize("dtype", list(ATTN_TOL))
def test_flash_attention_kernel_non_causal_and_strided(cuda, dtype):
    """Other kv lengths without the mask; q read through its strides (a
    head-sliced view) and k/v as slices of a wider head dim.  The f32
    kernel takes rows at any alignment; the bf16 and f16 kernel copies rows
    with TMA, which needs 16-byte aligned rows, so a row stride of 68
    elements raises."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 70, 8, 64, generator=gen, device=cuda).to(dtype)
    tol = ATTN_TOL[dtype]
    widths = (68, 72) if dtype == torch.float32 else (72,)
    for width in widths:
        k, v = (torch.randn(2, 150, 2, width, generator=gen, device=cuda)
                .to(dtype)[..., :64] for _ in range(2))
        for qq in (q[:, :, ::2], q[:, :, :4]):
            out = fa.flash_attention(qq, k, v, causal=False)
            torch.testing.assert_close(
                out.float(), fa.flash_attention_plain(qq, k, v,
                                                      causal=False).float(),
                atol=tol, rtol=tol)
    if dtype != torch.float32:
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


MOE = ["qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", MOE)
def test_moe_f32_token_check_at_reduced_widths(cuda, arch):
    """The MoE family in the continuous engine (prefill through the kernel,
    one launch a layer) against the full-forward oracle, token for token;
    the reduced configs' capacity factor 4.0 drops no pair."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import ContinuousEngine, greedy_reference
    from repro_torch.serve_lm import make_requests
    cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=4)
    params = get_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    reqs = make_requests(cfg, [30, 7, 19], [6, 6, 6])
    before = fa.flash_attention.launches
    out = ContinuousEngine(cfg, params, max_batch=2, max_seq=64).run(reqs)
    assert fa.flash_attention.launches - before == cfg.n_layers * len(reqs)
    for r in reqs:
        np.testing.assert_array_equal(
            out[r.uid], greedy_reference(cfg, params, r.prompt,
                                         r.max_new_tokens))


@pytest.mark.parametrize("cf", [4.0, 0.05])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, cf):
    """moe_ffn on the card and on the CPU from the same f32 weights and
    tokens: the same pairs dropped, outputs within 1e-5 (TF32 off)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe
    cfg = dataclasses.replace(reduced(get_config(MOE[0])), n_experts=16,
                              top_k=4, capacity_factor=cf)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(300, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    on_card = {k: ({n: t.to(cuda) for n, t in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in p.items()}
    cap = moe.capacity(300, cfg)
    pos = {}
    for dev, pp in (("cpu", p), ("cuda", on_card)):
        idx, _ = moe.route(pp, x.to(dev), cfg)
        pos[dev] = moe.dispatch_indices(idx, cfg.n_experts, cap)[1].cpu()
    assert torch.equal(pos["cuda"], pos["cpu"])
    assert bool((pos["cpu"] >= cap).any()) == (cf < 1)
    torch.testing.assert_close(moe.moe_ffn(on_card, x.to(cuda), cfg).cpu(),
                               moe.moe_ffn(p, x, cfg), rtol=1e-5, atol=1e-5)


def test_moe_trainer_on_the_card(cuda):
    """The reduced qwen2-moe trains on the card through the kernel (once a
    layer a step; remat off): the loss falls and stays finite."""
    from repro_torch.configs import ParallelConfig, ShapeConfig
    from repro_torch.configs import get_config, reduced
    from repro_torch.train.data import SyntheticCorpus
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer
    cfg = reduced(get_config(MOE[0]))
    shape = ShapeConfig("t", "train", 64, 4)
    tr = Trainer(cfg, ParallelConfig(), shape,
                 OptimizerConfig(peak_lr=3e-3, warmup_steps=2,
                                 total_steps=8), device=cuda)
    before = fa.flash_attention.launches
    _, losses = tr.fit(SyntheticCorpus(cfg.vocab_size).batches(4, 64, 8), 8,
                       log_every=0)
    assert fa.flash_attention.launches == before + 8 * cfg.n_layers
    assert losses[-1] < losses[0] and all(np.isfinite(losses))


def test_serve_lm_serves_qwen2_moe_on_the_card(cuda):
    from repro_torch import serve_lm
    before = fa.flash_attention.launches
    serve_lm.main(["--device", str(cuda), "--arch", MOE[0]])
    assert fa.flash_attention.launches > before


# the sweep of tests/test_kernels.py plus ragged S and D; then N that is no
# multiple of a channel's lanes, S of 1 and of no whole chunk or group, D of
# no whole CTA, B = 2 at the serving width, and N up to 64 (the second build)
SSM_SWEEP = [(1, 64, 32, 8), (2, 128, 64, 16), (1, 96, 48, 4),
             (1, 77, 100, 16), (2, 300, 40, 5),
             (1, 300, 100, 3), (2, 17, 40, 5), (1, 1, 70, 12),
             (2, 300, 8192, 16), (1, 300, 100, 32), (2, 17, 40, 33),
             (1, 77, 100, 64), (2, 1, 70, 64)]
SSM_MIXES = {"f32": (torch.float32,) * 4,
             # dt, x, Bm, Cm as the model gives them
             "model": (torch.float32, torch.bfloat16, torch.bfloat16,
                       torch.bfloat16),
             # and as a model at dtype "float16" gives them
             "f16": accuracy.F16_MIX,
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


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("mix", sorted(SSM_MIXES))
def test_ssm_scan_kernel_holds_long_memory(cuda, n, mix):
    """Mamba's own ranges (``accuracy.inputs``, kind "long"): each
    channel's dt around a level drawn log-uniform in [0.001, 0.1] and A =
    -(1..N), so that channels remember up to a thousand steps and an error
    in a decay adds up over them."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    args = accuracy.inputs(1, 2048, 256, n, SSM_MIXES[mix], "long", gen=gen)
    y, h = ssm_ops.ssm_scan(*args, return_state=True)
    yp, hp = ssm_ops.ssm_scan_plain(*args, return_state=True)
    torch.testing.assert_close(y, yp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ssm_ops.ssm_scan(*args), y, atol=0, rtol=0)


def test_ssm_scan_kernel_at_zamba2_width_holds_to_float64(cuda):
    """zamba2-7b's scan, (1, 2048, 7168, 64) all f32, default inputs: y
    sums 64 products of |h C| up to about 40, and where they cancel two f32
    sums in different orders differ by more than 1e-5 + 1e-5 * |y|.  Held
    to the float64 scan of the same values instead: the state within 1e-5 +
    1e-5 * |exact|, y within 1e-5 + 1e-5 * sum_n |h_n C_n|; and the plain
    version holds the same bound."""
    gen = torch.Generator(device=cuda).manual_seed(64)
    args = accuracy.inputs(1, 2048, 7168, 64, SSM_MIXES["f32"], gen=gen)
    exact = accuracy.scan_f64(*args)
    assert accuracy.held_to_f64(ssm_ops.ssm_scan(*args, return_state=True),
                                exact) <= 1
    assert accuracy.held_to_f64(
        ssm_ops.ssm_scan_plain(*args, return_state=True), exact) <= 1


def test_ssm_scan_kernel_at_the_serving_width(cuda):
    """(1, 2048, 8192, 16), the longest prefill of falcon-mamba-7b."""
    args = _ssm_inputs(cuda, 1, 2048, 8192, 16, "model")
    y, h = ssm_ops.ssm_scan(*args, return_state=True)
    yp, hp = ssm_ops.ssm_scan_plain(*args, return_state=True)
    torch.testing.assert_close(y, yp, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hp, atol=1e-5, rtol=1e-5)


def _low_state_holds(out, ref, args, state_dtype=torch.bfloat16):
    """A bf16- or f16-state result against the plain version's: the state
    bit for bit, y within 1e-5 + 1e-5 * sum_n |h_n C_n| (the same f32
    products summed in another order)."""
    assert torch.equal(out[1], ref[1])
    assert accuracy.over_bound(out[0], ref[0], accuracy.terms(
        *args, state_dtype=state_dtype)) <= 1


@pytest.mark.parametrize("b,s,d,n", SSM_SWEEP)
@pytest.mark.parametrize("mix", ["f32", "model"])
def test_ssm_scan_bf16_state_kernel_matches_plain(cuda, b, s, d, n, mix):
    """ssm_scan_dtype "bfloat16": one launch; the state the plain
    version's bit for bit (expf and the plain version's roundings, op by
    op), y within the bound of its terms; a second call the same bits."""
    args = _ssm_inputs(cuda, b, s, d, n, mix, seed=s)
    before = ssm_ops.ssm_scan.launches
    out = ssm_ops.ssm_scan(*args, return_state=True,
                           state_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert ssm_ops.ssm_scan.launches == before + 1
    _low_state_holds(out, ssm_ops.ssm_scan_plain(
        *args, return_state=True, state_dtype=torch.bfloat16), args)
    again = ssm_ops.ssm_scan(*args, return_state=True,
                             state_dtype=torch.bfloat16)
    assert all(torch.equal(a, o) for a, o in zip(again, out))


@pytest.mark.parametrize("n,kind", [(16, "long"), (64, "long"),
                                    (64, "mamba2")])
def test_ssm_scan_bf16_state_kernel_at_long_memory(cuda, n, kind):
    """Long memory and zamba2's Mamba2 call at 2048 steps: the bf16 state
    bit for bit, and y nearer the bf16-state plain version than the f32
    one (the mode acts)."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    args = accuracy.inputs(1, 2048, 256, n, SSM_MIXES["model"], kind,
                           gen=gen)
    out = ssm_ops.ssm_scan(*args, return_state=True,
                           state_dtype=torch.bfloat16)
    ref = ssm_ops.ssm_scan_plain(*args, return_state=True,
                                 state_dtype=torch.bfloat16)
    _low_state_holds(out, ref, args)
    f32 = ssm_ops.ssm_scan_plain(*args)
    assert (out[0] - ref[0]).abs().max() < (out[0] - f32).abs().max()


@pytest.mark.parametrize("b,s,d,n", SSM_SWEEP)
@pytest.mark.parametrize("mix", ["f32", "model", "f16"])
def test_ssm_scan_f16_state_kernel_matches_plain(cuda, b, s, d, n, mix):
    """ssm_scan_dtype "float16": one launch; the state the plain version's
    bit for bit (expf, f16 products exact in f32, the sum rounded to f32
    and then to f16, as ``ref.mul_add``), y within the bound of its terms;
    a second call the same bits."""
    args = _ssm_inputs(cuda, b, s, d, n, mix, seed=s)
    before = ssm_ops.ssm_scan.launches
    out = ssm_ops.ssm_scan(*args, return_state=True,
                           state_dtype=torch.float16)
    torch.cuda.synchronize()
    assert ssm_ops.ssm_scan.launches == before + 1
    _low_state_holds(out, ssm_ops.ssm_scan_plain(
        *args, return_state=True, state_dtype=torch.float16), args,
        torch.float16)
    again = ssm_ops.ssm_scan(*args, return_state=True,
                             state_dtype=torch.float16)
    assert all(torch.equal(a, o) for a, o in zip(again, out))


@pytest.mark.parametrize("n,kind", [(16, "long"), (64, "long"),
                                    (64, "mamba2")])
def test_ssm_scan_f16_state_kernel_at_long_memory(cuda, n, kind):
    """Long memory and zamba2's Mamba2 call at 2048 steps in an f16
    model's mix: the f16 state bit for bit, and y nearer the f16-state
    plain version than the f32 one (the mode acts)."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    args = accuracy.inputs(1, 2048, 256, n, accuracy.F16_MIX, kind, gen=gen)
    out = ssm_ops.ssm_scan(*args, return_state=True,
                           state_dtype=torch.float16)
    ref = ssm_ops.ssm_scan_plain(*args, return_state=True,
                                 state_dtype=torch.float16)
    _low_state_holds(out, ref, args, torch.float16)
    f32 = ssm_ops.ssm_scan_plain(*args)
    assert (out[0] - ref[0]).abs().max() < (out[0] - f32).abs().max()


@pytest.mark.parametrize("b,s,d,n,mix,kind,chunk", [
    (2, 77, 40, 5, "model", "softplus", 8),
    (1, 2048, 8192, 16, "model", "softplus", 1024),   # falcon-mamba-7b's
])
def test_ssm_scan_function_bf16_grads_are_chunked_autograd_bit_for_bit(
        cuda, b, s, d, n, mix, kind, chunk):
    """SSMScan with a bf16 state: the bf16-state kernel forward once, and
    the gradients those of autograd through ssm_scan_chunked at bf16 and
    the JAX chunk, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    ins = [t.detach().requires_grad_() for t in accuracy.inputs(
        b, s, d, n, SSM_MIXES[mix], kind, gen=gen)]
    g = torch.randn((b, s, d), generator=gen, device=cuda)
    before = ssm_ops.ssm_scan.launches
    y = ssm_ops.SSMScan.apply(*ins, torch.bfloat16, chunk)
    got = torch.autograd.grad(y, ins, g)
    want = torch.autograd.grad(ssm_ops.ssm_scan_chunked(
        *ins, chunk=chunk, state_dtype=torch.bfloat16), ins, g)
    torch.cuda.synchronize()
    assert ssm_ops.ssm_scan.launches == before + 1
    assert all(torch.equal(u, w) for u, w in zip(got, want))


def test_ssm_scan_function_f16_grads_are_chunked_autograd_bit_for_bit(cuda):
    """SSMScan with an f16 state on an f16 model's inputs: the f16-state
    kernel forward once, and the gradients those of autograd through
    ssm_scan_chunked at f16 and the JAX chunk, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(77)
    ins = [t.detach().requires_grad_() for t in accuracy.inputs(
        2, 77, 40, 5, accuracy.F16_MIX, gen=gen)]
    g = torch.randn((2, 77, 40), generator=gen, device=cuda)
    before = ssm_ops.ssm_scan.launches
    y = ssm_ops.SSMScan.apply(*ins, torch.float16, 8)
    got = torch.autograd.grad(y, ins, g)
    want = torch.autograd.grad(ssm_ops.ssm_scan_chunked(
        *ins, chunk=8, state_dtype=torch.float16), ins, g)
    torch.cuda.synchronize()
    assert ssm_ops.ssm_scan.launches == before + 1
    assert all(u.dtype == t.dtype and torch.equal(u, w)
               for u, w, t in zip(got, want, ins))


def test_ssm_scan_kernel_raises_not_falls_back(cuda):
    dt, A, bm, cm, x = _ssm_inputs(cuda, 1, 8, 16, 4, "f32")
    with pytest.raises(ValueError):
        ssm_ops.ssm_scan(dt.double(), A, bm, cm, x)
    with pytest.raises(ValueError):
        ssm_ops.ssm_scan(dt, torch.zeros(16, ssm_ops.MAX_STATE + 1,
                                         device=cuda), bm, cm, x)
    with pytest.raises(ValueError):
        ssm_ops.ssm_scan(dt, A, bm.cpu(), cm, x)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        ssm_ops.ssm_scan(dt, A, bm, cm, x, state_dtype=torch.float64)


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
# rows below, at and just above a thread's registers (2^REG_BITS), a warp's
# (32 threads' registers) and a CTA's chunk; rows of 2 and 3 passes, where a
# pass runs strides of several sizes; rows of 2^20 and 2^22
_REGS = 1 << bs.REG_BITS
SORT_SPANS = [(3, _REGS - 1), (2, _REGS), (2, _REGS + 1), (2, 32 * _REGS - 1),
              (1, 32 * _REGS), (3, 32 * _REGS + 1), (1, bs.CHUNK // 2),
              (2, 2 * bs.CHUNK), (3, 4 * bs.CHUNK - 5), (5, 3 * bs.CHUNK),
              (2, 1 << 20), (1, 1 << 22)]


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


@pytest.mark.parametrize("rows,n", SORT_SPANS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_bitonic_sort_kernel_matches_plain_across_its_spans(cuda, rows, n,
                                                            dtype):
    """Shapes that cross each level of the kernel's layout and cut the
    network into 1 to 15 passes, each bit-exact against the plain version
    (keys as bits, payloads), with ties, NaN, signed zeros and the dtype's
    extremes among the keys."""
    keys = _sort_keys(cuda, rows, n, dtype, "edges", seed=n)
    ks, ps = bs.bitonic_sort(keys)
    kp, pp = bs.bitonic_sort_plain(keys)
    assert torch.equal(_bits(ks), _bits(kp)) and torch.equal(ps, pp)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_bitonic_sort_kernel_leaves_the_callers_tensors_alone(cuda, dtype):
    """The first pass reads the keys and payload and writes fresh outputs:
    the caller's tensors, here views with a row stride of their own, keep
    their bits."""
    base = _sort_keys(cuda, 3, 2 * bs.CHUNK + 64, dtype, "edges", seed=3)
    keys = base[:, 10:10 + 2 * bs.CHUNK + 3]            # strided rows
    payload = torch.randint(-9, 9, (3, 3 * bs.CHUNK), dtype=torch.int32,
                            device=cuda)[:, :keys.shape[1]]
    before = (_bits(base).clone(), payload.clone())
    ks, ps = bs.bitonic_sort(keys, payload)
    torch.cuda.synchronize()
    assert torch.equal(_bits(base), before[0])
    assert torch.equal(payload, before[1])
    kp, pp = bs.bitonic_sort_plain(keys, payload)
    assert torch.equal(_bits(ks), _bits(kp)) and torch.equal(ps, pp)
    assert ks.data_ptr() != keys.data_ptr()


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


# ---------------------------------------------------------------------------
# the multi-process pilot: worker processes on the card
# ---------------------------------------------------------------------------
def test_process_executor_spanning_sort_on_the_card(cuda):
    """2 worker processes of 2 ranks each, on the card by default (both on
    cuda:0 with one card): a sort task spanning both workers, its buckets
    packed by the kernel in each worker (held to its oracle there), equals
    numpy; each worker launched the kernel; none outlives shutdown."""
    from repro_torch import etl
    from repro_torch.core import (ProcessExecutor, SchedulerSession,
                                  TaskDescription, TaskState)
    from repro_torch.dataframe.shuffle import _gen_part, sort_task
    spec = {"rows_per_part": 300_000, "seed": 21, "verify_kernel": True}
    keys = np.concatenate([_gen_part(spec, p)["key"] for p in range(2)])
    with ProcessExecutor(n_workers=2, devices_per_worker=2) as ex:
        assert all(w.device.startswith("cuda:")
                   for w in ex.workers.values())
        etl.run_spanning(ex, "census", etl.radix_launches, reset=True)
        rep = SchedulerSession(ex, ex.resource_manager()).run(
            [TaskDescription(name="sort", ranks=4, fn=sort_task,
                             args=(spec,))], timeout=300)
        task = rep.tasks[0]
        assert task.state == TaskState.DONE, task.error
        assert {d.worker for d in task.devices} == {"w0", "w1"}
        counts = etl.run_spanning(ex, "census", etl.radix_launches).result
    assert task.result["n"] == len(keys) and task.result["sorted"]
    assert task.result["key_sum"] == int(
        np.add.reduce(keys.astype(np.uint64), dtype=np.uint64))
    assert len(counts) == 2 and all(c >= 1 for c in counts.values())
    assert task.p2p_bytes > 0
    assert all(w.proc.poll() is not None for w in ex.workers.values())


@pytest.mark.parametrize("tier", ["raw", "shm"])
def test_peer_frames_carry_cuda_tensors(cuda, tier):
    """A collective payload holding CUDA tensors is staged to host memory
    (``serialize._as_array``) and crosses on either transport tier bit for
    bit; a bfloat16 tensor (no numpy dtype) rides pickled and comes back on
    its device."""
    from pathlib import Path

    from repro_torch.core.executors import protocol, serialize
    from repro_torch.core.executors import shm as shmseg
    from repro_torch.core.executors.worker import _PeerNet
    if tier == "shm" and not shmseg.HAVE_SHM:
        pytest.skip("needs a /dev/shm mount")
    a, b = _PeerNet("wa", token="t"), _PeerNet("wb", token="t")
    a.start("127.0.0.1")
    b.start("127.0.0.1")
    x = torch.randn(1 << 16, generator=torch.Generator(cuda).manual_seed(0),
                    device=cuda)
    h = x[:100].to(torch.bfloat16)          # no numpy dtype: pickled leaf
    obj = {"x": x, "i": torch.arange(1000, device=cuda, dtype=torch.int32),
           "h": h, "tag": "t"}
    skel, metas, bufs = serialize.dumps_arrays(obj)
    head = dict(skel=skel, arrs=metas, uid=1, attempt=0, seq=0, part=0)
    if tier == "raw":
        assert a.send_kind("wb", b.data_addr, protocol.PEER_DATA_GEN,
                           bufs=bufs, **head)
    else:
        name = shmseg.segment_name("t", "wa")
        nbytes = shmseg.write(name, bufs)
        assert a.send_kind("wb", b.data_addr, protocol.PEER_DATA_SHM,
                           shm=name, nbytes=nbytes, **head)
    frame = b.take((1, 0, 0, 0), timeout=30)
    back = serialize.loads_arrays(frame["skel"], frame["arrs"],
                                  frame["payload"])
    if tier == "shm":
        assert not (Path("/dev/shm") / name).exists()
    assert back["tag"] == "t"
    assert np.array_equal(back["i"], np.arange(1000, dtype=np.int32))
    assert np.array_equal(back["x"].view(np.int32),
                          x.cpu().numpy().view(np.int32))
    assert back["h"].device == h.device and torch.equal(back["h"], h)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,kh,hd,dtype,mode", [
    (2, 128, 4, 2, 16, torch.float32, "full"),
    (1, 300, 8, 2, 64, torch.float32, "blockwise"),
    (1, 256, 8, 8, 128, torch.bfloat16, "full"),
    (1, 1024, 8, 2, 128, torch.bfloat16, "blockwise"),
    (1, 256, 8, 8, 128, torch.float16, "full"),
    (1, 1024, 8, 2, 112, torch.float16, "blockwise"),
])
def test_flash_attention_grads_are_plain_autograd_bit_for_bit(
        cuda, b, s, h, kh, hd, dtype, mode):
    """The autograd Function launches the kernel forward, and its gradients
    are those of autograd through the plain path, bit for bit."""
    import functools
    from repro_torch.models.attention import AttnMode, attend_plain
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=cuda).to(
        dtype).requires_grad_() for n in (h, kh, kh))
    g = torch.randn((b, s, h, hd), generator=gen, device=cuda).to(dtype)
    am = AttnMode(kind="full") if mode == "full" else \
        AttnMode(q_block=128, kv_block=128)
    plain = functools.partial(attend_plain, mode=am)
    before = fa.flash_attention.launches
    out = fa.FlashAttention.apply(q, k, v, True, plain)
    assert out.grad_fn is not None
    assert fa.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(plain(q, k, v, causal=True), (q, k, v), g)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), fa.flash_attention_plain(
        q.detach(), k.detach(), v.detach()).float(), rtol=tol, atol=tol)


def test_attend_keeps_cuda_attention_inside_autograd(cuda):
    """A model's attention on the card carries a gradient to wq, wk, wv and
    the qk norms; the same loss on the CPU gives the same gradients."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.models.attention import AttnMode
    from repro_torch.models.convert import params_from_jax, params_to_jax
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config("qwen3-8b")), n_layers=2)
    gen = torch.Generator().manual_seed(0)
    host = params_to_jax(get_model(cfg).init(gen, cfg))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64), dtype=np.int32))
    grads = {}
    for dev in ("cpu", cuda):
        model = params_from_jax(host, cfg, dev).requires_grad_()
        batch = {"tokens": tok.to(dev), "labels": tok.to(dev)}
        before = fa.flash_attention.launches
        get_model(cfg).loss_fn(model, cfg, batch,
                               AttnMode(kind="full")).backward()
        if dev == cuda:
            assert fa.flash_attention.launches == before + cfg.n_layers
        grads[str(dev)] = {k: p.grad.cpu() for k, p in
                           model.named_parameters()}
    for k, g in grads["cpu"].items():
        assert grads["cuda:0"][k].abs().max() > 0, k
        torch.testing.assert_close(grads["cuda:0"][k], g, rtol=1e-4,
                                   atol=1e-5 * float(g.abs().max()) + 1e-7)


@pytest.mark.parametrize("b,s,d,n,mix", [
    (1, 300, 100, 16, "f32"), (2, 77, 40, 5, "model"),
    (1, 2048, 8192, 16, "model"),      # falcon-mamba-7b's layer, train_ssm
])
def test_ssm_scan_function_grads_are_chunked_autograd_bit_for_bit(
        cuda, b, s, d, n, mix):
    """SSMScan launches the kernel forward once, and its gradients (each in
    its input's dtype) are those of autograd through ssm_scan_chunked, bit
    for bit."""
    dt, A, Bm, Cm, x = (t.detach().requires_grad_() for t in _ssm_inputs(
        cuda, b, s, d, n, mix))
    g = torch.randn((b, s, d), generator=torch.Generator(
        device=cuda).manual_seed(s), device=cuda)
    before = ssm_ops.ssm_scan.launches
    y = ssm_ops.SSMScan.apply(dt, A, Bm, Cm, x)
    assert y.grad_fn is not None
    assert ssm_ops.ssm_scan.launches == before + 1
    got = torch.autograd.grad(y, (dt, A, Bm, Cm, x), g)
    want = torch.autograd.grad(ssm_ops.ssm_scan_chunked(dt, A, Bm, Cm, x),
                               (dt, A, Bm, Cm, x), g)
    torch.cuda.synchronize()
    assert ssm_ops.ssm_scan.launches == before + 1
    assert all(u.dtype == t.dtype and torch.equal(u, w)
               for u, w, t in zip(got, want, (dt, A, Bm, Cm, x)))


# the attention shapes the VLM and audio families give the kernel: GQA
# group 7 (internvl2-1b, 14/2 heads, its 256 patches before the tokens),
# whisper's encoder over 1500 frames (non-causal, 1500 is no whole number
# of 128-row tiles) and its cross-attention (non-causal, Sq != Sk)
NEW_FAMILY_ATTN = [
    (1, 256 + 512, 256 + 512, 14, 2, True),
    (2, 1500, 1500, 16, 16, False),
    (1, 100, 1500, 16, 16, False),
    (2, 4, 1500, 16, 16, False),
    (1, 448, 448, 16, 16, True),
]


@pytest.mark.parametrize("b,sq,sk,h,kh,causal", NEW_FAMILY_ATTN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_vlm_and_audio_shapes(cuda, b, sq, sk, h, kh,
                                                     causal, dtype):
    """Forward against the plain version at the standing tolerances, and
    through FlashAttention the gradients of autograd through the plain
    path, bit for bit."""
    import functools
    from repro_torch.models.attention import AttnMode, attend_plain
    gen = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((b, sq, h, 64), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, kh, 64), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    out = fa.flash_attention(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), fa.flash_attention_plain(
        q, k, v, causal=causal).float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), fa.flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal),
            atol=4e-3, rtol=2e-2)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    g = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    plain = functools.partial(attend_plain, mode=AttnMode(kind="full"))
    got = torch.autograd.grad(fa.FlashAttention.apply(q, k, v, causal,
                                                      plain), (q, k, v), g)
    want = torch.autograd.grad(plain(q, k, v, causal=causal), (q, k, v), g)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-medium"])
def test_vlm_and_audio_f32_token_check_at_reduced_widths(cuda, arch):
    """The continuous engine (prefill through the kernel, plain decode)
    against a full forward through the kernel per token; whisper launches
    the kernel for its encoder, its self- and its cross-attention."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import ContinuousEngine, greedy_reference
    from repro_torch.serve_lm import make_requests
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=2)
    params = get_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    reqs = make_requests(cfg, [30, 7, 19], [6, 6, 6])
    before = fa.flash_attention.launches
    out = ContinuousEngine(cfg, params, max_batch=2, max_seq=64).run(reqs)
    per_prefill = cfg.n_layers if arch == "internvl2-1b" else \
        cfg.n_encoder_layers + 2 * cfg.n_layers
    assert fa.flash_attention.launches - before == per_prefill * len(reqs)
    for r in reqs:
        np.testing.assert_array_equal(
            out[r.uid], greedy_reference(cfg, params, r.prompt,
                                         r.max_new_tokens))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "internvl2-1b",
                                  "whisper-medium"])
def test_new_families_train_on_the_card_as_on_the_cpu(cuda, arch):
    """Six steps of train_lm's ci preset at ``arch`` on the card (TF32 off)
    and on the CPU from the same parameters and batches: losses within
    1e-4 relative; the card's steps launch each kernel of the family once
    a layer a forward (the encoder-decoder: its encoder's, self- and
    cross-attention)."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_to_jax
    from repro_torch.train.data import SyntheticCorpus
    from repro_torch.train.trainer import Trainer
    from repro_torch.train_lm import model_for, optimizer_for, \
        with_modal_inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, shape, _ = model_for("ci", arch)
    host = params_to_jax(get_model(cfg).init(
        torch.Generator().manual_seed(0), cfg))
    batches = list(with_modal_inputs(cfg, SyntheticCorpus(
        cfg.vocab_size, 0).batches(shape.global_batch, shape.seq_len, 6)))
    kernel = ssm_ops.ssm_scan if cfg.family == "ssm" else fa.flash_attention
    per_forward = cfg.n_encoder_layers + 2 * cfg.n_layers \
        if cfg.family == "audio" else cfg.n_layers
    losses = {}
    for dev in (cuda, "cpu"):
        before = kernel.launches
        tr = Trainer(cfg, ParallelConfig(), shape, optimizer_for(6),
                     device=dev)
        _, losses[str(dev)] = tr.fit(batches, 6, tr.state_from_jax(host),
                                     log_every=0)
        if dev == cuda:
            assert kernel.launches - before == 6 * per_forward
    np.testing.assert_allclose(losses["cuda:0"], losses["cpu"], rtol=1e-4)
    assert losses["cpu"][-1] < losses["cpu"][0]


def test_trainer_steps_and_resumes_on_the_card(cuda, tmp_path):
    """Trainer.fit on the card: the loss falls, every step launches the
    kernel once a layer, and a fresh trainer restores the step-4 state bit
    for bit."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.train.data import SyntheticCorpus
    from repro_torch.train.trainer import Trainer
    from repro_torch.train_lm import model_for, optimizer_for
    cfg, shape, _ = model_for("ci")
    tr = Trainer(cfg, ParallelConfig(), shape, optimizer_for(8),
                 ckpt_dir=str(tmp_path), ckpt_every=4, device=cuda)
    before = fa.flash_attention.launches
    state, losses = tr.fit(SyntheticCorpus(cfg.vocab_size).batches(
        shape.global_batch, shape.seq_len, 8), 8, log_every=0)
    assert fa.flash_attention.launches == before + 8 * cfg.n_layers
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    back = Trainer(cfg, ParallelConfig(), shape, optimizer_for(8),
                   ckpt_dir=str(tmp_path), device=cuda).maybe_restore()
    assert back.step == 8
    for a, b in zip(back.params.parameters(), state.params.parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the hybrid family: flash_attention at head dim 112 (zamba2's shared block,
# on the hd-128 tiles in bf16) and Mamba2 through ssm_scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 129, 300, 2048])
def test_flash_attention_f32_kernel_across_head_dims(cuda, hd, s):
    """Every head dim the kernel takes in f32, GQA group 4, lengths that end
    inside, on and past a 64-row tile, within 2e-5 of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(hd + s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((1, s, 8, hd), (1, s, 2, hd), (1, s, 2, hd)))
    out = fa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s", [1, 63, 129, 300, 2048])
@pytest.mark.parametrize("dtype", list(ATTN_TOL))
def test_flash_attention_at_head_dim_112_forward_and_backward(cuda, s, dtype):
    """zamba2's shared attention (32 heads, MHA, hd 112) at B = 1: the
    kernel's forward within the standing tolerances (a bf16 or f16 result
    also against the plain version in f32), and through FlashAttention the
    gradients of autograd through the plain path the train step
    differentiates at that length, bit for bit."""
    import functools
    from repro_torch.models.attention import AttnMode, attend_plain
    gen = torch.Generator(device=cuda).manual_seed(112 + s)
    q, k, v = (torch.randn((1, s, 32, 112), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), fa.flash_attention_plain(
        q, k, v).float(), atol=tol, rtol=tol)
    if dtype != torch.float32:
        _holds_to_f32_plain(out, q, k, v)
    plain = functools.partial(attend_plain, mode=AttnMode())
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    g = torch.randn(q.shape, generator=gen, device=cuda).to(dtype)
    got = torch.autograd.grad(fa.FlashAttention.apply(q, k, v, True, plain),
                              (q, k, v), g)
    want = torch.autograd.grad(plain(q, k, v, causal=True), (q, k, v), g)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _mamba2_scan_inputs(cuda, s, dtype, seed=0):
    """The scan's inputs as zamba2-7b's Mamba2 layer gives them
    (``ssm._mamba2_ssm`` and ``_mamba2_channels``): each of 112 heads' dt
    and A = -exp(A_log) repeated over its 64 channels (D = 7168), x, Bm and
    Cm slices of a (1, S, 7168 + 2 * 64) ``xbc_conv`` in ``dtype``; the
    head's decay rates drawn, dt_bias -2 as the init's."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("zamba2-7b")
    gen = torch.Generator(device=cuda).manual_seed(seed)
    nh = cfg.ssm_heads
    p = {"A_log": torch.randn(nh, generator=gen, device=cuda) * 0.5,
         "dt_bias": torch.full((nh,), -2.0, device=cuda)}
    xbc = torch.nn.functional.silu(torch.randn(
        (1, s, cfg.d_inner + 2 * cfg.ssm_state), generator=gen,
        device=cuda)).to(dtype)
    dt = torch.randn((1, s, nh), generator=gen, device=cuda).to(dtype)
    dth, A, xh, Bm, Cm = ssm._mamba2_ssm(p, xbc, dt, cfg)
    dtc, Ac = ssm._mamba2_channels(dth, A, cfg)
    return dtc, Ac, Bm, Cm, xh


@pytest.mark.parametrize("s", [1, 300, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_scan_through_the_kernel_holds_to_float64(cuda, s, dtype):
    """zamba2-7b's Mamba2 call of ssm_scan (the ssm_scan64 build), f32 and
    the bf16 model's mix: y within 1e-5 + 1e-5 * sum_n |h_n C_n| and the
    final state within 1e-5 + 1e-5 * |exact| of the float64 scan of the
    same values, as the plain version holds them; a second call
    bit-identical."""
    args = _mamba2_scan_inputs(cuda, s, dtype, seed=s)
    assert ssm_ops.build_for(args[1].shape[1]) == 64
    before = ssm_ops.ssm_scan.launches
    out = ssm_ops.ssm_scan(*args, return_state=True)
    assert ssm_ops.ssm_scan.launches == before + 1
    exact = accuracy.scan_f64(*args)
    assert accuracy.held_to_f64(out, exact) <= 1
    assert accuracy.held_to_f64(
        ssm_ops.ssm_scan_plain(*args, return_state=True), exact) <= 1
    again = ssm_ops.ssm_scan(*args, return_state=True)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_mamba2_scan_function_grads_are_chunked_autograd_bit_for_bit(cuda):
    """One zamba2 layer's SSMScan call at S = 300: gradients of autograd
    through ssm_scan_chunked, bit for bit, reaching A_log through the
    per-head repeat."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("zamba2-7b")
    gen = torch.Generator(device=cuda).manual_seed(7)
    a_log = (torch.randn(cfg.ssm_heads, generator=gen, device=cuda)
             * 0.5).requires_grad_()
    dt, _, Bm, Cm, x = (t.detach().requires_grad_() for t in
                        _mamba2_scan_inputs(cuda, 300, torch.bfloat16))
    A = ssm._mamba2_channels(dt[..., ::cfg.ssm_head_dim],
                             -torch.exp(a_log), cfg)[1]
    g = torch.randn(x.shape, generator=gen, device=cuda)
    wrt = (dt, a_log, Bm, Cm, x)
    got = torch.autograd.grad(ssm_ops.SSMScan.apply(dt, A, Bm, Cm, x), wrt,
                              g, retain_graph=True)     # A's repeat again
    want = torch.autograd.grad(ssm_ops.ssm_scan_chunked(dt, A, Bm, Cm, x),
                               wrt, g)
    assert all(torch.equal(u, w) for u, w in zip(got, want))
    assert float(got[1].abs().max()) > 0


def test_hybrid_f32_token_check_at_reduced_widths(cuda, monkeypatch):
    """zamba2 at reduced widths (2 groups of 2 Mamba2 layers, the shared
    block at hd 16) in f32: prefill through both kernels plus plain decode,
    in the continuous engine, against a full forward per token;
    flash_attention once a group and ssm_scan once a layer a prefill."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.serve import ContinuousEngine, greedy_reference
    from repro_torch.serve_lm import make_requests
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = reduced(get_config("zamba2-7b"))
    params = get_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), cfg)
    reqs = make_requests(cfg, [30, 2, 19], [6, 6, 6])
    before = fa.flash_attention.launches, ssm_ops.ssm_scan.launches
    out = ContinuousEngine(cfg, params, max_batch=2, max_seq=64).run(reqs)
    assert fa.flash_attention.launches - before[0] == 2 * len(reqs)
    assert ssm_ops.ssm_scan.launches - before[1] == 4 * len(reqs)
    for r in reqs:
        np.testing.assert_array_equal(
            out[r.uid], greedy_reference(cfg, params, r.prompt,
                                         r.max_new_tokens))


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b",
                                  "zamba2-7b"])
def test_f16_models_on_the_card_match_the_cpu(cuda, arch):
    """dtype "float16" (and ssm_scan_dtype "float16" for the SSM families)
    at reduced widths: the forward's logits on the card, through the f16
    modes of both kernels, within 1e-2 of the largest |logit| of the same
    weights' logits on the CPU (f16 products round alike only to an ulp or
    two)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_jax, params_to_jax
    base = reduced(get_config(arch))
    cfg = dataclasses.replace(base, dtype="float16", **(
        {"ssm_scan_dtype": "float16"} if base.family != "dense" else {}))
    host = params_to_jax(get_model(cfg).init(
        torch.Generator().manual_seed(0), cfg))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40), dtype=np.int32))
    logits, launches = {}, {}
    for dev in ("cpu", cuda):
        model = params_from_jax(host, cfg, dev)
        before = fa.flash_attention.launches, ssm_ops.ssm_scan.launches
        with torch.inference_mode():
            logits[str(dev)] = get_model(cfg).forward(
                model, cfg, {"tokens": tok.to(dev)}).float().cpu()
        launches[str(dev)] = (fa.flash_attention.launches - before[0],
                              ssm_ops.ssm_scan.launches - before[1])
    assert launches["cpu"] == (0, 0)
    want = (cfg.n_layers // cfg.shared_attn_period, cfg.n_layers) \
        if cfg.family == "hybrid" else {"dense": (cfg.n_layers, 0),
                                        "ssm": (0, cfg.n_layers)}[cfg.family]
    assert launches["cuda:0"] == want
    ref = logits["cpu"]
    assert torch.isfinite(logits["cuda:0"]).all()
    assert float((logits["cuda:0"] - ref).abs().max()) <= \
        1e-2 * float(ref.abs().max())


def test_serve_lm_serves_zamba2_on_the_card(cuda):
    from repro_torch import serve_lm
    before = fa.flash_attention.launches, ssm_ops.ssm_scan.launches
    serve_lm.main(["--device", str(cuda), "--arch", "zamba2-7b"])
    assert fa.flash_attention.launches > before[0]
    assert ssm_ops.ssm_scan.launches > before[1]


# ---------------------------------------------------------------------------
# the distributed layer: a mesh of logical ranks on cuda:0
# ---------------------------------------------------------------------------
def test_sharded_step_on_the_card_matches_the_cpu(cuda):
    """One sharded f32 step of reduced qwen3-8b (2 layers) on a (2, 2) mesh
    of logical ranks of cuda:0 (TF32 off) and of the CPU, from the same
    parameters and batch: the loss within 1e-5 relative and every
    parameter leaf within 1e-5 of its largest magnitude; the card's step
    launches flash_attention once a layer a (data, model) rank a forward
    (twice under remat): the model axis splits the heads."""
    import dataclasses
    from repro_torch.configs import (ParallelConfig, ShapeConfig, get_config,
                                     reduced)
    from repro_torch.distributed.sharding import flat_paths
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_to_jax
    from repro_torch.train.data import SyntheticCorpus
    from repro_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config("qwen3-8b")), n_layers=2)
    shape = ShapeConfig("t", "train", 32, 8)
    host = params_to_jax(get_model(cfg).init(
        torch.Generator().manual_seed(0), cfg))
    batches = list(SyntheticCorpus(cfg.vocab_size, 0).batches(8, 32, 1))
    out = {}
    for dev in (cuda, "cpu"):
        before = fa.flash_attention.launches
        tr = Trainer(cfg, ParallelConfig(), shape,
                     mesh=make_local_mesh(2, 2, device=dev))
        state, losses = tr.fit(batches, 1, tr.state_from_jax(host),
                               log_every=0)
        if dev == cuda:
            assert fa.flash_attention.launches - before == \
                2 * 2 * cfg.n_layers * (2 if cfg.remat else 1)
        out[str(dev)] = (losses, flat_paths(tr.state_tree(state)["params"]))
    np.testing.assert_allclose(out["cuda:0"][0], out["cpu"][0], rtol=1e-5)
    for k, want in out["cpu"][1].items():
        got = out["cuda:0"][1][k]
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max()), k


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
def test_moe_ffn_shardmap_on_the_card_matches_moe_ffn_per_shard(cuda, grid):
    """Local-expert EP on a mesh of logical ranks of cuda:0 (reduced
    qwen2-moe, f32, TF32 off, tokens around one shared vector so that
    pairs drop): within 1e-5 of the largest |output| of moe_ffn run on
    each data shard alone."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.context import axes_ctx
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")),
                              capacity_factor=1.25)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.moe_init(gen, cfg, torch.float32)
    x = torch.randn((512, cfg.d_model), generator=gen, device=cuda) + \
        torch.randn((cfg.d_model,), generator=gen, device=cuda)
    with axes_ctx(make_local_mesh(*grid, device=cuda), "shardmap"):
        got = moe.moe_ffn(p, x, cfg)
    want = torch.cat([moe.moe_ffn(p, s, cfg)
                      for s in x.split(512 // grid[0])])
    assert float((got - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


def _serve_cells(rows, prompt, new):
    from repro_torch.configs import ShapeConfig
    return (ShapeConfig("p", "prefill", prompt + new, rows),
            ShapeConfig("d", "decode", prompt + new, rows))


def test_sharded_bf16_prefill_holds_each_kernel_call_to_f32_plain(
        cuda, monkeypatch):
    """The sharded prefill of reduced qwen3-8b in bf16 on a (2, 2) mesh of
    logical ranks of cuda:0: flash_attention launches once a layer a (data,
    model) rank, on the rank's half of the heads, and each call's result
    lies within 4e-3 + 2e-2 |plain| of the plain version run in f32 on its
    inputs (the bf16 bound of the kernel checks)."""
    import dataclasses
    from repro_torch.configs import ParallelConfig, get_config, reduced
    from repro_torch.distributed.steps import make_prefill_step, shard_model
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import (get_model, make_concrete_batch,
                                    prefill_batch_shapes)
    cfg = dataclasses.replace(reduced(get_config("qwen3-8b")),
                              dtype="bfloat16")
    calls, kernel = [], fa.flash_attention

    def recorded(q, k, v, *, causal=True):
        out = kernel(q, k, v, causal=causal)
        calls.append((q, k, v, causal, out))
        return out
    recorded.launches = 0           # the kernel counts on the module's name
    monkeypatch.setattr(fa, "flash_attention", recorded)
    mesh = make_local_mesh(2, 2, device=cuda)
    pshape, _ = _serve_cells(4, 256, 4)
    step = make_prefill_step(cfg, mesh, ParallelConfig(), pshape)
    model = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                                cfg)
    params = shard_model(model, step.info, mesh)
    batch = make_concrete_batch(prefill_batch_shapes(cfg, 4, 256),
                                np.random.default_rng(0), cfg.vocab_size,
                                cuda)
    _, logits = step.fn(params, batch)
    assert recorded.launches == len(calls) == 2 * 2 * cfg.n_layers
    assert {tuple(q.shape[2:]) for q, *_ in calls} == {
        (cfg.n_heads // 2, cfg.head_dim)}
    assert all(torch.isfinite(x).all() for x in logits)
    for q, k, v, causal, out in calls:
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                       causal=causal)
        assert out.dtype == torch.bfloat16
        assert bool(((out.float() - ref).abs()
                     <= 4e-3 + 2e-2 * ref.abs()).all())


@pytest.mark.parametrize("arch,impl", [("qwen3-8b", "gspmd"),
                                       ("qwen2-moe-a2.7b", "shardmap")])
def test_sharded_f32_prefill_and_decode_tokens_equal_one_rank(cuda, arch,
                                                              impl):
    """Reduced ``arch`` in f32 (TF32 off; the MoE at a capacity that drops
    nothing): the sharded prefill and 4 greedy decode steps on a (2, 2)
    mesh of logical ranks of cuda:0 give one rank's tokens, the logits
    within 1e-5 of the largest |logit|."""
    import dataclasses
    from repro_torch.configs import ParallelConfig, get_config, reduced
    from repro_torch.distributed.sharding import unshard
    from repro_torch.distributed.steps import (make_decode_step,
                                               make_prefill_step,
                                               shard_model)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import (get_model, make_concrete_batch,
                                    prefill_batch_shapes)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(arch))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    mesh = make_local_mesh(2, 2, device=cuda)
    par = ParallelConfig(moe_impl=impl)
    cells = _serve_cells(4, 128, 4)
    sharded = [make_prefill_step(cfg, mesh, par, cells[0]),
               make_decode_step(cfg, mesh, par, cells[1])]
    one = [make_prefill_step(cfg, None, par, cells[0]),
           make_decode_step(cfg, None, par, cells[1])]
    model = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                                cfg)
    params = shard_model(model, sharded[0].info, mesh)
    batch = make_concrete_batch(prefill_batch_shapes(cfg, 4, 128),
                                np.random.default_rng(0), cfg.vocab_size,
                                cuda)
    cache, logits = sharded[0].fn(params, batch)
    one_cache, want = one[0].fn(model, batch)
    for t in range(5):
        got = unshard(logits, sharded[0].info["logit_spec"], mesh)
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
        if t == 4:
            break
        feed = {"tokens": want.argmax(-1, keepdim=True).to(torch.int32),
                "positions": torch.full((4,), 128 + t, dtype=torch.int32,
                                        device=cuda)}
        logits, cache = sharded[1].fn(params, feed, cache)
        want, one_cache = one[1].fn(model, feed, one_cache)
