"""The port's dataframe layer against the JAX package's.

Inputs come from numpy (or hypothesis, with the strategies of
``tests/test_dataframe_local.py``) and go through both packages on the CPU.
Integers and moved values are compared bit-exact; groupby float sums at
``rtol=1e-6``, because neither framework fixes the order of a scatter-add.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st
from tests._subproc import run_with_devices

from repro.core import build_communicator as jax_build_communicator
from repro.dataframe import ops_dist as JD
from repro.dataframe import ops_local as JL
from repro.dataframe import partition as jax_partition
from repro.dataframe import reference as R
from repro.dataframe.table import Table as JTable
from repro.dataframe.table import from_numpy as jax_from_numpy
from repro_torch.core import build_communicator, logical_devices
from repro_torch.dataframe import comm
from repro_torch.dataframe import ops_dist as D
from repro_torch.dataframe import ops_local as L
from repro_torch.dataframe import partition
from repro_torch.dataframe.table import (
    DistTable, from_numpy, from_reference, to_reference,
)

CPU = "cpu"
ints = st.integers(min_value=0, max_value=50)


def _both(data, capacity=None):
    return (jax_from_numpy(data, capacity=capacity),
            from_numpy(data, capacity=capacity, device=CPU))


def _jref(table):
    return ({k: np.asarray(v) for k, v in table.columns.items()},
            np.asarray(table.nrows))


def _assert_same_table(jt, pt):
    jc, jn = _jref(jt)
    pc, pn = to_reference(pt)
    np.testing.assert_array_equal(pn, jn)
    assert set(pc) == set(jc)
    for k in jc:
        assert pc[k].dtype == jc[k].dtype, k
        np.testing.assert_array_equal(pc[k], jc[k], err_msg=k)


def test_hash_key_matches_jax_on_negative_and_wide_keys():
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        np.asarray([-2**31, -65537, -65536, -1, 0, 1, 65535, 65536, 65537,
                    2**31 - 1, 123456789], np.int32),
        rng.integers(-2**31, 2**31 - 1, 5000, dtype=np.int32)])
    want = np.asarray(JL.hash_key(jnp.asarray(keys))).astype(np.int64)
    got = L.hash_key(torch.from_numpy(keys))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    jt, pt = _both({"k": keys}, capacity=len(keys) + 7)
    for n_parts in (1, 3, 4, 7):
        np.testing.assert_array_equal(
            partition.hash_partition(pt, "k", n_parts).numpy(),
            np.asarray(jax_partition.hash_partition(jt, "k", n_parts)))
    splitters = np.asarray([-1000, 0, 65536], np.int32)
    np.testing.assert_array_equal(
        partition.range_partition(pt, "k", torch.from_numpy(splitters)).numpy(),
        np.asarray(jax_partition.range_partition(jt, "k",
                                                 jnp.asarray(splitters))))


def test_collectives_over_rank_lists():
    devs = [torch.device(CPU)] * 3
    xs = [torch.tensor([r, 10 * r]) for r in range(3)]
    assert [x.tolist() for x in comm.all_gather(xs, devs)] == \
        [[[0, 0], [1, 10], [2, 20]]] * 3
    assert [x.tolist() for x in comm.psum(xs, devs)] == [[3, 30]] * 3
    assert [x.tolist() for x in comm.pmax(xs, devs)] == [[2, 20]] * 3
    assert [int(x) for x in comm.axis_index(devs)] == [0, 1, 2]
    assert comm.axis_size(devs) == 3
    sends = [torch.arange(3) + 10 * r for r in range(3)]   # (P,) per rank
    assert [x.tolist() for x in comm.all_to_all(sends, devs)] == \
        [[0, 10, 20], [1, 11, 21], [2, 12, 22]]


@settings(max_examples=12, deadline=None)
@given(st.lists(ints, min_size=1, max_size=40), st.integers(0, 20))
def test_sort_by_matches_jax(keys, extra_cap):
    data = {"k": np.asarray(keys, np.int32),
            "v": np.arange(len(keys), dtype=np.float32)}
    jt, pt = _both(data, capacity=len(keys) + extra_cap)
    _assert_same_table(JL.sort_by(jt, "k"), L.sort_by(pt, "k"))


@settings(max_examples=10, deadline=None)
@given(st.lists(st.booleans(), min_size=1, max_size=40))
def test_filter_rows_matches_jax(keep):
    n = len(keep)
    data = {"k": np.arange(n, dtype=np.int32),
            "v": np.arange(n, dtype=np.float32)}
    jt, pt = _both(data, capacity=n + 3)
    mask = np.concatenate([np.asarray(keep), np.zeros(3, bool)])
    _assert_same_table(JL.filter_rows(jt, jnp.asarray(mask)),
                       L.filter_rows(pt, torch.from_numpy(mask)))


@settings(max_examples=12, deadline=None)
@given(st.lists(ints, min_size=1, max_size=30),
       st.lists(ints, min_size=1, max_size=30))
def test_join_inner_matches_jax(lk, rk):
    left = {"k": np.asarray(lk, np.int32),
            "v": np.arange(len(lk), dtype=np.float32)}
    right = {"k": np.asarray(rk, np.int32),
             "w": np.arange(len(rk), dtype=np.float32) + 100}
    ref = R.ref_join_inner(left, right, "k")
    out_cap = max(len(ref["k"]), 1) + 8
    jl, pl = _both(left, capacity=len(lk) + 5)
    jr, pr = _both(right, capacity=len(rk) + 3)
    jo, jovf = JL.join_inner(jl, jr, "k", out_cap)
    po, povf = L.join_inner(pl, pr, "k", out_cap)
    _assert_same_table(jo, po)
    assert bool(povf) == bool(jovf) is False


def test_join_overflow_flag_matches_jax():
    left = {"k": np.zeros(10, np.int32), "v": np.arange(10, dtype=np.float32)}
    right = {"k": np.zeros(10, np.int32), "w": np.arange(10, dtype=np.float32)}
    jl, pl = _both(left)
    jr, pr = _both(right)
    jo, jovf = JL.join_inner(jl, jr, "k", out_capacity=16)   # needs 100
    po, povf = L.join_inner(pl, pr, "k", out_capacity=16)
    assert bool(povf) and bool(jovf)
    _assert_same_table(jo, po)


@settings(max_examples=12, deadline=None)
@given(st.lists(ints, min_size=1, max_size=40))
def test_groupby_sum_matches_jax(keys):
    vals = np.random.default_rng(0).normal(size=len(keys)).astype(np.float32)
    data = {"k": np.asarray(keys, np.int32), "v": vals}
    jt, pt = _both(data, capacity=len(keys) + 4)
    jc, jn = _jref(JL.groupby_sum(jt, "k", ["v"]))
    pc, pn = to_reference(L.groupby_sum(pt, "k", ["v"]))
    np.testing.assert_array_equal(pn, jn)
    np.testing.assert_array_equal(pc["k"], jc["k"])
    np.testing.assert_allclose(pc["v"], jc["v"], rtol=1e-6)


def test_concat_matches_jax():
    ja, pa = _both({"k": np.asarray([1, 2], np.int32)}, capacity=4)
    jb, pb = _both({"k": np.asarray([3, 4, 5], np.int32)}, capacity=5)
    _assert_same_table(JL.concat(ja, jb, capacity=8),
                       L.concat(pa, pb, capacity=8))
    # rows past the capacity drop, as with mode="drop"
    _assert_same_table(JL.concat(ja, jb, capacity=4),
                       L.concat(pa, pb, capacity=4))


# ---------------------------------------------------------------------------
# the shuffle pack: radix_partition against the JAX argsort pack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("nrows,cap,send_cap", [
    (200, 200, 300),     # all rows valid, ample room
    (130, 200, 300),     # partial validity: 70 padding rows
    (200, 256, 20),      # overflowing send buffers
])
def test_local_shuffle_pack_matches_jax(n_parts, nrows, cap, send_cap):
    rng = np.random.default_rng(n_parts * 1000 + nrows)
    data = {"k": rng.integers(-50, 50, nrows, dtype=np.int32),
            "v": rng.normal(size=nrows).astype(np.float32)}
    target = rng.integers(0, n_parts, cap, dtype=np.int32)
    jt, pt = _both(data, capacity=cap)
    jb, js, jo = JD._local_shuffle_pack(jt, jnp.asarray(target), n_parts,
                                        send_cap)
    pb, ps, po = D._local_shuffle_pack(pt, torch.from_numpy(target), n_parts,
                                       send_cap)
    for k in jb:
        assert tuple(pb[k].shape) == (n_parts, send_cap)
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert bool(po) == bool(jo) == (send_cap == 20)


# ---------------------------------------------------------------------------
# distributed operators
# ---------------------------------------------------------------------------
def _dist_data(seed=42, n=1200, n2=900):
    rng = np.random.default_rng(seed)
    a = {"k": rng.integers(0, 300, n).astype(np.int32),
         "v": rng.normal(size=n).astype(np.float32)}
    b = {"k": rng.integers(0, 300, n2).astype(np.int32),
         "w": rng.normal(size=n2).astype(np.float32)}
    return a, b


def _valid_rows(cols, nrows):
    """Per-rank valid rows of a rank-major layout."""
    P = len(nrows)
    return [{k: v.reshape((P, -1) + v.shape[1:])[r, :nrows[r]]
             for k, v in cols.items()} for r in range(P)]


def _assert_same_dist(jout, pout, float_cols=()):
    jc, jn = _jref(jout)
    pc, pn = to_reference(pout)
    np.testing.assert_array_equal(pn, jn)
    for jr, pr in zip(_valid_rows(jc, jn), _valid_rows(pc, pn), strict=True):
        for k in jr:
            if k in float_cols:
                np.testing.assert_allclose(pr[k], jr[k], rtol=1e-6)
            else:
                np.testing.assert_array_equal(pr[k], jr[k], err_msg=k)


@pytest.fixture(scope="module")
def one_rank():
    jcomm = jax_build_communicator(jax.devices()[:1], axes=("df",))
    pcomm = build_communicator(logical_devices(1, CPU))
    return jcomm, pcomm


def test_dist_sort_one_rank_matches_jax(one_rank):
    jcomm, pcomm = one_rank
    a, _ = _dist_data()
    jout, jovf = JD.make_dist_sort(jcomm.mesh, "k")(
        JD.shard_table(jcomm, a, 1300))
    pout, povf = D.make_dist_sort(pcomm, "k")(D.shard_table(pcomm, a, 1300))
    _assert_same_dist(jout, pout)
    assert bool(povf) == bool(jovf) is False


def test_dist_join_one_rank_matches_jax(one_rank):
    jcomm, pcomm = one_rank
    a, b = _dist_data()
    jout, jovf = JD.make_dist_join(jcomm.mesh, "k", out_factor=8.0)(
        JD.shard_table(jcomm, a, 1300), JD.shard_table(jcomm, b, 1300))
    pout, povf = D.make_dist_join(pcomm, "k", out_factor=8.0)(
        D.shard_table(pcomm, a, 1300), D.shard_table(pcomm, b, 1300))
    _assert_same_dist(jout, pout)
    assert bool(povf) == bool(jovf) is False


def test_dist_groupby_one_rank_matches_jax(one_rank):
    jcomm, pcomm = one_rank
    a, _ = _dist_data()
    jout, jovf = JD.make_dist_groupby_sum(jcomm.mesh, "k", ["v"])(
        JD.shard_table(jcomm, a, 1300))
    pout, povf = D.make_dist_groupby_sum(pcomm, "k", ["v"])(
        D.shard_table(pcomm, a, 1300))
    _assert_same_dist(jout, pout, float_cols=("v",))
    assert bool(povf) == bool(jovf) is False


def test_dist_join_overflow_flag_one_rank_matches_jax(one_rank):
    """All keys equal: the join needs n*n rows against out_factor=2."""
    jcomm, pcomm = one_rank
    d = {"k": np.zeros(60, np.int32), "v": np.arange(60, dtype=np.float32)}
    jout, jovf = JD.make_dist_join(jcomm.mesh, "k")(
        JD.shard_table(jcomm, d, 64), JD.shard_table(jcomm, d, 64))
    pout, povf = D.make_dist_join(pcomm, "k")(
        D.shard_table(pcomm, d, 64), D.shard_table(pcomm, d, 64))
    assert bool(povf) and bool(jovf)
    _assert_same_dist(jout, pout)


@pytest.fixture(scope="module")
def four_ranks():
    return build_communicator(logical_devices(4, CPU))


def test_dist_sort_four_ranks_matches_reference(four_ranks):
    a, _ = _dist_data()
    out, ovf = D.make_dist_sort(four_ranks, "k")(
        D.shard_table(four_ranks, a, 700))
    assert not bool(ovf)
    got = D.collect_table(out)
    ref = R.ref_sort(a, "k")
    np.testing.assert_array_equal(got["k"], ref["k"])
    np.testing.assert_array_equal(R.sorted_rows(got), R.sorted_rows(a))
    # each rank holds one contiguous key range
    ranges = [(int(s.columns["k"][0]), int(s.columns["k"][int(s.nrows) - 1]))
              for s in out.shards if int(s.nrows)]
    assert all(hi <= lo for (_, hi), (lo, _) in zip(ranges, ranges[1:]))


def test_dist_join_four_ranks_matches_reference(four_ranks):
    a, b = _dist_data()
    out, ovf = D.make_dist_join(four_ranks, "k", out_factor=8.0)(
        D.shard_table(four_ranks, a, 700), D.shard_table(four_ranks, b, 700))
    assert not bool(ovf)
    got = D.collect_table(out)
    ref = R.ref_join_inner(a, b, "k")
    np.testing.assert_array_equal(R.sorted_rows(got), R.sorted_rows(ref))


def test_dist_groupby_four_ranks_matches_reference(four_ranks):
    a, _ = _dist_data()
    out, ovf = D.make_dist_groupby_sum(four_ranks, "k", ["v"])(
        D.shard_table(four_ranks, a, 700))
    assert not bool(ovf)
    got = D.collect_table(out)
    ref = R.ref_groupby_sum(a, "k", ["v"])
    o = np.argsort(got["k"])
    np.testing.assert_array_equal(got["k"][o], ref["k"])
    np.testing.assert_allclose(got["v"][o], ref["v"], rtol=1e-5, atol=1e-5)


def test_shuffle_four_ranks_conserves_and_places_rows(four_ranks):
    rng = np.random.default_rng(7)
    data = {"k": rng.integers(0, 1000, 800).astype(np.int32)}
    t = D.shard_table(four_ranks, data, 400)
    target = torch.cat([torch.where(s.valid_mask(), s.columns["k"] % 4, 0)
                        for s in t.shards]).to(torch.int32)
    out, ovf = D.make_shuffle(four_ranks)(t, target)
    assert not bool(ovf)
    got = D.collect_table(out)
    assert sorted(got["k"].tolist()) == sorted(data["k"].tolist())
    for r, s in enumerate(out.shards):
        assert (s.to_numpy()["k"] % 4 == r).all()


def test_shuffle_overflow_is_observable_four_ranks(four_ranks):
    """Every row targets rank 0 and slack=1.0 gives send_cap 108 < 200."""
    data = {"k": np.zeros(800, np.int32),
            "v": np.random.default_rng(11).normal(size=800).astype(np.float32)}
    t = D.shard_table(four_ranks, data, 400)
    zeros = torch.zeros(4 * 400, dtype=torch.int32)
    _, ovf = D.make_shuffle(four_ranks, slack=1.0)(t, zeros)
    assert bool(ovf)
    with pytest.raises(D.ShuffleOverflow) as e:
        D.make_shuffle(four_ranks, slack=1.0, on_overflow="raise")(t, zeros)
    assert e.value.op == "shuffle" and e.value.slack == 1.0
    with pytest.raises(D.ShuffleOverflow) as e:
        D.make_dist_join(four_ranks, "k", slack=1.0, on_overflow="raise")(t, t)
    assert e.value.op == "dist_join"
    _, ovf = D.make_shuffle(four_ranks, slack=4.0, on_overflow="raise")(
        t, zeros)
    assert not bool(ovf)
    with pytest.raises(ValueError):
        D.make_shuffle(four_ranks, on_overflow="ignore")


def test_dist_table_public_layout_is_rank_major(four_ranks):
    a, _ = _dist_data(n=10)
    t = D.shard_table(four_ranks, a, 5)
    assert isinstance(t, DistTable) and t.n_parts == 4
    assert tuple(t.columns["k"].shape) == (20,)
    np.testing.assert_array_equal(t.nrows.numpy(), [3, 3, 2, 2])
    back = from_reference(*to_reference(t), logical_devices(4, CPU))
    for s, b in zip(t.shards, back.shards, strict=True):
        assert torch.equal(s.columns["k"], b.columns["k"])
        assert int(s.nrows) == int(b.nrows)


_JAX_P4 = r"""
import numpy as np, jax
from repro.core import build_communicator
from repro.dataframe import ops_dist as D
rng = np.random.default_rng(42)
a = {"k": rng.integers(0, 300, 1200).astype(np.int32),
     "v": rng.normal(size=1200).astype(np.float32)}
b = {"k": rng.integers(0, 300, 900).astype(np.int32),
     "w": rng.normal(size=900).astype(np.float32)}
comm = build_communicator(jax.devices(), axes=("df",))
ta, tb = D.shard_table(comm, a, 700), D.shard_table(comm, b, 700)
outs = {"sort": D.make_dist_sort(comm.mesh, "k")(ta),
        "join": D.make_dist_join(comm.mesh, "k", out_factor=8.0)(ta, tb),
        "groupby": D.make_dist_groupby_sum(comm.mesh, "k", ["v"])(ta)}
arrs = {}
for name, (t, ovf) in outs.items():
    arrs[name + "/nrows"] = np.asarray(t.nrows)
    arrs[name + "/ovf"] = np.asarray(ovf)
    for k, v in t.columns.items():
        arrs[name + "/" + k] = np.asarray(v)
np.savez(OUT, **arrs)
print("P4_OK")
"""


@pytest.mark.integration
def test_dist_ops_four_ranks_match_jax_four_host_devices(tmp_path,
                                                         four_ranks):
    """Per-rank outputs at P = 4 against the JAX package on 4 host
    devices: sort and join bit-exact, groupby sums at rtol=1e-6."""
    out = tmp_path / "jax_p4.npz"
    assert "P4_OK" in run_with_devices(f"OUT = {str(out)!r}\n" + _JAX_P4,
                                       n_devices=4)
    got = np.load(out)
    a, b = _dist_data()
    ta = D.shard_table(four_ranks, a, 700)
    tb = D.shard_table(four_ranks, b, 700)
    ports = {"sort": D.make_dist_sort(four_ranks, "k")(ta),
             "join": D.make_dist_join(four_ranks, "k", out_factor=8.0)(ta, tb),
             "groupby": D.make_dist_groupby_sum(four_ranks, "k", ["v"])(ta)}
    for name, (t, ovf) in ports.items():
        cols = {k.split("/", 1)[1]: got[k] for k in got.files
                if k.startswith(name + "/") and k.split("/")[1]
                not in ("nrows", "ovf")}
        jt = JTable(columns=cols, nrows=got[name + "/nrows"])
        assert bool(ovf) == bool(got[name + "/ovf"])
        _assert_same_dist(jt, t, float_cols=("v",) if name == "groupby"
                          else ())


# ---------------------------------------------------------------------------
# float keys: XLA's saturating float -> uint32 convert in hash_key, and
# searchsorted in JAX's order (NaN above +inf and equal to itself, -0.0 equal
# to +0.0) in join_inner, range_partition and the dist sort's splitters
# ---------------------------------------------------------------------------
_F32_EDGES = np.asarray([-1, -1.5, 0, -0.0, 0.5, 1.5, 2**31, 2**32 - 256,
                         2**32, 2**32 + 5, 1e20, -1e20, np.inf, -np.inf,
                         np.nan, -np.nan], np.float32)


def _hash_keys(kind):
    rng = np.random.default_rng(5)
    if kind == "f32_edges":
        return _F32_EDGES
    if kind == "f32_random":        # signs, fractions and 2^32 overflow
        return (rng.standard_normal(3000) * 10.0 ** rng.integers(
            0, 12, 3000)).astype(np.float32)
    return rng.integers(-2**31, 2**31 - 1, 3000, dtype=np.int32)


@pytest.mark.parametrize("kind", ["f32_edges", "f32_random", "i32_random"])
def test_hash_key_matches_jax_on_float_and_int_keys(kind):
    keys = _hash_keys(kind)
    want = np.asarray(JL.hash_key(jnp.asarray(keys))).astype(np.int64)
    got = L.hash_key(torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(), want)
    jt, pt = _both({"k": keys}, capacity=len(keys) + 3)
    for n_parts in (2, 3, 4):
        np.testing.assert_array_equal(
            partition.hash_partition(pt, "k", n_parts).numpy(),
            np.asarray(jax_partition.hash_partition(jt, "k", n_parts)))


def test_hash_partition_sends_negative_float_keys_where_jax_does():
    """Keys [-1, -2, 3, -4] at P = 2: JAX sends three rows to rank 0."""
    jt, pt = _both({"k": np.asarray([-1, -2, 3, -4], np.float32)})
    got = partition.hash_partition(pt, "k", 2).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_partition.hash_partition(jt, "k", 2)))
    assert np.bincount(got, minlength=2).tolist() == [3, 1]


def test_search_image_orders_floats_as_jax_searchsorted():
    x = torch.tensor([-np.inf, -1e30, -1.5, -0.0, 0.0, 1e-45, 1.5, np.inf,
                      np.nan, -np.nan], dtype=torch.float32)
    img = L.search_image(x)
    assert img.dtype == torch.int32
    assert bool((img[1:8] > img[:7]).all() | (img[3] == img[4]))
    assert int(img[3]) == int(img[4]) and int(img[8]) == int(img[9]) > \
        int(img[7])
    for dt in (torch.float64, torch.bfloat16):
        assert torch.equal(torch.argsort(L.search_image(x.to(dt)),
                                         stable=True),
                           torch.argsort(img, stable=True))
    ints = torch.tensor([3, -1], dtype=torch.int32)
    assert L.search_image(ints) is ints             # integers bypass it


@pytest.mark.parametrize("lk,rk", [
    ([1.0], [np.nan, 1.0]),
    ([np.nan], [np.nan]),
    ([1.0, 2.0], [np.nan, 2.0, 1.0]),
    ([-0.0, np.nan, 3.0, np.inf], [0.0, np.nan, np.inf, -np.inf, np.nan]),
])
def test_join_inner_matches_jax_on_nan_keys(lk, rk):
    """Full tables (no padding rows), so the reference's padded-NaN
    behaviour of sort_by does not arise."""
    left = {"k": np.asarray(lk, np.float32),
            "v": np.arange(len(lk), dtype=np.float32)}
    right = {"k": np.asarray(rk, np.float32),
             "w": np.arange(len(rk), dtype=np.float32) + 100}
    jl, pl = _both(left)
    jr, pr = _both(right)
    jo, jovf = JL.join_inner(jl, jr, "k", 12)
    po, povf = L.join_inner(pl, pr, "k", 12)
    _assert_same_table(jo, po)
    assert bool(povf) == bool(jovf)


_NAN_SORT_KEYS = np.asarray([np.nan, 1, np.nan, 2, 5, np.nan, np.nan, 3],
                            np.float32)


@pytest.mark.parametrize("splitters", [[2.0], [3.0, np.nan], [np.nan],
                                       [-0.0, 2.0, np.inf]])
def test_range_partition_matches_jax_on_nan_keys(splitters):
    keys = np.concatenate([_NAN_SORT_KEYS, [0.0, -0.0, np.inf, -np.inf]]
                          ).astype(np.float32)
    jt, pt = _both({"k": keys}, capacity=len(keys) + 2)
    sp = np.asarray(splitters, np.float32)
    np.testing.assert_array_equal(
        partition.range_partition(pt, "k", torch.from_numpy(sp)).numpy(),
        np.asarray(jax_partition.range_partition(jt, "k", jnp.asarray(sp))))


_JAX_P2_FLOAT_KEYS = r"""
import numpy as np, jax
from repro.core import build_communicator
from repro.dataframe import ops_dist as D
comm = build_communicator(jax.devices(), axes=("df",))
neg = np.asarray([-1, -2, 3, -4], np.float32)
a = {"k": neg, "v": np.arange(4, dtype=np.float32)}
b = {"k": neg, "w": np.arange(4, dtype=np.float32) + 100}
s = {"k": np.asarray([np.nan, 1, np.nan, 2, 5, np.nan, np.nan, 3],
                     np.float32), "v": np.arange(8, dtype=np.float32)}
outs = {"join": D.make_dist_join(comm.mesh, "k")(D.shard_table(comm, a, 4),
                                                 D.shard_table(comm, b, 4)),
        "groupby": D.make_dist_groupby_sum(comm.mesh, "k", ["v"])(
            D.shard_table(comm, a, 4)),
        "sort": D.make_dist_sort(comm.mesh, "k")(D.shard_table(comm, s, 4))}
arrs = {}
for name, (t, ovf) in outs.items():
    arrs[name + "/nrows"] = np.asarray(t.nrows)
    arrs[name + "/ovf"] = np.asarray(ovf)
    for k, v in t.columns.items():
        arrs[name + "/" + k] = np.asarray(v)
np.savez(OUT, **arrs)
print("P2_OK")
"""


@pytest.fixture(scope="module")
def jax_p2_float_keys(tmp_path_factory):
    """The JAX package's dist join, groupby-sum and sort of float keys on 2
    host devices (a fresh interpreter: the device count is fixed at JAX's
    start)."""
    out = tmp_path_factory.mktemp("p2") / "jax_p2.npz"
    assert "P2_OK" in run_with_devices(
        f"OUT = {str(out)!r}\n" + _JAX_P2_FLOAT_KEYS, n_devices=2)
    return dict(np.load(out))


@pytest.mark.parametrize("op", ["join", "groupby", "sort"])
def test_dist_ops_two_ranks_match_jax_on_float_keys(op, jax_p2_float_keys):
    """Per-rank row counts and rows equal JAX's at P = 2: join and groupby
    hash keys [-1, -2, 3, -4] (float32; JAX puts 3 rows on rank 0), the
    sort searches splitters among NaN keys (JAX: 4 rows a rank)."""
    comm2 = build_communicator(logical_devices(2, CPU))
    neg = np.asarray([-1, -2, 3, -4], np.float32)
    a = {"k": neg, "v": np.arange(4, dtype=np.float32)}
    if op == "join":
        b = {"k": neg, "w": np.arange(4, dtype=np.float32) + 100}
        t, ovf = D.make_dist_join(comm2, "k")(D.shard_table(comm2, a, 4),
                                              D.shard_table(comm2, b, 4))
    elif op == "groupby":
        t, ovf = D.make_dist_groupby_sum(comm2, "k", ["v"])(
            D.shard_table(comm2, a, 4))
    else:
        s = {"k": _NAN_SORT_KEYS, "v": np.arange(8, dtype=np.float32)}
        t, ovf = D.make_dist_sort(comm2, "k")(D.shard_table(comm2, s, 4))
    got = jax_p2_float_keys
    cols = {k.split("/", 1)[1]: got[k] for k in got
            if k.startswith(op + "/") and k.split("/")[1]
            not in ("nrows", "ovf")}
    jt = JTable(columns=cols, nrows=got[op + "/nrows"])
    assert bool(ovf) == bool(got[op + "/ovf"])
    _assert_same_dist(jt, t)
    want_nrows = {"join": [3, 1], "groupby": [3, 1], "sort": [4, 4]}[op]
    assert to_reference(t)[1].tolist() == want_nrows
