"""The port's out-of-core shuffle against the JAX package's.

``radix_bucket`` must cut the same chunks as the JAX version (whose Pallas
kernel runs in interpret mode here); the spill buffer and the streaming
merges are copies and are held to the JAX package's own unit cases; the
sort and join tasks must give the same summaries as the JAX tasks on the
same spec, with and without spilling.
"""
import numpy as np
import pytest

from repro.dataframe import shuffle as JS
from repro_torch.dataframe.shuffle import (
    SpillBuffer, _gen_part, hash32, join_task, merge_join_sorted,
    parse_budget, radix_bucket, sort_task,
)

CPU = "cpu"


class _LocalComm:
    """Bare single-part comm stand-in (no executor)."""
    spills = 0


@pytest.mark.parametrize("n,n_buckets", [(3000, 5), (777, 1), (64, 9)])
def test_radix_bucket_matches_jax_chunk_for_chunk(n, n_buckets):
    rng = np.random.default_rng(n)
    cols = {"key": rng.integers(0, 97, n, dtype=np.int32),
            "v0": rng.integers(0, 1 << 30, n, dtype=np.int64)}
    tgt = (hash32(cols["key"]) % np.uint32(n_buckets)).astype(np.int32)
    chunks, hist = radix_bucket(cols, tgt, n_buckets, device=CPU,
                                verify=True)
    jchunks, jhist = JS.radix_bucket(cols, tgt, n_buckets, block=256,
                                     interpret=True)
    np.testing.assert_array_equal(hist, jhist)
    assert hist.dtype == jhist.dtype
    assert len(chunks) == len(jchunks) == n_buckets
    for c, jc in zip(chunks, jchunks, strict=True):
        assert set(c) == set(jc)
        for k in c:
            assert c[k].dtype == jc[k].dtype
            np.testing.assert_array_equal(c[k], jc[k])


def test_radix_bucket_empty_input():
    chunks, hist = radix_bucket({"key": np.zeros(0, np.int32)},
                                np.zeros(0, np.int32), 4, device=CPU)
    assert len(chunks) == 4 and all(len(c["key"]) == 0 for c in chunks)
    assert list(hist) == [0, 0, 0, 0]


def test_hash32_and_parse_budget_match_jax():
    k = np.random.default_rng(3).integers(-2**31, 2**31 - 1, 4000,
                                          dtype=np.int32)
    np.testing.assert_array_equal(hash32(k), JS.hash32(k))
    for s in ("32m", "256K", "1g", "12345", None, "", 77):
        assert parse_budget(s) == JS.parse_budget(s)


def test_spillbuffer_threshold_crossing(tmp_path):
    buf = SpillBuffer(10_000, "key", spill_dir=str(tmp_path))
    small = {"key": np.arange(100, dtype=np.int32)}          # 400 B
    buf.add(small)
    assert buf.spills == 0 and len(list(tmp_path.iterdir())) == 0
    buf.add({"key": np.arange(5000, dtype=np.int32)})        # 20 KB
    assert buf.spills == 1 and len(list(tmp_path.iterdir())) == 1
    buf.add(small)
    assert buf.spills == 1
    buf.close()


def test_spillbuffer_merge_matches_jax_merge():
    """Both packages' buffers, fed the same spilled runs, stream the same
    chunks."""
    rng = np.random.default_rng(1)
    runs = [{"key": rng.integers(0, 500, 1500, dtype=np.int32),
             "v0": rng.integers(0, 9, 1500, dtype=np.int64)}
            for _ in range(4)]
    ours, theirs = SpillBuffer(0, "key"), JS.SpillBuffer(0, "key")
    for r in runs:
        ours.add(r)
        theirs.add(r)
    assert ours.spills == theirs.spills == 4
    got = list(ours.merge_sorted(chunk_rows=113))
    want = list(theirs.merge_sorted(chunk_rows=113))
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(
        np.concatenate([c["key"] for c in got]),
        np.sort(np.concatenate([r["key"] for r in runs])))
    ours.close()
    theirs.close()


def test_merge_join_duplicates_across_chunk_boundaries():
    rng = np.random.default_rng(2)
    lk = np.sort(rng.integers(0, 12, 400, dtype=np.int32))
    rk = np.sort(rng.integers(0, 12, 300, dtype=np.int32))
    lv = rng.integers(0, 1000, 400, dtype=np.int64)
    rv = rng.integers(0, 1000, 300, dtype=np.int64)

    def chunked(d, size):
        for i in range(0, len(d["key"]), size):
            yield {k: v[i:i + size] for k, v in d.items()}

    out = list(merge_join_sorted(chunked({"key": lk, "v0": lv}, 7),
                                 chunked({"key": rk, "w0": rv}, 5), "key"))
    ref = list(JS.merge_join_sorted(chunked({"key": lk, "v0": lv}, 7),
                                    chunked({"key": rk, "w0": rv}, 5), "key"))
    assert len(out) == len(ref)
    for o, r in zip(out, ref, strict=True):
        for k in r:
            np.testing.assert_array_equal(o[k], r[k])
    got = sorted(zip(np.concatenate([c["key"] for c in out]).tolist(),
                     np.concatenate([c["v0"] for c in out]).tolist(),
                     np.concatenate([c["w0"] for c in out]).tolist()))
    assert got == sorted((int(a), int(lv[i]), int(rv[j]))
                         for i, a in enumerate(lk)
                         for j, b in enumerate(rk) if a == b)


def test_merge_join_disjoint_sides_empty():
    def one(d):
        yield d
    out = list(merge_join_sorted(
        one({"key": np.array([1, 2], np.int32),
             "v0": np.array([5, 6], np.int64)}),
        one({"key": np.array([3, 4], np.int32),
             "w0": np.array([7, 8], np.int64)}), "key"))
    assert out == []


def test_sort_task_spill_vs_no_spill_identical_and_equal_to_jax():
    base = {"rows_per_part": 6000, "seed": 9, "collect": True,
            "verify_kernel": True, "device": CPU}
    spilled = sort_task(_LocalComm(), {**base, "budget": 4_000,
                                       "chunk_rows": 333})
    resident = sort_task(_LocalComm(), {**base, "budget": 1 << 30})
    assert spilled["spills"] > 0 and resident["spills"] == 0
    assert spilled["sorted"] and resident["sorted"]
    assert spilled["n"] == resident["n"] == 6000
    assert spilled["key_sum"] == resident["key_sum"]
    np.testing.assert_array_equal(spilled["rows"]["key"],
                                  resident["rows"]["key"])
    np.testing.assert_array_equal(spilled["rows"]["key"],
                                  np.sort(_gen_part(base, 0)["key"]))
    jspec = {k: v for k, v in base.items() if k != "device"}
    ref = JS.sort_task(_LocalComm(), {**jspec, "budget": 4_000,
                                      "chunk_rows": 333})
    for k in ("n", "key_sum", "sorted", "spills"):
        assert spilled[k] == ref[k], k
    for k in ref["rows"]:
        np.testing.assert_array_equal(spilled["rows"][k], ref["rows"][k])


def test_join_task_spill_vs_no_spill_identical_and_equal_to_jax():
    base = {"rows_per_part": 4000, "key_range": 700, "seed": 9,
            "verify_kernel": True, "device": CPU}
    spilled = join_task(_LocalComm(), {**base, "budget": 3_000,
                                       "chunk_rows": 257})
    resident = join_task(_LocalComm(), {**base, "budget": 1 << 30})
    assert spilled["spills"] > 0 and resident["spills"] == 0
    jspec = {k: v for k, v in base.items() if k != "device"}
    ref = JS.join_task(_LocalComm(), {**jspec, "budget": 3_000,
                                      "chunk_rows": 257})
    for k in ("n", "key_sum", "v_sum", "w_sum"):
        assert spilled[k] == resident[k] == ref[k], k
    assert spilled["spills"] == ref["spills"]


def test_budget_env_knob(monkeypatch):
    monkeypatch.setenv("REPRO_SHUFFLE_BUDGET", "2k")
    spec = {"rows_per_part": 3000, "seed": 4, "device": CPU}
    out = sort_task(_LocalComm(), spec)
    assert out["spills"] > 0 and out["sorted"]
    monkeypatch.setenv("REPRO_SHUFFLE_BUDGET", "1g")
    assert sort_task(_LocalComm(), spec)["spills"] == 0


def test_task_device_defaults_to_the_card():
    """Without a device in the spec or on the comm, bucketing asks for the
    card and raises where there is none (no silent CPU fallback)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sort_task(_LocalComm(), {"rows_per_part": 100, "seed": 1})


@pytest.mark.parametrize("nrows", [5, [3, 0, 2, 4]])
def test_from_reference_to_reference_round_trip(nrows):
    """The JAX package's table layout (padded columns; rank-major with a
    (P,) nrows when distributed) survives a trip through the port."""
    from repro_torch.core import logical_devices
    from repro_torch.dataframe.table import from_reference, to_reference
    rng = np.random.default_rng(0)
    size = 8 if np.ndim(nrows) == 0 else 4 * 6
    cols = {"k": rng.integers(-9, 9, size, dtype=np.int32),
            "v": rng.normal(size=size).astype(np.float32),
            "m": rng.normal(size=(size, 3))}
    devices = logical_devices(1 if np.ndim(nrows) == 0 else 4, CPU)
    table = from_reference(cols, np.asarray(nrows, np.int32), devices)
    back, back_n = to_reference(table)
    np.testing.assert_array_equal(back_n, np.asarray(nrows, np.int32))
    for k, v in cols.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
