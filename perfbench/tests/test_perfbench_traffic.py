"""The traffic generator: a seed repeats its work exactly, and every seed
gets the same work in another order."""
import numpy as np
import pytest

from yardstick import traffic

MIX = {"kind": "requests", "loop": "closed", "clients": 32,
       "prompt": {"dist": "loguniform", "min": 256, "max": 4096},
       "answer": {"dist": "uniform", "min": 4, "max": 16}, "block": 64}
BIG = 2 ** 31 + 12345      # seeds beyond 32 signed bits are allowed


def _take(seed, n=200, mix=MIX):
    r = traffic.Requests(mix, seed, 65024)
    return [r.next() for _ in range(n)]


def test_a_seed_repeats_exactly():
    a, b = _take(BIG), _take(BIG)
    for x, y in zip(a, b, strict=True):
        assert np.array_equal(x.prompt, y.prompt)
        assert x.answer_len == y.answer_len
    assert traffic.checked_indices({"checked": 3, "checked_among": 16},
                                   BIG) == \
        traffic.checked_indices({"checked": 3, "checked_among": 16}, BIG)


def test_seeds_share_the_work_of_each_block():
    a, b = _take(1, 128), _take(BIG, 128)
    for blk in (slice(0, 64), slice(64, 128)):
        la = sorted(len(x.prompt) for x in a[blk])
        lb = sorted(len(x.prompt) for x in b[blk])
        assert la == lb
        assert sorted(x.answer_len for x in a[blk]) == \
            sorted(x.answer_len for x in b[blk])
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in b]


def test_lengths_follow_the_mix():
    q = traffic.quantiles(MIX["prompt"], 64)
    assert q.min() >= 256 and q.max() <= 4096
    assert 1200 < traffic.mean_length(MIX["prompt"]) < 1500   # 3840 / ln 16
    ans = traffic.quantiles(MIX["answer"], 65)
    assert set(ans.tolist()) == set(range(4, 17))


def test_only_the_closed_loop_has_a_generator():
    with pytest.raises(ValueError, match="loop"):
        traffic.Requests(dict(MIX, loop="open"), 3, 100)
