"""The one traffic generator.  A traffic mix is a JSON file of parameters
under ``perfbench/traffic/``; this module turns it and a seed into work.

Every seed gets the same work in another order: sizes are taken at
fixed quantiles of their distributions, a block at a time, and the seed only
permutes each block (and draws the token ids).  So two seeds differ in which
request comes when, not in how much there is to do, and a run's totals do
not swing with the seed.

Serving mixes (``"kind": "requests"``)::

    {"kind": "requests", "loop": "closed", "clients": 32,
     "prompt": {"dist": "loguniform", "min": 256, "max": 4096},
     "answer": {"dist": "uniform", "min": 4, "max": 16},
     "block": 64}

The one loop is ``closed``: each of ``clients`` keeps one request in the
system.

Dataframe mixes (``"kind": "ops"``) name the distributed operator each task
runs and how the client submits them::

    {"kind": "ops", "op": "dist_join", "loop": "closed", "ahead": 2,
     "inputs": 2, "checked": 3, "checked_among": 48}
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of a run, from the run's seed (any
    whole number) and the stream's tags."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(subseed(seed, *tags)))


def quantiles(spec: dict, m: int) -> np.ndarray:
    """``m`` values of a length distribution at the quantiles (i + 0.5) / m,
    as integers."""
    u = (np.arange(m) + 0.5) / m
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "loguniform":
        v = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    elif spec["dist"] == "uniform":
        # integers lo..hi, each equally often
        v = lo + np.floor(u * (hi - lo + 1))
    elif spec["dist"] == "fixed":
        v = np.full(m, lo)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


@dataclasses.dataclass
class RequestSpec:
    index: int
    prompt: np.ndarray      # (prompt_len,) int32 token ids
    answer_len: int


class Requests:
    """The endless, seeded stream of a serving mix's requests, in order."""

    def __init__(self, traffic: dict, seed: int, vocab: int,
                 stream: str = "window"):
        if traffic.get("kind") != "requests":
            raise ValueError("not a serving mix")
        if traffic.get("loop") != "closed":
            raise ValueError(f"no generator for the loop "
                             f"{traffic.get('loop')!r}")
        self.t = traffic
        self.seed = seed
        self.vocab = vocab
        self.stream = stream
        self.block = int(traffic.get("block", 64))
        self._prompts = quantiles(traffic["prompt"], self.block)
        self._answers = quantiles(traffic["answer"], self.block)
        self._tok = rng(seed, stream, "tokens")
        self._i = 0
        self._blocks = 0
        self._queue: list = []

    def _fill(self):
        g = rng(self.seed, self.stream, "block", self._blocks)
        self._blocks += 1
        prompts = g.permutation(self._prompts)
        answers = g.permutation(self._answers)
        self._queue.extend(zip(prompts.tolist(), answers.tolist(),
                               strict=True))

    def next(self) -> RequestSpec:
        if not self._queue:
            self._fill()
        p, a = self._queue.pop(0)
        toks = self._tok.integers(0, self.vocab, p, dtype=np.int32)
        spec = RequestSpec(self._i, toks, a)
        self._i += 1
        return spec


def checked_indices(traffic: dict, seed: int) -> set:
    """The window tasks (by index) whose output a run keeps and compares:
    ``checked`` draws among the first ``checked_among``."""
    g = rng(seed, "checked")
    return set(int(i) for i in g.choice(int(traffic["checked_among"]),
                                        int(traffic["checked"]),
                                        replace=False))


def mean_length(spec: dict, m: int = 4096) -> float:
    return float(np.mean(quantiles(spec, m)))
