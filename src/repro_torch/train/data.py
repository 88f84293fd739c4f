"""Data pipeline: the 'analysis pipeline feeding DL' story of the paper.

Two sources, both the JAX package's (``src/repro/train/data.py``):
  * SyntheticCorpus — deterministic zipf-ish token stream (tests, smoke);
    a copy, so one seed gives both packages the same batches.
  * etl_token_batches — runs a real dataframe pipeline (filter -> hash join
    -> sample-sort) on the port's distributed dataframe ops, whose shuffles
    pack through the ``radix_partition`` kernel, and yields training batches
    from the resulting token column, demonstrating ETL -> training handoff
    inside one framework (``python -m repro_torch.train_lm``).  Batches are
    numpy arrays, as the JAX package yields them.
"""
from __future__ import annotations

import numpy as np


class SyntheticCorpus:
    """Deterministic pseudo-corpus with skewed unigram stats + local
    structure (next token correlates with previous), so tiny LMs show a
    decreasing loss."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        # zipf-ish unigram distribution
        ranks = np.arange(1, vocab + 1)
        self.p = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, batch: int, seq: int) -> dict:
        base = self.rng.choice(self.vocab, size=(batch, seq), p=self.p)
        # inject bigram structure: with prob .5, token = prev + 1 (mod V)
        copy = self.rng.random((batch, seq)) < 0.5
        shifted = np.roll(base, 1, axis=1) + 1
        tokens = np.where(copy, shifted % self.vocab, base).astype(np.int32)
        return {"tokens": tokens, "labels": tokens}

    def batches(self, batch: int, seq: int, steps: int):
        for _ in range(steps):
            yield self.batch(batch, seq)


def make_events(n_rows: int, vocab: int, seed: int = 0) -> dict:
    """Raw 'event log' the ETL pipeline cleans: (event_id, doc_id, token,
    quality) rows — heterogeneous analytics input."""
    rng = np.random.default_rng(seed)
    return {
        "event_id": np.arange(n_rows, dtype=np.int32),
        "doc_id": rng.integers(0, max(n_rows // 64, 4), n_rows, dtype=np.int32),
        "token": rng.integers(0, vocab, n_rows, dtype=np.int32),
        "quality": rng.random(n_rows).astype(np.float32),
    }


def etl_token_batches(comm, events: dict, doc_meta: dict, *, batch: int,
                      seq: int, capacity_per_rank: int = 8192):
    """Run the cleaning pipeline on the communicator's ranks and yield
    batches.

    Pipeline (all distributed dataframe ops):
      1. filter: drop rows with quality < 0.2
      2. hash-join events with doc metadata on doc_id (adds doc weight)
      3. sample-sort by (doc_id) so documents are contiguous
      4. emit the token column as (batch, seq) training blocks
    """
    from repro_torch.dataframe import ops_dist as D
    from repro_torch.dataframe import ops_local as L
    from repro_torch.dataframe.table import DistTable

    t = D.shard_table(comm, events, capacity_per_rank)
    meta = D.shard_table(comm, doc_meta, max(len(doc_meta["doc_id"]) //
                                             comm.size + 8, 64))
    # 1. local filter (quality), rank by rank
    t = DistTable([L.filter_rows(s, s.columns["quality"] >= 0.2)
                   for s in t.shards])
    # 2. distributed join with metadata
    t, _ = D.make_dist_join(comm, "doc_id", out_factor=4.0)(t, meta)
    # 3. distributed sort by doc_id
    t, _ = D.make_dist_sort(comm, "doc_id")(t)
    tokens = D.collect_table(t)["token"]

    n_blocks = len(tokens) // (batch * seq)
    for i in range(n_blocks):
        blk = tokens[i * batch * seq:(i + 1) * batch * seq]
        arr = blk.reshape(batch, seq).astype(np.int32)
        yield {"tokens": arr, "labels": arr}
