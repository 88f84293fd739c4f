"""A run drives the whole of a cell (on the CPU, at a tiny size, past the
harness's look for a card) with the timed path broken underneath, and its
comparison must come out not correct: once for each fault the cell can
have."""
import time

import pytest
import torch

from conftest import tiny

from yardstick import runner


def _correct(workload: str) -> bool:
    out = runner.run_cell(workload, 77, 1.5, False, time.perf_counter(),
                          device="cpu", overrides=tiny(workload))
    return out["correct"]


# -- the dataframe cells -----------------------------------------------------
def _alter_answer(op):
    def fault(orig):
        def broken(*args):
            shards, ovf = orig(*args)
            col = "k" if op == "sort" else "v"
            shards[0].columns[col][0] += 1
            return shards, ovf
        return broken
    return fault


def _drop_half(orig):
    def broken(*args):
        shards, ovf = orig(*args)
        for s in shards:
            s.nrows = s.nrows // 2
        return shards, ovf
    return broken


def _unchanged_sort(orig):
    def broken(shards, key, devices, slack):
        return list(shards), [torch.tensor(False)] * len(shards)
    return broken


DF_FAULTS = {
    "answer_altered": lambda op: _alter_answer(op),
    "half_left_out": lambda op: _drop_half,
    "state_unchanged": lambda op: _unchanged_sort if op == "sort" else None,
}


@pytest.mark.parametrize("op", ["join", "sort"])
@pytest.mark.parametrize("fault", sorted(DF_FAULTS))
def test_dataframe_fault_is_caught(monkeypatch, op, fault):
    from repro_torch.dataframe import ops_dist
    make = DF_FAULTS[fault](op)
    if make is None:
        pytest.skip("a join returning its inputs has another schema")
    name = "_dist_join" if op == "join" else "_dist_sort"
    monkeypatch.setattr(ops_dist, name, make(getattr(ops_dist, name)))
    assert not _correct(f"cylon35m.{op}")


@pytest.mark.parametrize("op", ["join", "sort"])
def test_dataframe_exchange_left_out_is_caught(monkeypatch, op):
    from repro_torch.dataframe import comm

    def no_exchange(xs, devices):
        # each rank keeps what it would have sent
        return [x.to(d) for x, d in zip(xs, devices, strict=True)]

    monkeypatch.setattr(comm, "all_to_all", no_exchange)
    assert not _correct(f"cylon35m.{op}")


# -- the serving cells -------------------------------------------------------
def test_serving_token_altered_is_caught(monkeypatch):
    from repro_torch.serve import continuous
    orig = continuous.ContinuousEngine.prefill_request

    def broken(self, req):
        adm = orig(self, req)
        adm.first_tok = (adm.first_tok + 1) % self.cfg.vocab_size
        return adm

    monkeypatch.setattr(continuous.ContinuousEngine, "prefill_request",
                        broken)
    assert not _correct("falcon-mamba-7b.rag_sat")


def test_serving_state_unchanged_is_caught(monkeypatch):
    from repro_torch.models import ssm
    orig = ssm.mamba1_decode

    def broken(p, x, state, cfg):
        return orig(p, x, {k: v.clone() for k, v in state.items()}, cfg)

    monkeypatch.setattr(ssm, "mamba1_decode", broken)
    assert not _correct("falcon-mamba-7b.rag_sat")


def test_serving_half_the_batch_left_out_is_caught(monkeypatch):
    from repro_torch.models import ssm_lm
    orig = ssm_lm.decode_step

    def broken(params, cfg, batch, cache):
        logits, cache = orig(params, cfg, batch, cache)
        # the first half of the slots get the last slot's logits
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[:half] = logits[-1:]
        return logits, cache

    monkeypatch.setattr(ssm_lm, "decode_step", broken)
    assert not _correct("falcon-mamba-7b.rag_sat")
