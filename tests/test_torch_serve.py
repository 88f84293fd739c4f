"""The port's serving engines against the JAX package's oracle, on the CPU.

Both packages hold the same float32 weights (the JAX ``init`` params carried
across by ``params_from_jax``).  Every generated stream must equal, token
for token, the port's ``greedy_reference`` AND the JAX package's: the
static engine over length groups, the continuous engine under staggered
admission, mixed budgets and eviction, and ``ServeDriver`` running prefill
and decode as scheduler tasks beside ETL tasks.  The dense family and the
SSM family (falcon-mamba-7b) and the MoE family (qwen2-moe-a2.7b, and
llama4-maverick in two superblocks of a dense and an MoE layer) all run
the engines, and so do the VLM family (internvl2-1b: stub patch
embeddings before each prompt, positions offset by n_patches) and the
audio family (whisper-medium: stub frames, the cross-attention caches
``xk``/``xv`` in the slot cache).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs, reduced
from repro.models import get_model as jax_get_model
from repro.serve.engine import greedy_reference as jax_greedy_reference

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core import (ResourceManager, SchedulerSession,
                              TaskDescription, TaskState, ThreadExecutor)
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (AutoscaleConfig, ContinuousEngine, Request,
                               ServeAutoscaler, ServeDriver, ServeEngine,
                               greedy_reference)

DENSE = [a for a in list_archs() if get_config(a).family == "dense"]
MOE = [a for a in list_archs() if get_config(a).family == "moe"]
SSM = "falcon-mamba-7b"
VLM, AUDIO = "internvl2-1b", "whisper-medium"


@pytest.fixture(autouse=True, scope="module")
def _jax_oracle_forward_jitted():
    """The JAX greedy_reference runs its model's forward once per token, at
    a new length each time.  Run eagerly, every op of that forward compiles
    anew for each length; under jax.jit the whole forward compiles once per
    length, several times faster.  It is the same function, so the JAX
    oracle here is the JAX package's greedy_reference over a jitted
    forward."""
    import types

    import repro.serve.engine as jax_engine
    apis = {}

    def get_model(cfg):
        if cfg not in apis:
            api = jax_get_model(cfg)
            apis[cfg] = api._replace(
                forward=jax.jit(api.forward, static_argnums=1))
        return apis[cfg]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "registry",
                   types.SimpleNamespace(get_model=get_model))
        yield


def _make(arch, seed=0):
    n = 4 if arch in MOE else 2         # llama4: 2 superblocks of period 2
    jcfg = dataclasses.replace(reduced(get_config(arch)), n_layers=n)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), n_layers=n)
    params = jax_get_model(jcfg).init(jax.random.key(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return (jcfg, params), (tcfg, model)


def _reqs(cfg, spec, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, L)
                    .astype(np.int32), max_new_tokens=m, uid=i)
            for i, (L, m) in enumerate(spec)]


def _check_oracles(jax_side, port_side, reqs, out):
    """Port tokens == port greedy_reference == JAX greedy_reference."""
    (jcfg, params), (tcfg, model) = jax_side, port_side
    for r in reqs:
        ref = greedy_reference(tcfg, model, r.prompt, r.max_new_tokens)
        jref = jax_greedy_reference(jcfg, params, r.prompt, r.max_new_tokens)
        np.testing.assert_array_equal(ref, jref)
        np.testing.assert_array_equal(out[r.uid], ref)


@pytest.mark.parametrize("arch", DENSE + [SSM] + MOE + [VLM, AUDIO])
def test_batched_generation_matches_oracle(arch):
    jax_side, (cfg, model) = _make(arch)
    eng = ServeEngine(cfg, model, max_batch=4, max_seq=32)
    reqs = [Request(prompt=np.asarray([5, 7, 9], np.int32), max_new_tokens=4,
                    uid=1),
            Request(prompt=np.asarray([3, 2, 1], np.int32), max_new_tokens=4,
                    uid=2),
            Request(prompt=np.asarray([11, 4], np.int32), max_new_tokens=3,
                    uid=3)]
    out = eng.run_requests(reqs)
    _check_oracles(jax_side, (cfg, model), reqs, out)


def test_mixed_lengths_grouped():
    jax_side, (cfg, model) = _make("granite-3-8b", seed=1)
    eng = ServeEngine(cfg, model, max_batch=2, max_seq=24)
    reqs = _reqs(cfg, [(L, 3) for L in [2, 5, 2, 5, 3]])
    out = eng.run_requests(reqs)
    assert set(out) == set(range(5))
    _check_oracles(jax_side, (cfg, model), reqs, out)


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-8b", SSM, *MOE,
                                  VLM, AUDIO])
def test_staggered_admission_matches_oracle(arch):
    """max_batch=2 over 5 mixed-length / mixed-budget requests: requests
    are admitted mid-decode into slots whose neighbour is at a different
    position, and slots are reused across requests."""
    jax_side, (cfg, model) = _make(arch)
    eng = ContinuousEngine(cfg, model, max_batch=2, max_seq=48)
    reqs = _reqs(cfg, [(3, 4), (2, 6), (5, 3), (3, 2), (4, 5)])
    out = eng.run(reqs)
    _check_oracles(jax_side, (cfg, model), reqs, out)
    snap = eng.metrics.snapshot()
    assert snap["serve_admitted"] == 5 and snap["serve_completed"] == 5
    assert snap["serve_slots_active"] == 0 and snap["serve_queue_depth"] == 0


def test_mixed_budgets_and_immediate_completion():
    """A short request finishing early frees its slot while long neighbours
    keep decoding, and a max_new_tokens=1 request completes at admission
    without ever taking a slot."""
    jax_side, (cfg, model) = _make("granite-3-8b")
    eng = ContinuousEngine(cfg, model, max_batch=3, max_seq=32)
    reqs = _reqs(cfg, [(2, 8), (5, 1), (3, 2), (2, 5), (4, 1), (3, 7),
                       (2, 3)])
    out = eng.run(reqs)
    assert set(out) == set(range(7))
    _check_oracles(jax_side, (cfg, model), reqs, out)
    assert eng.metrics.get("serve_decode_steps") >= 7   # longest stream
    assert eng.metrics.get("serve_prefill_tokens") == \
        sum(len(r.prompt) for r in reqs)


def test_admission_never_aliases_the_slot_cache():
    """The port updates the slot cache in place: an admission's own cache
    is left as its prefill wrote it (``insert`` copies it, then the
    admission lets go of it), and a free slot's dummy decode writes only
    that slot's row at position 0."""
    _, (cfg, model) = _make("qwen3-8b")
    eng = ContinuousEngine(cfg, model, max_batch=2, max_seq=16)
    [r] = _reqs(cfg, [(4, 5)])
    adm = eng.prefill_request(r)
    own = dict(adm.cache)
    before = {n: t.clone() for n, t in own.items()}
    slot = eng.insert(adm)
    assert adm.cache is None
    other = 1 - slot
    eng.decode_round()
    for n, t in own.items():
        assert t.data_ptr() != eng.cache[n].data_ptr()
        assert (t == before[n]).all()
        ax = eng._axes[n]
        free = eng.cache[n].narrow(ax, other, 1)
        assert (free.narrow(ax + 1, 1, free.shape[ax + 1] - 1) == 0).all()
        assert (eng.cache[n].narrow(ax, slot, 1).narrow(ax + 1, 0, 5)
                != 0).any(dim=-1).all()


def test_ssm_free_slot_decodes_only_its_own_row():
    """A Mamba cache row holds a whole sequence's state: a free slot's dummy
    decode changes only that slot's row, the live slot's row evolves as
    the same request decoded alone (within f32 rounding: a product over two
    rows need not round as one over one row), and the next admission's
    copy overwrites the dummy state wholesale."""
    _, (cfg, model) = _make(SSM)
    eng = ContinuousEngine(cfg, model, max_batch=2, max_seq=16)
    r1, r2 = _reqs(cfg, [(4, 5), (3, 4)])
    adm = eng.prefill_request(r1)
    alone = {n: t.clone() for n, t in adm.cache.items()}
    slot = eng.insert(adm)
    eng.decode_round()
    eng.api.decode_step(model, cfg, {
        "tokens": torch.tensor([[adm.first_tok]])}, alone)
    for n, ax in eng._axes.items():
        torch.testing.assert_close(eng.cache[n].narrow(ax, slot, 1), alone[n],
                                   rtol=1e-5, atol=1e-5)
        assert (eng.cache[n].narrow(ax, 1 - slot, 1) != 0).any()
    adm2 = eng.prefill_request(r2)
    own2 = dict(adm2.cache)
    assert eng.insert(adm2) == 1 - slot
    for n, ax in eng._axes.items():
        assert torch.equal(eng.cache[n].narrow(ax, 1 - slot, 1), own2[n])


@pytest.mark.parametrize("arch", list_archs())
def test_only_the_ssm_family_declares_a_capturable_decode_step(arch):
    """``ModelApi.decode_graph`` is set by the Mamba1 family alone: every
    other family's step runs eagerly in the continuous engine."""
    from repro_torch.models import get_model
    cfg = t_get_config(arch)
    assert get_model(cfg).decode_graph == (cfg.family == "ssm")


def test_ssm_engine_captures_no_graph_on_the_cpu():
    """On the CPU the Mamba engine runs its decode step eagerly: no graph is
    captured and no round counts as a replay."""
    jax_side, (cfg, model) = _make(SSM)
    eng = ContinuousEngine(cfg, model, max_batch=2, max_seq=32)
    assert eng.api.decode_graph and eng.graph is None
    reqs = _reqs(cfg, [(3, 4), (5, 3), (2, 5)])
    _check_oracles(jax_side, (cfg, model), reqs, eng.run(reqs))
    assert eng.metrics.get("serve_decode_steps") >= 4
    assert eng.metrics.get("serve_decode_graph_replays") == 0
    assert "serve_decode_graph_replays" not in eng.metrics.snapshot()


def test_sequence_budget_eviction():
    jax_side, (cfg, model) = _make("granite-3-8b")
    eng = ContinuousEngine(cfg, model, max_batch=2, max_seq=16)
    reqs = _reqs(cfg, [(3, 4), (8, 12), (2, 3)])   # 8+12 > 16: evicted
    out = eng.run(reqs)
    assert eng.evicted == [1] and 1 not in out
    assert eng.metrics.get("serve_evicted") == 1
    _check_oracles(jax_side, (cfg, model), [reqs[0], reqs[2]], out)


def test_autoscaler_policy_fake_clock():
    """Conditions must SUSTAIN before an action fires, a condition flip
    resets the onset, cooldown separates actions, worker bounds gate, and a
    failing callback is advisory."""
    t = [0.0]
    calls = []
    cfg = AutoscaleConfig(queue_high=3, idle_frac=0.25, sustain_s=1.0,
                          cooldown_s=5.0, min_workers=1, max_workers=2)
    asc = ServeAutoscaler(lambda: calls.append("grow"),
                          lambda: calls.append("retire"),
                          cfg, workers=1, clock=lambda: t[0])
    assert asc.observe(10, 4, 4) is None          # backlog onset
    t[0] = 0.9
    assert asc.observe(0, 0, 4) is None           # flip to idle: reset onset
    t[0] = 1.2
    assert asc.observe(10, 4, 4) is None          # backlog onset again
    t[0] = 1.9
    assert asc.observe(10, 4, 4) is None          # not sustained yet
    t[0] = 2.5
    assert asc.observe(10, 4, 4) == "grow"        # sustained 1.3s >= 1.0
    assert asc.workers == 2 and calls == ["grow"]
    t[0] = 4.0
    assert asc.observe(10, 4, 4) is None          # cooldown + max_workers
    t[0] = 8.0
    assert asc.observe(10, 4, 4) is None          # past cooldown: bound gates
    assert asc.observe(0, 0, 4) is None           # idle onset
    t[0] = 9.5
    assert asc.observe(0, 0, 4) == "retire"       # sustained + past cooldown
    assert asc.workers == 1 and calls == ["grow", "retire"]
    t[0] = 20.0
    assert asc.observe(0, 0, 4) is None           # min_workers gates
    boom = ServeAutoscaler(lambda: 1 / 0, lambda: 1 / 0,
                           dataclasses.replace(cfg, cooldown_s=0.0),
                           workers=1, clock=lambda: t[0])
    boom.observe(10, 4, 4)
    t[0] = 25.0
    assert boom.observe(10, 4, 4) is None and boom.workers == 1


def test_serve_driver_tasks_bit_identical():
    """Prefill and decode as separately-tagged pipelines sharing the
    session with an ETL pipeline; serve telemetry lands in the session's
    trace under ServeDriver's worker id."""
    jax_side, (cfg, model) = _make("qwen3-8b")
    eng = ContinuousEngine(cfg, model, max_batch=2, max_seq=32)
    sess = SchedulerSession(ThreadExecutor(build_comm=False, tick=0.01),
                            ResourceManager(["d0", "d1", "d2"]), tick=0.01)
    sess.submit([TaskDescription(name=f"etl{i}", ranks=1,
                                 fn=lambda c: sum(range(1000)),
                                 tags={"pipeline": "etl"})
                 for i in range(3)])
    driver = ServeDriver(eng, sess, telemetry_interval=0.0)
    reqs = _reqs(cfg, [(3, 4), (2, 6), (4, 3), (3, 1), (2, 2)])
    out = driver.run(reqs, timeout=300)
    _check_oracles(jax_side, (cfg, model), reqs, out)
    rep = sess.drain(timeout=60).close()
    assert all(t.state is TaskState.DONE for t in rep.tasks)
    pipes = {e.pipeline for e in rep.trace if e.kind == "dispatch"}
    assert {"serve-prefill", "serve-decode", "etl"} <= pipes
    tel = [e.data for e in rep.trace if e.kind == "telemetry"
           and e.data.get("worker") == "serve-driver"]
    assert tel and "serve_slot_occupancy" in tel[-1]
    assert tel[-1]["serve_completed"] == len(reqs)


def test_serve_lm_runs_both_acts_on_the_cpu(capsys):
    """``python -m repro_torch.serve_lm --device cpu``: both acts on 4
    logical CPU ranks, each checked against the port's oracle."""
    from repro_torch import serve_lm
    serve_lm.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "[runtime] served 6 requests" in text
    assert "[continuous] 6 requests through pipelines ['etl', " \
           "'serve-decode', 'serve-prefill']" in text


def test_serve_lm_serves_falcon_mamba_on_the_cpu(capsys):
    """``python -m repro_torch.serve_lm --device cpu --arch falcon-mamba-7b``:
    the SSM family through both acts at reduced widths."""
    from repro_torch import serve_lm
    serve_lm.main(["--device", "cpu", "--arch", SSM])
    text = capsys.readouterr().out
    assert "[runtime] served 6 requests" in text
    assert "== oracle" in text and "[continuous] 6 requests" in text


@pytest.mark.parametrize("arch", MOE)
def test_cache_batch_axes_probe_the_superblock_layout(arch):
    """The continuous engine finds the batch axis of the (n_super, period,
    B, smax, K, hd) cache by probing, and its slot cache takes that
    layout."""
    _, (cfg, model) = _make(arch)
    eng = ContinuousEngine(cfg, model, max_batch=3, max_seq=16)
    period = cfg.moe_layer_period
    assert eng._axes == {"k": 2, "v": 2}
    assert tuple(eng.cache["k"].shape) == (
        cfg.n_layers // period, period, 3, 16, cfg.n_kv_heads, cfg.head_dim)


def test_serve_lm_serves_qwen2_moe_on_the_cpu(capsys):
    """``python -m repro_torch.serve_lm --device cpu --arch
    qwen2-moe-a2.7b``: the MoE family through both acts at reduced
    widths."""
    from repro_torch import serve_lm
    serve_lm.main(["--device", "cpu", "--arch", MOE[0]])
    text = capsys.readouterr().out
    assert "[runtime] served 6 requests" in text
    assert "== oracle" in text and "[continuous] 6 requests" in text


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_serve_lm_serves_the_vlm_and_audio_families_on_the_cpu(arch, capsys):
    """``python -m repro_torch.serve_lm --device cpu --arch internvl2-1b``
    (and ``whisper-medium``): both acts at reduced widths, each checked
    against the port's oracle."""
    from repro_torch import serve_lm
    serve_lm.main(["--device", "cpu", "--arch", arch])
    text = capsys.readouterr().out
    assert "[runtime] served 6 requests" in text
    assert "== oracle" in text and "[continuous] 6 requests" in text
