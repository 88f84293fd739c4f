"""The port's Jamba family (AI21-Jamba2-Mini at reduced widths) against its
plain float32 reference, on the CPU, on seeded random weights.

The reference is the benchmark's own (``perfbench/configs/jamba2-mini.ref.py``:
plain ``torch``, no kernel, cache or batching of the port), given the
port's weights stacked as it keeps them.  The tests hold to it:

* prefill, then decode through a two-slot cache, on logits, in f32 and in
  bf16;
* the expert layer's two shares, experts [0, 8) and [8, 16), summed, to the
  uncut layer;
* the dropless dispatch, where a capacity of 1.25 would drop pairs;
* the Mamba1 mixer norms to a hand-written formula;

and show the other families untouched: falcon-mamba's block has no norms,
the capacity dispatch still renormalises its gates, attention still
rotates.  The serving tier serves Jamba through ``ServeDriver``, counts the
held pairs and records the ``moe`` spans; neither a finished prefill task
nor an inserted admission keeps the single-slot cache.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, reduced
from repro_torch.configs.jamba2_mini import CONFIG, REDUCED
from repro_torch.core import ResourceManager, SchedulerSession, ThreadExecutor
from repro_torch.models import attention, get_model, moe, ssm
from repro_torch.models.layers import apply_rope, rope_sincos
from repro_torch.serve import (ContinuousEngine, Request, ServeDriver,
                               greedy_reference)

REF_FILE = (Path(__file__).resolve().parents[1] / "perfbench" / "configs"
            / "jamba2-mini.ref.py")


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("jamba2_mini_ref", REF_FILE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_cfg(c) -> dict:
    """The reference's configuration (the published names) of a port
    ``JambaConfig``."""
    return {"hidden_size": c.d_model, "num_attention_heads": c.n_heads,
            "num_key_value_heads": c.n_kv_heads, "mamba_expand": c.ssm_expand,
            "mamba_d_state": c.ssm_state, "mamba_dt_rank": c.dt_rank,
            "mamba_d_conv": c.ssm_conv, "intermediate_size": c.d_ff,
            "num_hidden_layers": c.n_layers, "vocab_size": c.vocab_size,
            "num_experts": c.n_experts,
            "published_num_experts": c.n_router_experts,
            "num_experts_per_tok": c.top_k, "rms_norm_eps": c.norm_eps,
            "attn_layer_period": c.attn_layer_period,
            "attn_layer_offset": c.attn_layer_offset,
            "expert_layer_period": c.expert_layer_period,
            "expert_layer_offset": c.expert_layer_offset,
            "held_experts": [c.first_expert, c.first_expert + c.n_experts]}


def ref_weights(model) -> dict:
    """The port model's weights in the reference's layout: each kind of
    layer's weights stacked in layer order."""
    stacks = {"mamba": [], "attn": [], "mlp": [], "moe": []}
    for layer in model.layers:
        stacks["attn" if layer.attention else "mamba"].append(layer.mixer)
        stacks["moe" if layer.experts else "mlp"].append(layer.ffn)
    w = {kind: {k: torch.stack([g[k].detach() for g in groups])
                for k in groups[0]}
         for kind, groups in stacks.items()}
    w.update(embedding=model.embed["embedding"].detach(),
             lm_head=model.embed["lm_head"].detach(),
             final_norm=model.final_norm.detach())
    return w


def _model(cfg=REDUCED, seed=0):
    return get_model(cfg).init(torch.Generator().manual_seed(seed), cfg)


def test_config_is_the_published_share():
    c = CONFIG
    assert (c.n_layers, c.d_model, c.vocab_size, c.n_heads, c.n_kv_heads,
            c.head_dim, c.d_ff) == (32, 4096, 65536, 32, 8, 128, 14336)
    assert (c.d_inner, c.ssm_state, c.ssm_conv, c.dt_rank) == \
        (8192, 16, 4, 256)
    assert [i for i in range(32) if c.is_attn_layer(i)] == [4, 12, 20, 28]
    assert [i for i in range(32) if c.is_moe_layer(i)] == \
        list(range(1, 32, 2))
    assert (c.n_router_experts, c.n_experts, c.first_expert, c.top_k) == \
        (16, 8, 0, 2)
    assert not c.tie_embeddings and c.norm_eps == 1e-6
    assert c.param_count() == 29_021_745_024
    assert REDUCED.n_layers == 8 and REDUCED.n_router_experts == 16


def test_meta_model_holds_the_counted_parameters():
    from repro_torch.models.registry import meta_model
    model = meta_model(CONFIG)
    assert sum(p.numel() for p in model.parameters()) == CONFIG.param_count()
    moe_layer = model.layers[1].ffn
    assert tuple(moe_layer["router"].shape) == (4096, 16)
    assert moe_layer["router"].dtype == torch.float32
    assert tuple(moe_layer["wg"].shape) == (8, 4096, 14336)
    assert set(model.layers[0].mixer) >= {"dt_norm", "B_norm", "C_norm"}


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
# f32: both sides compute the same products in f32 in other orders (the
# grouped products, the batched scan against the step-by-step one): a few
# ulps of the logits, whose spread is ~1 here; a missing norm, a wrong gate
# or a dropped pair moves them by 0.1 or more.  bf16: the port rounds every
# activation to bf16 (2^-9 relative) at each of ~12 products a layer over
# 8 layers, and decodes on bf16 caches, while the reference stays f32 on the
# same bf16 weights: the port's plain bf16 forward itself lies up to 0.27
# from the reference at these widths (seed 0), and its prefill and decode
# up to 0.29.  0.5, half the logits' spread, holds that with room and still
# fails a decode that loses the Mamba states its prefill left (3.0 and
# more); the f32 case holds the KV cache (losing it moves the logits 0.35).
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (0.5, 0.0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_the_reference(ref, dtype):
    cfg = dataclasses.replace(REDUCED, dtype=dtype)
    model = _model(cfg)
    api = get_model(cfg)
    w = ref_weights(model)
    g = torch.Generator().manual_seed(5)
    seqs = [torch.randint(0, cfg.vocab_size, (n,), generator=g)
            for n in (19, 11)]
    prompt = [9, 4]
    want = ref.logits_at(w, ref_cfg(cfg),
                         seqs, [torch.arange(p - 1, len(s))
                                for p, s in zip(prompt, seqs)])
    smax = 24
    slots = api.cache_init(cfg, 2, smax)
    got = [[] for _ in seqs]
    with torch.inference_mode():
        for b, (s, p) in enumerate(zip(seqs, prompt)):
            cache, logits = api.prefill(model, cfg, {"tokens": s[None, :p]},
                                        smax)
            for name, t in cache.items():
                slots[name].narrow(1, b, 1).copy_(t)
            got[b].append(logits[0].float())
        pos = torch.tensor(prompt)
        for step in range(len(seqs[0]) - min(prompt)):
            toks = torch.stack([s[min(int(q), len(s) - 1)]
                                for s, q in zip(seqs, pos)])[:, None]
            logits, slots = api.decode_step(
                model, cfg, {"tokens": toks, "positions": pos}, slots)
            for b, s in enumerate(seqs):
                if pos[b] < len(s):
                    got[b].append(logits[b].float())
            pos = pos + 1
    for b, s in enumerate(seqs):
        g_b = torch.stack(got[b][:len(s) - prompt[b] + 1])
        atol, rtol = TOL[dtype]
        torch.testing.assert_close(g_b, want[b], atol=atol, rtol=rtol)


def _moe_params(n_experts=16, d=64, f=128, seed=3, skew=0.0):
    g = torch.Generator().manual_seed(seed)
    router = torch.randn(d, n_experts, generator=g) / d ** 0.5
    router[:, 0] += skew
    return {"ln": torch.ones(d),
            "router": router,
            "wg": torch.randn(n_experts, d, f, generator=g) / d ** 0.5,
            "wi": torch.randn(n_experts, d, f, generator=g) / d ** 0.5,
            "wo": torch.randn(n_experts, f, d, generator=g) / f ** 0.5}


def test_expert_shares_add_up_to_the_uncut_layer(ref):
    """Each chip of the deployment routes over all 16 experts and gives its
    own 8 experts' part; the two parts sum to the uncut reference layer
    (no shared expert: nothing is computed alike on both chips)."""
    p = _moe_params()
    x = torch.randn(57, 64, generator=torch.Generator().manual_seed(4))
    z = {"top_k": 2}
    uncut = ref._experts(p, x, z, 1e-6, 0, None)
    # the reference's layer takes the residual and normalises it; the
    # port's takes the normalised input
    h = ref._rms(x, p["ln"], 1e-6)
    with torch.no_grad():
        parts = [moe.moe_ffn_dropless({**p, **{k: p[k][lo:lo + 8]
                                               for k in ("wg", "wi", "wo")}},
                                       h, dataclasses.replace(
                                           REDUCED, first_expert=lo))
                 for lo in (0, 8)]
    torch.testing.assert_close(parts[0] + parts[1], uncut, atol=1e-5,
                               rtol=1e-5)
    assert parts[0].abs().sum() > 0 and parts[1].abs().sum() > 0
    held = ref._experts({**p, **{k: p[k][:8] for k in ("wg", "wi", "wo")}},
                        x, z, 1e-6, 0, None)
    torch.testing.assert_close(parts[0], held, atol=1e-5, rtol=1e-5)


def test_dropless_keeps_every_pair_where_a_capacity_drops_some(ref):
    """A router skewed to expert 0: the capacity dispatch at
    capacity_factor 1.25 drops pairs; the dropless layer equals the
    reference's layer, which runs every pair (none dropped) with the
    published, unrenormalised gates."""
    p = _moe_params(skew=3.0)
    T = 64
    x = torch.randn(T, 64, generator=torch.Generator().manual_seed(6))
    h = ref._rms(x, p["ln"], 1e-6)
    cfg = dataclasses.replace(REDUCED, n_experts=16, first_expert=0)
    with torch.no_grad():
        idx, gates = moe.route(p, h, cfg, renormalize=False)
        assert not torch.allclose(gates.sum(-1), torch.ones(T))
        C = moe.capacity(T, dataclasses.replace(cfg, capacity_factor=1.25))
        e, pos = moe.dispatch_indices(idx, 16, C)
        assert int((pos >= C).sum()) > 0             # the capacity drops
        got = moe.moe_ffn_dropless(p, h, cfg)
        want = ref._experts(p, x, {"top_k": 2}, 1e-6, 0, None)
        slot = torch.where(pos < C, e * C + pos, 16 * C)
        dropped = moe._experts(h, slot, gates, p["wg"], p["wi"], p["wo"], C)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert (dropped - want).abs().max() > 1e-2


@pytest.mark.parametrize("chunk,elems", [(4, 1 << 12), (8, 1 << 14)])
def test_reference_scan_matches_the_step_loop(ref, monkeypatch, chunk,
                                              elems):
    """The reference's chunked scan against h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t B_t, y_t = C_t . h_t, one step at a time per sequence, over
    packed sequences that end inside blocks and chunks, with blocks small
    enough that the number of running sequences changes between them, and
    steps whose decay exp(dt A) is far below float32's smallest number."""
    monkeypatch.setattr(ref, "SCAN_CHUNK", chunk)
    monkeypatch.setattr(ref, "SCAN_ELEMS", elems)
    g = torch.Generator().manual_seed(11)
    D, N = 6, 4
    lens = torch.tensor([53, 37, 9, 1])
    offs = torch.cumsum(lens, 0) - lens
    T = int(lens.sum())
    dt = torch.rand(T, D, generator=g) * 0.5
    dt[5] = 60.0                             # exp(-60 * 16) underflows
    x = torch.randn(T, D, generator=g)
    Bm, Cm = torch.randn(T, N, generator=g), torch.randn(T, N, generator=g)
    A = -torch.arange(1, N + 1, dtype=torch.float32).repeat(D, 1)
    got = ref._scan(dt, dt * x, Bm, Cm, A, offs, lens)
    want = torch.empty(T, D)
    for o, n in zip(offs.tolist(), lens.tolist(), strict=True):
        h = torch.zeros(D, N)
        for t in range(o, o + n):
            h = torch.exp(dt[t][:, None] * A) * h \
                + (dt[t] * x[t])[:, None] * Bm[t][None, :]
            want[t] = h @ Cm[t]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_reference_products_are_float32_products(ref):
    """A float32 activation's three bfloat16 parts add up to it to float32's
    precision, so their products with a bfloat16 weight, summed in float32,
    are the float32 product; a float32 weight is multiplied as it is."""
    g = torch.Generator().manual_seed(12)
    x = torch.randn(300, 96, generator=g) * torch.logspace(-6, 6, 96)
    hi, mid, lo = ref._split3(x)
    assert {t.dtype for t in (hi, mid, lo)} == {torch.bfloat16}
    parts = hi.double() + mid.double() + lo.double()
    assert ((parts - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()
    w = (torch.randn(96, 40, generator=g) / 10).to(torch.bfloat16)
    want = x.double() @ w.double()
    got = ref._mm(x, w, None)
    assert got.dtype == torch.float32
    scale = x.double().abs() @ w.double().abs()
    assert ((got.double() - want).abs() <= 1e-6 * scale).all()
    torch.testing.assert_close(ref._mm(x, w.float(), None), x @ w.float())


def test_held_pairs_are_counted_on_the_device():
    p = _moe_params()
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(8))
    cfg = dataclasses.replace(REDUCED, first_expert=8)
    share = {**p, **{k: p[k][8:] for k in ("wg", "wi", "wo")}}
    with torch.no_grad(), moe.held_pairs() as held:
        moe.moe_ffn_dropless(share, x, cfg)
        moe.moe_ffn_dropless(share, x, cfg)
    idx, _ = moe.route(p, x, cfg)
    assert int(held.total) == 2 * int((idx >= 8).sum())
    with moe.held_pairs() as none:
        pass
    assert none.total is None


def test_mixer_norms_against_the_formula():
    """dt, B and C each through x / sqrt(mean(x^2) + eps) * w right after
    x_proj; dt then through dt_proj, its bias and softplus."""
    cfg = REDUCED
    g = torch.Generator().manual_seed(9)
    p = ssm.mamba1_init(g, cfg, torch.float32)
    for k, n in (("dt_norm", cfg.dt_rank), ("B_norm", cfg.ssm_state),
                 ("C_norm", cfg.ssm_state)):
        p[k] = torch.rand(n, generator=g) + 0.5
    xc = torch.randn(2, 5, cfg.d_inner, generator=g)
    dt, A, Bm, Cm = ssm._mamba1_ssm_inputs(p, xc, cfg)
    r, n, eps = cfg.dt_rank, cfg.ssm_state, cfg.norm_eps
    raw = xc @ p["x_proj"]

    def norm(v, w):
        return v / torch.sqrt((v * v).mean(-1, keepdim=True) + eps) * w

    want_dt = F.softplus(norm(raw[..., :r], p["dt_norm"]) @ p["dt_proj"]
                         + p["dt_bias"])
    torch.testing.assert_close(dt, want_dt, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(Bm, norm(raw[..., r:r + n], p["B_norm"]),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(Cm, norm(raw[..., r + n:], p["C_norm"]),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(A, -torch.exp(p["A_log"]))


def test_the_other_families_keep_their_paths():
    """falcon-mamba's block has no mixer norms and feeds the raw slices;
    qwen2-moe's layer renormalises its gates and keeps the capacity
    dispatch; attention rotates unless told not to."""
    fm = reduced(get_config("falcon-mamba-7b"))
    g = torch.Generator().manual_seed(10)
    p = ssm.mamba1_init(g, fm, torch.float32)
    assert not {"dt_norm", "B_norm", "C_norm"} & set(p)
    xc = torch.randn(1, 3, fm.d_inner, generator=g)
    _, _, Bm, _ = ssm._mamba1_ssm_inputs(p, xc, fm)
    r = fm.dt_rank
    torch.testing.assert_close(Bm, (xc @ p["x_proj"])[..., r:r + fm.ssm_state])

    qm = reduced(get_config("qwen2-moe-a2.7b"))
    mp = moe.moe_init(g, qm, torch.float32)
    x = torch.randn(10, qm.d_model, generator=g)
    _, gates = moe.route(mp, x, qm)
    torch.testing.assert_close(gates.sum(-1), torch.ones(10))
    with torch.no_grad():
        torch.testing.assert_close(
            moe.moe_ffn(mp, x, qm),
            moe.moe_ffn_dense_oracle(mp, x, qm), atol=1e-5, rtol=1e-5)

    ap = attention.attn_init(g, 32, 4, 2, 8, False, torch.float32)
    h = torch.randn(1, 5, 32, generator=g)
    pos = torch.arange(5)[None]
    q, k, _ = attention.qkv_project(ap, h, pos, 1e4, False, 1e-6)
    q0, k0, _ = attention.qkv_project(ap, h, pos, 1e4, False, 1e-6,
                                      rotary=False)
    sin, cos = rope_sincos(pos, 8, 1e4)
    torch.testing.assert_close(q, apply_rope(q0, sin, cos))
    torch.testing.assert_close(k, apply_rope(k0, sin, cos))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _requests(cfg, shapes, seed=11):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, n,
                                        dtype=np.int32),
                    max_new_tokens=m, uid=i)
            for i, (n, m) in enumerate(shapes)]


def test_jamba_declares_a_capturable_step_and_runs_it_eagerly_on_the_cpu():
    model = _model()
    eng = ContinuousEngine(REDUCED, model, max_batch=2, max_seq=32)
    assert eng.api.decode_graph and eng.graph is None
    assert eng._axes == {"conv": 1, "h": 1, "k": 1, "v": 1}
    assert tuple(eng.cache["k"].shape) == (1, 2, 2, 32, 16)
    assert tuple(eng.cache["conv"].shape) == (7, 2, 3, 128)


def test_serve_driver_serves_jamba_and_lets_go_of_prefill_caches():
    """ServeDriver over the continuous engine on a SchedulerSession: every
    stream equals greedy_reference; the engine counts the pairs its
    prefills routed to the held experts and each expert layer records a
    ``moe`` span; no finished prefill task keeps its admissions and no
    inserted admission keeps its single-slot cache."""
    cfg = REDUCED
    model = _model(cfg)
    eng = ContinuousEngine(cfg, model, max_batch=2, max_seq=40)
    made = []
    prefill = eng.prefill_request

    def recording(req):
        adm = prefill(req)
        made.append(adm)
        return adm
    eng.prefill_request = recording
    sess = SchedulerSession(ThreadExecutor(build_comm=False, tick=0.01),
                            ResourceManager(["d0", "d1"]), tick=0.01)
    drv = ServeDriver(eng, sess, admit_chunk=2, telemetry_interval=0.0)
    reqs = _requests(cfg, [(7, 4), (12, 3), (5, 5), (9, 2), (3, 4)])
    out = drv.run(reqs, timeout=300)
    rep = sess.drain(timeout=60).close()
    for r in reqs:
        np.testing.assert_array_equal(
            out[r.uid], greedy_reference(cfg, model, r.prompt,
                                         r.max_new_tokens))
    assert len(made) == len(reqs)
    assert all(a.cache is None for a in made)
    prefills = [t for t in rep.tasks if t.desc.name.startswith("serve-pre")]
    assert prefills and all(t.result is None for t in prefills)

    idx_total = 0
    for r in reqs:
        x = torch.as_tensor(r.prompt, dtype=torch.int64)[None]
        idx_total += _held_pairs_of(cfg, model, x)
    assert eng.metrics.get("serve_moe_pairs_held") == idx_total > 0
    spans = [s for t in prefills for s in t.spans if s["kind"] == "moe"]
    assert sorted({s["attrs"]["layer"] for s in spans}) == [1, 3, 5, 7]
    assert len(spans) == 4 * len(reqs)
    assert sorted(s["attrs"]["tokens"] for s in spans if
                  s["attrs"]["layer"] == 1) == sorted(len(r.prompt)
                                                      for r in reqs)


def _held_pairs_of(cfg, model, tokens) -> int:
    """The pairs a prefill of ``tokens`` routes to the held experts,
    counted outside the engine."""
    with torch.no_grad(), moe.held_pairs() as held:
        get_model(cfg).prefill(model, cfg, {"tokens": tokens}, 64)
    return int(held.total)


def test_insert_drops_the_admissions_cache():
    cfg = REDUCED
    eng = ContinuousEngine(cfg, _model(cfg), max_batch=2, max_seq=32)
    a, b = _requests(cfg, [(6, 3), (4, 1)])
    adm = eng.prefill_request(a)
    own = dict(adm.cache)
    slot = eng.insert(adm)
    assert adm.cache is None
    for name, ax in eng._axes.items():
        assert torch.equal(eng.cache[name].narrow(ax, slot, 1), own[name])
    done = eng.prefill_request(b)           # one token: done at admission
    assert eng.insert(done) is None and done.cache is None


def test_other_families_count_no_held_pairs():
    fm = dataclasses.replace(reduced(get_config("falcon-mamba-7b")),
                             n_layers=2)
    model = get_model(fm).init(torch.Generator().manual_seed(0), fm)
    eng = ContinuousEngine(fm, model, max_batch=2, max_seq=32)
    eng.run(_requests(fm, [(5, 3)]))
    assert "serve_moe_pairs_held" not in eng.metrics.snapshot()


def test_decode_reads_nothing_back_to_the_host(monkeypatch):
    """The decode step never asks for a host value: ``Tensor.item``,
    ``tolist`` and conversions to Python numbers are not called."""
    cfg = REDUCED
    model = _model(cfg)
    api = get_model(cfg)
    cache = api.cache_init(cfg, 2, 16)
    batch = {"tokens": torch.tensor([[3], [5]]),
             "positions": torch.tensor([2, 7])}

    def boom(*a, **k):
        raise AssertionError("host readback inside the decode step")
    for name in ("item", "tolist", "__int__", "__float__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    with torch.inference_mode():
        logits, _ = api.decode_step(model, cfg, batch, cache)
    monkeypatch.undo()
    assert logits.shape == (2, cfg.vocab_size)
