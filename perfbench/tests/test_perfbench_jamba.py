"""The jamba2-mini cell's own parts without a card: each new reader on a
hand-built context, the counts against a hand reckoning, and the driver's
early failure on a checkout whose port has no Jamba family."""
import json
import types

import pytest

from conftest import BENCH
from yardstick import counts_jamba as cj
from yardstick.cell import Cell
from yardstick.devtrace import DeviceWindow, Spans

NS = 1_000_000_000
CELL = "jamba2-mini.longdoc"


def _cfg():
    return json.loads((BENCH / "configs/jamba2-mini.json").read_text())


def _reader(name):
    return Cell(CELL).reader(name)


def _window(kernels, lo, hi):
    """A device window with ``kernels`` (name, start s, end s) wholly
    inside [lo, hi]."""
    w = DeviceWindow(0.0, hi - lo)
    w.t0_ns, w.t1_ns = int(lo * NS), int(hi * NS)
    w.kernels = [(n, int(s * NS), int(e * NS)) for n, s, e in kernels]
    w.whole = list(w.kernels)
    return w


def _prefills(*recs):
    """The benchmark's host spans of prefills: (uid, start s, end s,
    prompt length)."""
    sp = Spans()
    for uid, s, e, n in recs:
        sp.add("prefill", int(s * NS), int(e * NS), uid=uid, prompt=n)
    return sp


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------
def test_per_token_counts_by_hand():
    cfg = _cfg()
    z = cj.sizes(cfg)
    assert (z["mamba_layers"], z["attn_layers"], z["moe_layers"],
            z["mlp_layers"], z["di"], z["hd"]) == (28, 4, 16, 16, 8192, 128)
    # in_proj 4096 x 16384, x_proj 8192 x 288, dt_proj 256 x 8192,
    # out_proj 8192 x 4096: 105 119 744 multiply-adds; conv 2 x 4 x 8192;
    # scan 8192 x (7 x 16 + 1)
    assert cj.mamba_flops_per_token(cfg) == 210_239_488 + 65_536 + 925_696
    # wq and wo 4096 x 4096, wk and wv 4096 x 1024
    assert cj.attn_proj_flops_per_token(cfg) == 83_886_080
    assert cj.mlp_flops_per_token(cfg) == cj.expert_pair_flops(cfg) == \
        352_321_536
    assert cj.router_flops_per_token(cfg) == 131_072
    # 28 Mamba + 4 projections + 16 MLPs + 16 routers: 11.89 GFLOP, and a
    # held pair a token over 16 expert layers 5.64 more: the ~17.5 GFLOP a
    # token of the cell's reckoning
    assert cj.dense_flops_per_token(cfg) == 11_889_246_208
    assert cj.head_flops(cfg) == 2 * 4096 * 65536


def test_attention_expert_and_scan_bounds_by_hand():
    cfg = _cfg()
    # 4 x 128 x 32 = 16 384 FLOPs a (query, key) pair; 32 768 x 32 769 / 2
    # pairs
    assert cj.flash_attention_flops(cfg, 32768) == 8_796_361_457_664
    assert cj.flash_attention_bound_s(cfg, 32768) == \
        pytest.approx(8_796_361_457_664 / 989e12)
    # a held expert layer's weights: 3 x 8 x 4096 x 14336 bf16 = 2.82 GB
    assert cj.held_expert_bytes(cfg) == 2_818_572_288
    # one grouped product over 4096 pairs: 481 GFLOP (0.486 ms) against
    # 0.94 GB of weights (0.280 ms); over 32 pairs the bytes bound it
    assert cj.expert_product_bound_s(cfg, 4096) == \
        pytest.approx(2 * 4096 * 4096 * 14336 / 989e12)
    assert cj.expert_product_bound_s(cfg, 32) == \
        pytest.approx(939_524_096 / 3.35e12)
    # the scan at 8192 channels is bound by its bytes: dt and y f32 and x
    # bf16 a (step, channel), B and C bf16, A and the final state f32
    want = 4096 * 8192 * 10 + 4096 * 16 * 4 + 8192 * 16 * 8
    assert cj.ssm_scan_bound(cfg, 4096) == pytest.approx(want / 3.35e12)


def test_request_counts_by_hand():
    cfg = _cfg()
    s, pairs = 8192, 8192 * 16
    pre = (s * 11_889_246_208 + pairs * 352_321_536
           + 4 * 16_384 * s * (s + 1) // 2 + 2 * 4096 * 65536)
    assert cj.prefill_flops(cfg, s, pairs) == pre
    # two decode steps at positions 8192 and 8193, 16 pairs a token
    dec = [11_889_246_208 + 16 * 352_321_536 + 4 * 16_384 * (p + 1)
           + 2 * 4096 * 65536 for p in (8192, 8193)]
    assert cj.request_flops(cfg, s, 3, pairs) == pytest.approx(pre + sum(dec))


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------
def test_flash_attention_roofline():
    cfg = _cfg()
    b1, b2 = (cj.flash_attention_bound_s(cfg, n) for n in (4096, 8192))
    # a launch in each prefill, each at twice its bound; one outside any
    # prefill and one decode product are not counted
    w = _window([("flash_attention_wgmma_kernel<bf16>", 1.1, 1.1 + 2 * b1),
                 ("flash_attention_wgmma_kernel<bf16>", 3.1, 3.1 + 2 * b2),
                 ("flash_attention_wgmma_kernel<bf16>", 2.5, 2.6),
                 ("gemv", 1.2, 1.3)], 0.0, 5.0)
    ctx = {"device_window": w, "cfg": cfg,
           "spans": _prefills((1, 1.0, 2.0, 4096), (2, 3.0, 4.0, 8192))}
    assert _reader("flash_attention_roofline.ldc")(ctx) == \
        pytest.approx(50.0, rel=1e-6)
    ctx["device_window"] = None
    assert _reader("flash_attention_roofline.ldc")(ctx) is None


def test_ssm_scan_roofline():
    cfg = _cfg()
    b = cj.ssm_scan_bound(cfg, 4096)
    w = _window([("ssm_scan_kernel<16>", 1.1 + i * 4 * b,
                  1.1 + (i + 1) * 4 * b) for i in range(3)], 0.0, 5.0)
    ctx = {"device_window": w, "cfg": cfg,
           "spans": _prefills((1, 1.0, 2.0, 4096))}
    assert _reader("ssm_scan_roofline.ldc")(ctx) == \
        pytest.approx(25.0, rel=1e-6)
    ctx["spans"] = _prefills()
    assert _reader("ssm_scan_roofline.ldc")(ctx) is None


def _span(kind, t0, t1, uid, **attrs):
    return {"kind": kind, "t0": t0, "t1": t1, "parent": None,
            "attrs": attrs, "worker": "thread", "part": 0, "uid": uid,
            "task": ""}


def _task(name, uid, start, end, spans):
    return types.SimpleNamespace(
        desc=types.SimpleNamespace(name=name), uid=uid, start_time=start,
        end_time=end, state=types.SimpleNamespace(name="DONE"),
        spans=[_span(*s, uid) for s in spans])


def test_moe_issue_ms():
    # two prefills in the window's prefill task: moe spans of 3 + 5 ms and
    # 2 ms; a decode task's moe span and a task before the window are left
    # out
    tasks = [
        _task("serve-prefill#0", 1, 100.0, 101.0,
              [("prefill_issue", 100.0, 100.4), ("moe", 100.1, 100.103),
               ("moe", 100.2, 100.205), ("prefill_issue", 100.5, 100.9),
               ("moe", 100.6, 100.602)]),
        _task("serve-decode#1", 2, 100.0, 101.0,
              [("decode_issue", 100.0, 100.1), ("moe", 100.01, 100.05)]),
        _task("serve-prefill#-1", 0, 98.0, 99.0,
              [("prefill_issue", 98.0, 98.5), ("moe", 98.1, 98.3)]),
    ]
    ctx = {"t0": 99.5, "t_end": 200.0, "tasks": tasks}
    assert _reader("moe_issue_ms.ldc")(ctx) == pytest.approx(5.0)
    for t in tasks:
        t.spans = [s for s in t.spans if s["kind"] != "moe"]
    assert _reader("moe_issue_ms.ldc")(ctx) is None


def test_mfu_from_the_counted_pairs():
    cfg = _cfg()
    reqs = {7: {"prompt": [0] * 4096, "answer": 16, "due": 1.0,
                "done": 5.0},
            8: {"prompt": [0] * 8192, "answer": 32, "due": 2.0,
                "done": 9.0}}
    pairs = {7: 60_000, 8: 130_000, -1: 10}
    ctx = {"cfg": cfg, "requests": reqs, "moe_pairs": pairs,
           "finished_in_window": list(reqs.values()), "t0": 0.0,
           "t_end": 10.0}
    want = (cj.request_flops(cfg, 4096, 16, 60_000)
            + cj.request_flops(cfg, 8192, 32, 130_000)) / 10.0 / 989e12
    assert _reader("mfu.ldc")(ctx) == pytest.approx(100 * want)
    # the parent: no counter, no pairs
    ctx["moe_pairs"] = {}
    assert _reader("mfu.ldc")(ctx) is None
    ctx.pop("moe_pairs")
    assert _reader("mfu.ldc")(ctx) is None


def test_idle_pct():
    w = _window([("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 3.5)],
                0.0, 5.0)
    assert _reader("idle_pct.ldc")({"device_window": w}) == \
        pytest.approx(50.0)
    assert _reader("idle_pct.ldc")({"device_window": None}) is None


# ---------------------------------------------------------------------------
# the driver on a port without the family
# ---------------------------------------------------------------------------
def test_driver_fails_before_drawing_weights_without_the_family(monkeypatch):
    import torch

    import repro_torch.configs as configs
    cell = Cell(CELL)
    drv = cell.driver().Driver(cell, 2 ** 33 + 5, torch.device("cpu"), {})

    def absent(arch):
        raise KeyError(f"unknown arch {arch!r}")

    def drawn(*a, **k):
        raise AssertionError("the weights were drawn")
    monkeypatch.setattr(configs, "get_config", absent)
    monkeypatch.setattr(drv.ref, "make_weights", drawn)
    with pytest.raises(NotImplementedError, match="no 'jamba2-mini'"):
        drv.setup()


def test_check_compares_the_mean_gap_of_every_served_token(capsys):
    """The gaps of the sampled requests' served tokens, pooled: their mean
    against ``check.logit_gap_mean_limit``, the widest printed; an answer
    cut short is counted."""
    import torch
    drv_mod = Cell(CELL).driver()
    drv = drv_mod.Driver.__new__(drv_mod.Driver)
    drv.cfg, drv.seed = _cfg(), 2 ** 33 + 9
    drv.req = {u: {"prompt": [1] * (100 + u), "answer": 4} for u in range(12)}
    drv.results = {u: [7] * (3 if u == 11 else 4) for u in range(12)}
    seen = []

    def served_gaps(weights, cfg, prompts, served):
        seen.append(len(prompts))
        return [torch.tensor([0.0, 0.0, 0.5, 0.1])[:len(s)] for s in served]
    drv.weights, drv.ref = None, types.SimpleNamespace(served_gaps=served_gaps)
    got = dict((n, (v, lim)) for n, v, lim in drv.check())
    k = drv.cfg["check"]["requests"]
    assert seen == [k] and 11 in drv.compared
    assert got["logit_gap_mean"] == (
        pytest.approx((0.6 * k - 0.1) / (4 * k - 1)),
        drv.cfg["check"]["logit_gap_mean_limit"])
    assert got["answers_cut_short"] == (1, 0)
    assert "widest logit gap 0.5" in capsys.readouterr().err


def test_driver_maps_the_file_onto_the_port_config():
    drv_mod = Cell(CELL).driver()
    mc = drv_mod.port_config(_cfg())
    assert (mc.n_layers, mc.d_model, mc.head_dim, mc.d_inner, mc.dt_rank,
            mc.n_experts, mc.n_router_experts, mc.first_expert, mc.top_k,
            mc.norm_eps, mc.dtype) == (32, 4096, 128, 8192, 256, 8, 16, 0, 2,
                                       1e-6, "bfloat16")
    bad = dict(_cfg(), mamba_dt_rank=128)
    with pytest.raises(ValueError):
        drv_mod.port_config(bad)


def _moe_window(cfg):
    """Two prefills wholly inside the sub-window [0, 10] s, each with its
    3 x 16 ``Cooperative`` products at four times their bound, and around
    them what the reader leaves out: decode's ``Pingpong`` products inside
    a prefill, a ``Cooperative`` product outside any prefill, and a prefill
    that the window's edge cuts."""
    grouped = ("cutlass::device_kernel<GemmUniversal<GroupProblemShape<int>,"
               " KernelPtrArrayTmaWarpSpecialized{}>>")
    big, small = grouped.format("Cooperative"), grouped.format("Pingpong")
    # request 7: 16 384 held pairs over 16 layers, 1 024 a layer: the
    # bytes bound a product (0.28 ms); request 8: 131 072, 8 192 a layer:
    # its FLOPs do (0.97 ms)
    b7 = cj.expert_product_bound_s(cfg, 1024)
    b8 = cj.expert_product_bound_s(cfg, 8192)
    assert b7 == pytest.approx(cj.held_expert_bytes(cfg) / 3 / 3.35e12)
    assert b8 == pytest.approx(2 * 8192 * 4096 * 14336 / 989e12)
    ks = [(big, 1.0 + i * 0.01, 1.0 + i * 0.01 + 4 * b7) for i in range(48)]
    ks += [(big, 4.0 + i * 0.01, 4.0 + i * 0.01 + 4 * b8) for i in range(48)]
    ks += [(small, 1.9, 1.9001), (small, 4.9, 4.9002),
           (big, 3.0, 3.1),                      # outside any prefill
           (big, 9.6, 9.7),                      # the cut prefill's
           ("prepare_grouped_gemm_data", 1.05, 1.06)]
    spans = _prefills((7, 0.9, 2.0, 4096), (8, 3.9, 5.0, 8192),
                      (9, 9.5, 10.5, 8192))
    pairs = {7: 16_384, 8: 131_072, 9: 131_072}
    return ks, spans, pairs


def test_moe_roofline_counts_prefill_products_only():
    cfg = _cfg()
    ks, spans, pairs = _moe_window(cfg)
    ctx = {"device_window": _window(ks, 0.0, 10.0), "cfg": cfg,
           "spans": spans, "moe_pairs": pairs}
    assert _reader("moe_roofline.ldc")(ctx) == pytest.approx(25.0, rel=1e-6)
    ctx["moe_pairs"] = {}
    assert _reader("moe_roofline.ldc")(ctx) is None


@pytest.mark.parametrize("fault", ["a decode product named Cooperative",
                                   "pairs counted five times too many"])
def test_moe_roofline_raises_on_a_misread_prefill(fault):
    cfg = _cfg()
    ks, spans, pairs = _moe_window(cfg)
    if fault.startswith("a decode"):
        ks.append((ks[0][0], 1.95, 1.9501))
        match = "49 grouped"
    else:
        pairs[8] *= 5
        match = "under their bound"
    ctx = {"device_window": _window(ks, 0.0, 10.0), "cfg": cfg,
           "spans": spans, "moe_pairs": pairs}
    with pytest.raises(ValueError, match=match):
        _reader("moe_roofline.ldc")(ctx)
