"""The benchmark's own operation and byte counts, against shapes worked
out by hand."""
import json

import pytest

from conftest import BENCH

from yardstick import counts


def _falcon():
    return json.loads((BENCH / "configs/falcon-mamba-7b.json").read_text())


def test_peaks_are_the_data_sheet_h100_sxm():
    assert counts.H100_BF16_FLOPS == 989e12
    assert counts.H100_F32_FLOPS == 67e12
    assert counts.H100_HBM_BYTES_PER_S == 3.35e12


def test_radix_partition_bytes():
    # a rank's 8.75 M valid rows into 4 ranks + 1 bucket of invalid rows
    assert counts.radix_partition_bytes(8_750_000, 5) == 70_000_020
    assert counts.radix_partition_bytes(17_500_064, 5) == 140_000_532


def test_ssm_scan_counts_and_bound():
    # (B, S, D, N) = (1, 2048, 8192, 16): 113 FLOPs a (step, channel)
    assert counts.ssm_scan_flops(1, 2048, 8192, 16) == 1_895_825_408
    # dt f32, x bf16, y f32 a (step, channel): 10 bytes; B and C bf16 a
    # (step, state): 4 bytes; A f32 and the final state f32 a (channel,
    # state): 8 bytes
    want = 2048 * 8192 * 10 + 2048 * 16 * 4 + 8192 * 16 * 8
    assert counts.ssm_scan_bytes(1, 2048, 8192, 16) == want == 168_951_808
    assert counts.ssm_scan_bound_s(1, 2048, 8192, 16) == \
        pytest.approx(want / 3.35e12)                     # bytes bound it
    assert counts.ssm_scan_flops(1, 2048, 8192, 16) / 67e12 < \
        want / 3.35e12


def test_falcon_mamba_flops_per_token():
    cfg = _falcon()
    weights = 4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096
    assert weights == 105_119_744
    layer = 2 * weights + 2 * 4 * 8192 + 8192 * 113
    assert counts.mamba1_layer_flops_per_token(cfg) == layer == 211_230_720
    head = 2 * 4096 * 65024
    assert counts.mamba1_logits_flops(cfg) == head == 532_676_608
    assert counts.mamba1_prefill_flops(cfg, 1000) == 1000 * 64 * layer + head
    assert counts.mamba1_decode_flops(cfg) == 64 * layer + head
    assert counts.mamba1_request_flops(cfg, 1000, 10) == \
        1000 * 64 * layer + head + 9 * (64 * layer + head)


def test_falcon_mamba_parameter_count():
    # untied, as served and published, 7.27 B; tied, 7.01 B
    assert counts.mamba1_params(_falcon(), tied=False) == \
        pytest.approx(7.27e9, rel=5e-3)
    assert counts.mamba1_params(_falcon(), tied=True) == 7_006_326_784
