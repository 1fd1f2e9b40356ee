"""The yardstick's arithmetic against hand-worked values."""
import math

import pytest

from perfbench.harness import arith


def test_mcell_rate_counts_whole_cycles_over_the_window():
    # 512^3 cells, 3 cycles of 10 steps in 13.5 s
    assert arith.mcell_rate(512 ** 3, 30, 13.5) == pytest.approx(134217728 * 30 / 13.5 / 1e6)
    assert arith.mcell_rate(512 ** 3, 30, 13.5) == pytest.approx(298.2616177777778)
    with pytest.raises(ValueError):
        arith.mcell_rate(512 ** 3, 0, 10.0)


@pytest.mark.parametrize("crs, want", [
    ((14.57, 33.95, 11.42, 639.11), 21.37),     # PR 27's per-QoI CRs, equal raw sizes
    ((10.0, 10.0, 10.0, 10.0), 10.0),
])
def test_cr_of_a_cycle_is_raw_over_stored(crs, want):
    raw = 512 ** 3 * 4
    stored = sum(raw / c for c in crs)
    assert arith.compression_ratio(4 * raw, stored) == pytest.approx(want, abs=0.01)


def test_psnr_eq1_hand_values():
    # range 2, MSE 1e-6: 20 log10(2 / (2 * 1e-3)) = 60 dB
    assert arith.psnr_eq1(2.0, 1e-6) == pytest.approx(60.0)
    # range 100, RMSE 0.005: 20 log10(100 / 0.01) = 80 dB
    assert arith.psnr_eq1(100.0, 0.005 ** 2) == pytest.approx(80.0)
    assert math.isinf(arith.psnr_eq1(1.0, 0.0))


def test_wavelet_bytes_and_bound_match_the_kernel_table():
    # PERF.md's kernel table, row 1: bound 0.3205199474626865 ms (bytes)
    # for 4096 blocks of 32^3, each read once and written once
    assert arith.wavelet_bytes(4096, 32) == 2 * 4 * 512 ** 3
    assert arith.wavelet_levels(32) == 3
    ms, by = arith.wavelet_bound_ms(4096, 32)
    assert by == "bytes"
    assert ms == pytest.approx(0.3205199474626865, rel=1e-12)


def test_roofline_share_and_nothing_to_read():
    assert arith.roofline_pct(0.32, 4, 2.24) == pytest.approx(100 * 0.32 * 4 / 2.24)
    assert arith.roofline_pct(0.32, 0, 0.0) is None
