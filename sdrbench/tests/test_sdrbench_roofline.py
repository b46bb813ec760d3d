"""The work counts of the two rooflines against hand counts."""

import pytest

from sdrbench import roofline


def test_decim_fir_work_wbfm_rf_stage():
    # 1,280,000 cf32 in, 25,600 out, 546 complex taps
    n_bytes, n_ops = roofline.decim_fir_work(1_280_000, 546, 25_600, True)
    assert n_bytes == 1_280_000 * 8 + 25_600 * 8 + 546 * 8 == 10_449_168
    assert n_ops == 25_600 * 546 * 8 == 111_820_800
    # bytes bound: 10.449 MB / 3.35 TB/s = 3.119 us, over 1.669 us of operations
    assert roofline.least_seconds(n_bytes, n_ops) == pytest.approx(3.1191546e-6, rel=1e-6)
    assert roofline.share_pct(n_bytes, n_ops, 6.2383e-6) == pytest.approx(50.0, rel=1e-3)


def test_decim_fir_work_real_taps():
    assert roofline.decim_fir_work(1000, 10, 100, False) == (1000 * 8 + 100 * 8 + 40, 100 * 10 * 4)


def test_channelizer_work_bank64():
    n_bytes, n_ops = roofline.channelizer_work(2_096_640, 64, 768)
    frames = 32_760
    assert n_bytes == 2_096_640 * 8 + 64 * frames * 8 + 768 * 4 == 33_549_312
    # 12 taps a branch x 4 operations x 64 branches x frames, and 5 x 64 x 6 a frame
    assert n_ops == 12 * 4 * 64 * frames + 5 * 64 * 6 * frames == 163_537_920
    assert roofline.least_seconds(n_bytes, n_ops) == pytest.approx(33_549_312 / 3.35e12)


def test_channelizer_work_band100():
    n_bytes, n_ops = roofline.channelizer_work(1_280_000, 100, 1200)
    frames = 12_800
    assert n_bytes == 1_280_000 * 8 + 100 * frames * 8 + 1200 * 4 == 20_484_800
    # 12 taps a branch x 4 x 100 branches x frames, and 5 x 100 x log2(100) a frame
    assert n_ops == pytest.approx(12 * 4 * 100 * frames + 5 * 100 * 6.643856189774724 * frames)


def test_channelizer_work_pads_taps_to_whole_branches():
    _, ops = roofline.channelizer_work(64 * 10, 64, 700)  # 11 taps a branch
    assert ops == 11 * 4 * 64 * 10 + 5 * 64 * 6 * 10
