"""The audio resampler's share of the roofline: its work against hand
counts, and its reader on the CPU at small sizes (the look for the card is
set aside, as in test_sdrbench_spans.py)."""

import sys

import pytest

from sdrbench import roofline, run, spans
from sdrbench.resampler_work import resampler_work, rows_of
from sdrbench.tests.conftest import SMALL

SEED = 2**33 + 43
NAME = "resampler_tick_roofline_pct"


def test_resampler_work_nbfm_capture():
    # 57 rows of 19,375 samples behind 137 carried, 5,115 out each, 33/125 of 4,529 taps (138 a phase)
    n_bytes, n_ops = resampler_work(57, 19_375, 5_115, 33, 4_529)
    assert n_bytes == 57 * (19_375 + 137) * 4 + 57 * 5_115 * 4 + 4_529 * 4 == 5_633_072
    assert n_ops == 2 * 57 * 5_115 * 138 == 80_469_180
    # bytes bound: 5.633 MB / 3.35 TB/s = 1.68 us, over 1.20 us of operations
    assert roofline.least_seconds(n_bytes, n_ops) == pytest.approx(5_633_072 / 3.35e12)


def test_resampler_work_bank100():
    n_bytes, n_ops = resampler_work(100, 12_800, 3_072, 6, 907)  # 152 taps a phase
    assert n_bytes == 100 * (12_800 + 151) * 4 + 100 * 3_072 * 4 + 907 * 4 == 6_412_828
    assert n_ops == 2 * 100 * 3_072 * 152


def test_rows_are_the_cells_channels():
    assert rows_of({"num_channels": 57}) == 57 and rows_of(object()) == 1


def _readings(workload, config, seconds=0.6):
    cell = run.Cell(run.load_spec(workload), SEED, seconds, False, "cpu", SMALL[config])
    window = run.traffic_mode(cell.traffic["mode"]).drive(cell)
    return run.Readings(cell, window, None)


def test_the_reader_reads_the_resampler_between_its_stamps(monkeypatch):
    r = _readings("bank100.capture", "fm_band100")
    assert run.read_metric(NAME, r) is None  # off the card
    monkeypatch.setattr(spans, "on_card", lambda r: True)
    v = run.read_metric(NAME, r)
    st = spans.stage(r, "Resampler")
    us = spans.traced(r)["summary"]["stages"][st["name"]]["p50_us"]
    assert st["name"] == "audio" and st["n_in"] == SMALL["fm_band100"]["tick"] // 100
    work = resampler_work(100, st["n_in"], st["n_out"], 6, st["block"].taps.shape[-1])
    assert 0 < v < 100 and v == pytest.approx(roofline.share_pct(*work, us * 1e-6))


def test_the_reader_gives_nothing_off_its_mode_or_without_a_tracer(monkeypatch):
    r = _readings("wbfm.live", "wbfm_hackrf20")
    monkeypatch.setattr(spans, "on_card", lambda r: True)
    assert run.read_metric(NAME, r) is None and not hasattr(r, "spans_run")
    r = _readings("bank100.capture", "fm_band100")
    monkeypatch.setitem(sys.modules, "tpusdr_torch.utils.tracing", None)  # a program without the tracer
    assert run.read_metric(NAME, r) is None
