"""The readers of the program's spans and stamps (``sdrbench/spans.py``)
on the CPU at small sizes: the traced re-drive, once a run; each reader's
arithmetic on the CPU's stamps (the readers read only a card's run, so the
look for the card is set aside here); None on a mode a reader does not
read, off the card, and where the program has no tracer; and no output."""

import sys
import types

import numpy as np
import pytest

from sdrbench import run, spans
from sdrbench.tests.conftest import SMALL

SEED = 2**33 + 41
NEW = ["rf_fir_tick_roofline_pct", "channelizer_tick_roofline_pct", "tick_gap_us.capture",
       "drain_hold_ms_p95.live", "upload_wait_ms_p95.live"]


def _readings(workload, config, seconds=0.6):
    cell = run.Cell(run.load_spec(workload), SEED, seconds, False, "cpu", SMALL[config])
    window = run.traffic_mode(cell.traffic["mode"]).drive(cell)
    return run.Readings(cell, window, None)


@pytest.fixture
def as_on_card(monkeypatch):
    monkeypatch.setattr(spans, "on_card", lambda r: True)


def test_the_traced_re_drive_runs_once_and_keeps_the_runs_own_marks():
    r = _readings("wbfm.capture", "wbfm_hackrf20")
    marks, t_window = dict(r.cell.marks), r.cell.t_window
    t = spans.traced(r)
    assert spans.traced(r) is t
    assert r.cell.marks == marks and r.cell.t_window == t_window and r.cell.seconds == 0.6
    names = [n for n, _ in r.cell.chain.blocks]
    assert list(t["summary"]["stages"]) == names
    assert t["summary"]["ticks"]["claimed"] == len(t["rows"]["stamps"]) > 3
    assert t["end_to_end"]["capture_msps"] > 0


@pytest.mark.parametrize("workload,config,name", [
    ("wbfm.capture", "wbfm_hackrf20", "rf_fir_tick_roofline_pct"),
    ("bank100.capture", "fm_band100", "channelizer_tick_roofline_pct"),
])
def test_a_stage_roofline_reads_the_stage_between_its_stamps(as_on_card, workload, config, name):
    from sdrbench import roofline

    r = _readings(workload, config)
    v = run.read_metric(name, r)
    st = spans.stage(r, "FreqShiftFir", "Fir", "Channelizer")
    us = spans.traced(r)["summary"]["stages"][st["name"]]["p50_us"]
    assert st["n_in"] == r.cell.tick and 0 < v < 100
    b = st["block"]
    if name.startswith("rf_fir"):
        work = roofline.decim_fir_work(st["n_in"], b.taps.shape[-1], st["n_out"], True)
    else:
        work = roofline.channelizer_work(st["n_in"], b.num_channels, b.taps.shape[-1])
    assert v == pytest.approx(roofline.share_pct(*work, us * 1e-6))


def test_the_live_readers_read_each_block_of_the_timed_run(as_on_card):
    r = _readings("wbfm.live", "wbfm_hackrf20")
    t = spans.traced(r)
    hold, wait = spans.drain_hold_ms(t), spans.upload_wait_ms(t)
    from sdrbench.window import block_samples

    n = block_samples(r.cell.traffic, r.cell.cfg, r.cell.chain.granule)
    blocks = int(min(spans.SECONDS, r.cell.seconds) * r.cell.cfg["rf_sample_rate"] / n)
    assert len(hold) == len(wait) == blocks
    assert (hold > 0).all() and (wait > 0).all()
    assert run.read_metric("drain_hold_ms_p95.live", r) == pytest.approx(np.percentile(hold, 95))
    assert run.read_metric("upload_wait_ms_p95.live", r) == pytest.approx(np.percentile(wait, 95))


def test_the_gap_reader_takes_consecutive_replays_only():
    st = np.array([[0, 5, 9], [20, 30, -1], [40, 45, 52], [60, 61, 70], [90, 95, 99]]) * 1000
    rows = {"stamps": st, "mode": np.array([0, 1, 2, 2, 2]), "layout": np.array([0, 1, 0, 0, 0]),
            "names": [["start", "a", "b"], ["start", "a"]]}
    assert spans.replay_gaps_us({"rows": rows}).tolist() == [8.0, 20.0]


@pytest.mark.parametrize("workload,config", [("wbfm.capture", "wbfm_hackrf20"), ("wbfm.live", "wbfm_hackrf20")])
def test_readers_give_nothing_off_their_mode_off_the_card_or_without_a_tracer(monkeypatch, capsys, workload, config):
    r = _readings(workload, config)
    assert all(run.read_metric(n, r) is None for n in NEW)  # off the card
    monkeypatch.setattr(spans, "on_card", lambda r: True)
    other = {"replay": ["drain_hold_ms_p95.live", "upload_wait_ms_p95.live"],
             "paced": ["rf_fir_tick_roofline_pct", "channelizer_tick_roofline_pct", "tick_gap_us.capture"]}[r.mode]
    assert all(run.read_metric(n, r) is None for n in other)
    assert not hasattr(r, "spans_run")  # a reader off its mode drives nothing
    monkeypatch.setitem(sys.modules, "tpusdr_torch.utils.tracing", None)  # a program without the tracer
    assert all(run.read_metric(n, r) is None for n in NEW)
    assert capsys.readouterr().out == ""


def test_a_tracer_that_does_not_import_fails_the_traced_run(monkeypatch):
    """Only a program without the tracer module gives None: a tracer that
    is there but does not import raises."""
    r = _readings("wbfm.capture", "wbfm_hackrf20", seconds=0.2)
    monkeypatch.setitem(sys.modules, "tpusdr_torch.utils.tracing", types.ModuleType("tpusdr_torch.utils.tracing"))
    with pytest.raises(ImportError, match="Tracer"):
        spans.traced(r)
    assert not hasattr(r, "spans_run")
