"""Whole runs of every cell on the CPU at small sizes (``run_cell`` past
the look for a card), correct on a sound program and not correct with the
timed path broken underneath; and the control's reading over the limit."""

import pytest
import torch

from sdrbench import control, run
from sdrbench.tests.conftest import SMALL
from tpusdr_torch.graph.chain import Chain

CELLS = [("wbfm.capture", "wbfm_hackrf20"), ("bank100.capture", "fm_band100"), ("wbfm.live", "wbfm_hackrf20")]


def _run(workload, config, seconds=0.6, trace=False, seed=2**33 + 17):
    return run.run_cell(workload, seed, seconds, trace, "cpu", sizes=SMALL[config], say=lambda _: None)


@pytest.mark.parametrize("workload,config", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(workload, config):
    r = _run(workload, config)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    spec = run.load_spec(workload)
    assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "check"
    assert r["check"]["audio_peak_err_db"]["value"] < r["check"]["audio_peak_err_db"]["limit"] - 20


def test_a_traced_run_reads_the_host_metrics_off_the_card():
    r = _run("wbfm.live", "wbfm_hackrf20", trace=True)
    assert r["correct"]
    assert r["metrics"]["host_cpu_ms_per_tick.live"]["value"] > 0
    # no device on the CPU: no device metric, no roofline, no breakdown
    assert r["metrics"].keys() == {"host_cpu_ms_per_tick.live"} and "breakdown" not in r


def _state_unchanged(monkeypatch):
    apply = Chain.apply

    def frozen(self, state, x):
        _, y = apply(self, state, x)
        return state, y

    monkeypatch.setattr(Chain, "apply", frozen)


def _answer_altered(monkeypatch):
    apply = Chain.apply

    def altered(self, state, x):
        state, y = apply(self, state, x)
        y = y.clone()
        y[..., y.shape[-1] // 2] += 0.05
        return state, y

    monkeypatch.setattr(Chain, "apply", altered)


def _half_the_channels_left_out(monkeypatch):
    apply = Chain.apply

    def half(self, state, x):
        state, y = apply(self, state, x)
        if y.dim() > 1:
            y = y.clone()
            y[y.shape[0] // 2 :] = y[: y.shape[0] // 2].mean(0)
        return state, y

    monkeypatch.setattr(Chain, "apply", half)


FAULTS = {"state_unchanged": _state_unchanged, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload,config", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, config, fault):
    FAULTS[fault](monkeypatch)
    r = _run(workload, config)
    assert not r["correct"], r["check"]


def test_half_the_bank_left_out_is_not_correct(monkeypatch):
    _half_the_channels_left_out(monkeypatch)
    assert not _run("bank100.capture", "fm_band100")["correct"]


@pytest.mark.parametrize("workload,config", [("wbfm.capture", "wbfm_hackrf20"), ("bank100.capture", "fm_band100")])
def test_the_bfloat16_control_fails_the_limit(workload, config):
    spec = run.load_spec(workload)
    reading = control.control_reading(workload, 2**33 + 23, torch.device("cpu"), blocks=3, sizes=SMALL[config])
    assert reading > spec["cfg"]["check"]["audio_peak_err_db"]
