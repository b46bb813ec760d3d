"""The plain reference against tpusdr_torch's chains on the CPU at small
sizes, on the benchmark's own band: the float64 reference and the port
agree far inside the cells' limit, the bfloat16 control does not."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sdrbench import check, run, signal
from sdrbench.reference import design
from tpusdr_torch.ops import design as port_design

ROOT = Path(__file__).resolve().parents[2]


def _cfg(name, period):
    cfg = json.loads((ROOT / "sdrbench" / "configs" / f"{name}.json").read_text())
    cfg["signal"] = {**cfg["signal"], "period": period}
    return cfg


def test_the_frozen_design_copy_gives_the_port_s_taps():
    a = design.lowpass_taps(20e6, 1e5, 1e5, -60.0)
    b = port_design.lowpass_taps(20e6, 1e5, 1e5, -60.0)
    assert len(a) == 546 and np.array_equal(a, b)


@pytest.mark.parametrize("name,tick,period,ticks", [
    ("wbfm_hackrf20", 50000, 25000, 4),
    ("fm_band100", 25000, 25000, 5),
])
def test_reference_matches_the_port_and_the_control_does_not(name, tick, period, ticks):
    cfg = _cfg(name, period)
    band = signal.Band(cfg, 2**34 + 11, "cpu")
    wires = [band.block(j * tick, tick) for j in range(ticks)]
    chain, _ = run.build_chain(cfg)
    state = chain.init_state()
    outs = []
    for w in wires:
        state, y = chain.apply(state, w)
        outs.append(y.numpy())

    def inputs(index, k):
        lo = max(0, index - k)
        return torch.cat(wires[lo : index + 1]), lo * tick, (index - lo) * tick

    mod = check.reference_module(cfg)
    plan = mod.plan(cfg["reference"])
    limit = cfg["check"]["audio_peak_err_db"]
    for index in range(ticks):
        ref = check.decode_tick(cfg, plan, inputs, index, tick, "cpu")
        assert ref.shape == outs[index].shape
        assert check.peak_err_db(outs[index], ref) < limit - 20
    low = check.decode_tick(cfg, plan, inputs, ticks - 1, tick, "cpu", dtype=torch.bfloat16)
    assert check.peak_err_db(low, check.decode_tick(cfg, plan, inputs, ticks - 1, tick, "cpu")) > limit + 10


def test_peak_err_db_by_hand():
    ref = np.array([[0.0, 0.5, -1.0], [2.0, 0.0, 0.0]])
    got = ref + np.array([[0.0, 0.01, 0.0], [0.0, 0.0, 0.002]])
    assert check.peak_err_db(got, ref) == pytest.approx(-40.0)
    assert check.peak_err_db(got[:, :2], ref) == 400.0


def test_band_is_the_same_for_a_seed_and_differs_between_seeds():
    cfg = _cfg("wbfm_hackrf20", 25000)
    a = signal.Band(cfg, 2**33 + 1, "cpu").block(0, 10000)
    b = signal.Band(cfg, 2**33 + 1, "cpu").block(0, 10000)
    c = signal.Band(cfg, 2**33 + 2, "cpu").block(0, 10000)
    assert a.dtype == torch.int16 and torch.equal(a, b) and not torch.equal(a, c)
