"""``models.nbfm_channels``, its ``FusedFmChannels`` block and the channel
axis of the FM-fused kernel's plain version, on the CPU, against the benchmark's
float64 reference (``sdrbench/reference/nbfm_channels.py``) and against C
single-channel blocks; and the ``nbfm_marine57`` configuration and its
cell ``nbfm.capture`` in ``BENCHMARK.json``.

Tolerances: chain audio at most -100 dB of peak error against the float64
reference (float32 through the mix, a 728-tap sum, atan2 and the
resampler; the cell's own limit is -80 dB); the channel axis against C
single channels within 1e-6 * gain (the same float32 operations, batched);
carried phases and tails exactly.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sps
import torch

from sdrbench import check, run, signal
from sdrbench.fm_fused_work import fm_fused_work
from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.kernels import fir_banded
from tpusdr_torch.kernels import fm_fused as tfm
from tpusdr_torch.models import nbfm_channels
from tpusdr_torch.models.receiver import NBFM_CHANNEL_WIDTH
from tpusdr_torch.ops import osc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FS = 2e6
GRANULE = 66 * 125  # /66 to 30,303 Hz, then the resampler's 33/125 to 8 kHz
OFFSETS = [-700e3, -25e3, 0.0, 675e3]
CONFIG = json.loads((ROOT / "sdrbench" / "configs" / "nbfm_marine57.json").read_text())


@pytest.fixture(scope="module")
def built():
    """The 4-channel chain and a 728-tap frontend's pieces, designed once."""
    chain, info = nbfm_channels(FS, OFFSETS)
    return chain, info


def _words(rng, n):
    return torch.from_numpy(rng.integers(-(2**15), 2**15, n, dtype=np.int64).astype(np.int16))


def _cfg(offsets, period):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["build"]["kwargs"]["offsets"] = list(offsets)
    cfg["reference"]["offsets"] = list(offsets)
    cfg["signal"] = {**cfg["signal"], "station_offsets_hz": list(offsets), "period": period}
    return cfg


def _against_reference(cfg, wires, tick):
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
    errs = []
    for index in range(len(wires)):
        ref = check.decode_tick(cfg, plan, inputs, index, tick, "cpu")
        assert ref.shape == outs[index].shape == (len(cfg["reference"]["offsets"]), tick * 4 // 1000)
        errs.append(check.peak_err_db(outs[index], ref))
    return errs, (mod, plan, inputs)


def test_the_chain_is_the_fused_frontend_and_the_resampler(built):
    chain, info = built
    assert [name for name, _ in chain.blocks] == ["frontend", "audio"]
    fe = chain.get_block("frontend")
    assert isinstance(fe, TB.FusedFmChannels) and fe.adds_channel_axis and fe.num_channels == 4
    assert fe.taps.shape[-1] == info["rf_taps"] == 728 and fe.decimation == info["rf_decimation"] == 66
    assert not fir_banded.eligible(728, 66, True)  # a single channel's FusedFmDemod takes K3 there too
    assert info["resampler"] == (33, 125) and info["audio_rate"] == 8000.0
    assert info["quad_gain"] == pytest.approx(info["quad_rate"] / (2 * math.pi * NBFM_CHANNEL_WIDTH))
    assert chain.granule == GRANULE and chain.num_channels == 4


@pytest.mark.parametrize("k", [1, 2])
def test_nbfm_channels_matches_the_reference_on_random_words(k):
    """(a) two ticks of 8,250 k seeded random int8 words, 4 channels."""
    tick = GRANULE * k
    rng = np.random.default_rng(40 + k)
    wires = [_words(rng, tick) for _ in range(2)]
    errs, _ = _against_reference(_cfg([int(f) for f in OFFSETS], 200000), wires, tick)
    assert max(errs) < -100.0, errs


def test_nbfm_channels_matches_the_reference_on_the_band_and_the_control_does_not():
    """The benchmark's own band (a station on every channel), and the
    bfloat16 reference fails the cell's limit."""
    offsets = [-700000, -25000, 0, 675000]
    cfg = _cfg(offsets, 200000)
    band = signal.Band(cfg, 2**34 + 7, "cpu")
    tick = 2 * GRANULE
    wires = [band.block(j * tick, tick) for j in range(3)]
    errs, (mod, plan, inputs) = _against_reference(cfg, wires, tick)
    assert max(errs) < -100.0, errs
    ref = check.decode_tick(cfg, plan, inputs, 2, tick, "cpu")
    low = check.decode_tick(cfg, plan, inputs, 2, tick, "cpu", dtype=torch.bfloat16)
    assert check.peak_err_db(low, ref) > cfg["check"]["audio_peak_err_db"] + 10


def _fm_tones(rng, n, offsets):
    t = np.arange(n) / FS
    z = np.zeros(n, np.complex128)
    for j, f in enumerate(offsets):
        tone = 300.0 + 400.0 * j
        z += 0.2 * np.exp(1j * (2 * np.pi * f * t + 5e3 / tone * np.sin(2 * np.pi * tone * t)))
    z += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return z.astype(np.complex64)


@pytest.mark.parametrize("cuts", [[GRANULE, GRANULE], [66 * 97, 66 * 251, 66 * 40]])
def test_channel_axis_equals_single_channels_tick_by_tick(built, cuts):
    """(b) the channel block against C single-channel ``FusedFmDemod``s,
    carries included, across tick boundaries, at (728, /66): the K3 path of
    both."""
    chain, info = built
    fe = chain.get_block("frontend")
    taps = fe.taps.numpy()
    singles = [TB.FusedFmDemod(FS, -f, taps, 66, fe.gain) for f in OFFSETS]
    z = torch.from_numpy(_fm_tones(np.random.default_rng(7), sum(cuts), OFFSETS))
    state = fe.init_state()
    states = [b.init_state() for b in singles]
    assert state["phase"].shape == (4,) and osc.is_phase(state["phase"]) and set(state) == {"tail", "phase"}
    for x in torch.split(z, cuts):
        state, y = fe.apply(state, x)
        assert y.shape == (4, x.shape[-1] // 66)
        for c, b in enumerate(singles):
            states[c], yc = b.apply(states[c], x)
            torch.testing.assert_close(y[c], yc, rtol=0, atol=1e-6 * fe.gain)
            assert int(state["phase"][c]) == int(states[c]["phase"])
            assert torch.equal(state["tail"], states[c]["tail"])


def test_plain_version_with_c_increments_equals_c_scalar_calls():
    """(c) the FM-fused plain version's channel form, row by row."""
    rng = np.random.default_rng(3)
    T, D, M = 65, 8, 300
    h = torch.from_numpy(sps.firwin(T, 0.1).astype(np.float32))
    n = (T - 1) + (M + 1) * D
    z = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64))
    incs = [osc.freq_to_inc_u32(f, 1e6) for f in (-150e3, 0.0, 99e3, 310e3)]
    phases = [0, 2**32 - 5, 123456789, 2**31]
    got = tfm.fused_fm_demod_plain(z[40:], h, D, torch.tensor(incs), osc.as_phases(phases), 0.7, M,
                                   history=z[:40], phase_offset=11)
    assert got.shape == (4, M)
    for c in range(4):
        ref = tfm.fused_fm_demod_plain(z[40:], h, D, incs[c], phases[c], 0.7, M, history=z[:40], phase_offset=11)
        torch.testing.assert_close(got[c], ref, rtol=0, atol=1e-6)
    # the wrapper takes the same channel form on the CPU
    wrapped = tfm.fused_fm_demod(z[40:], h, D, torch.tensor(incs), osc.as_phases(phases), 0.7, history=z[:40],
                                 phase_offset=11)
    assert torch.equal(wrapped, got)


def test_the_channel_form_refuses_mismatched_increments_and_phases():
    z = torch.zeros(2000, dtype=torch.complex64)
    h = torch.ones(65)
    with pytest.raises(ValueError, match="channel form"):
        tfm.fused_fm_demod(z, h, 8, torch.tensor([1, 2]), osc.as_phases([0, 0, 0]), 1.0)
    with pytest.raises(ValueError, match="channel form"):
        tfm.fused_fm_demod(z, h, 8, torch.tensor([1, 2]), 0, 1.0)


@pytest.mark.parametrize("n", [48 * 1024, 48 * 1024 + 64])
def test_the_channel_block_takes_k3_where_a_single_channel_is_banded(n):
    """(d) a shape the banded rule accepts, where ``FusedFmDemod`` takes
    the D-FIR kernel (whole rows: the K2 prelude; other ticks: K1 with
    history): the channel block still takes the FM-fused kernel, which has
    the channel axis, and gives each single block's audio to float32
    rounding (the banded branches fold the shift into the taps)."""
    taps = sps.firwin(65, 0.1)
    shifts = [-150e3, 100e3]
    blk = TB.FusedFmChannels(1e6, shifts, taps, 8, 1.7)
    singles = [TB.FusedFmDemod(1e6, f, taps, 8, 1.7) for f in shifts]
    assert all(b._rows_capable for b in singles) and fir_banded.prelude_eligible(65, 8, 48 * 1024, True)
    t = np.arange(2 * n) / 1e6
    z = sum(0.3 * np.exp(1j * (2 * np.pi * -f * t + 2.0 * np.sin(2 * np.pi * 1e3 * t))) for f in shifts)
    z = torch.from_numpy(z.astype(np.complex64))
    state, states = blk.init_state(), [b.init_state() for b in singles]
    for x in torch.split(z, n):
        state, y = blk.apply(state, x)
        assert y.shape == (2, n // 8)
        for c, b in enumerate(singles):
            states[c], yc = b.apply(states[c], x)
            torch.testing.assert_close(y[c], yc, rtol=0, atol=1e-4 * 1.7)


def test_retuning_the_channels_equals_a_fresh_block(built):
    """(e) a new sequence of the same length retunes every channel; another
    length, or a float for a block of four channels, is refused."""
    chain, _ = built
    taps = chain.get_block("frontend").taps.numpy()
    new = [-300e3, 50e3, 125e3, 700e3]
    blk = TB.FusedFmChannels(FS, [-f for f in OFFSETS], taps, 66, 0.3)
    blk.update_parameters(frequencies=[-f for f in new])
    fresh = TB.FusedFmChannels(FS, [-f for f in new], taps, 66, 0.3)
    assert blk.inc == fresh.inc and torch.equal(blk.incs, fresh.incs)
    z = torch.from_numpy(_fm_tones(np.random.default_rng(5), 2 * GRANULE, new))
    s1, s2 = blk.init_state(), fresh.init_state()
    for x in torch.split(z, GRANULE):
        s1, y1 = blk.apply(s1, x)
        s2, y2 = fresh.apply(s2, x)
        assert torch.equal(y1, y2) and torch.equal(s1["phase"], s2["phase"])
    for bad in ([-f for f in new[:3]], 100e3):
        with pytest.raises(ValueError, match="number of channels"):
            blk.update_parameters(frequencies=bad)
        assert blk.frequencies == tuple(-f for f in new)


def test_a_scalar_frequency_keeps_the_single_stream_block():
    blk = TB.FusedFmDemod(FS, -100e3, np.ones(728, np.float32) / 728, 66, 0.3)
    assert not blk.adds_channel_axis and isinstance(blk.inc, int) and not hasattr(blk, "incs")
    state = blk.init_state()
    assert state["phase"].shape == () and state["vprev"].shape == (1,)
    _, y = blk.apply(state, torch.zeros(GRANULE, dtype=torch.complex64))
    assert y.shape == (GRANULE // 66,)


def test_the_plan_counts_the_channel_grid():
    """At C = 1 the rule is today's; below the shared form's threshold C x
    blocks decides whether a phase-major launch fills the card; from it on
    the channels share their windows, whatever M."""
    assert tfm.fm_fused_plan(728, 66, 19375, 1) == tfm.fm_fused_plan(728, 66, 19375)
    assert tfm.fm_fused_plan(728, 66, 19375, 57) == tfm.FmFusedPlan("shared", tfm.SHARED_TILE, 728)
    assert tfm.SHARED_MIN_CHANNELS > 2
    M = 10_000  # 63 phase-major blocks: too few for one channel, enough for two
    assert tfm.fm_fused_plan(728, 66, M, 1).form == "taps"
    assert tfm.fm_fused_plan(728, 66, M, 2).form == "phase"
    M = 2513  # 16 phase-major blocks
    assert tfm.fm_fused_plan(728, 66, M, 1).form == "taps"
    assert tfm.fm_fused_plan(728, 66, M, tfm.SHARED_MIN_CHANNELS).form == "shared"
    assert tfm.fm_fused_plan(728, 66, M, 57).form == "shared"


def test_nco_helpers_take_c_increments():
    incs = torch.tensor([1, 2**31 + 3, 2**32 - 1])
    ph = osc.as_phases([0, 5, 2**32 - 1])
    adv = osc.advance_phase(ph, incs, 7)
    assert osc.is_phase(adv)
    assert adv.tolist() == [(p + i * 7) % 2**32 for p, i in zip([0, 5, 2**32 - 1], incs.tolist())]
    back = osc.advance_phase(adv, incs, -7)
    assert torch.equal(back, ph)
    ang = osc.phase_angles(ph, incs, 4)
    assert ang.shape == (3, 4)
    for c in range(3):
        assert torch.equal(ang[c], osc.phase_angles(ph[c], int(incs[c]), 4))


def test_the_work_of_the_fused_stage_by_hand():
    n_bytes, n_ops = fm_fused_work(1000, 10, 15, 3)
    assert n_bytes == 1000 * 8 + 3 * 15 * 4 + 10 * 4
    assert n_ops == 3 * (6 * 1000 + 4 * 10 * 15 + 6 * 15)


# -- the configuration and its cell ----------------------------------------------------


def test_load_spec_reports_the_cell_s_metrics():
    """(f) ``nbfm.capture`` reports capture_msps and setup_s end to end, the
    two FM-fused roofline shares, the resampler's share inside the tick,
    and the capture cells' tick gap and device idle share, on the capture
    mix."""
    spec = run.load_spec("nbfm.capture")
    assert spec["cell"] == {**spec["cell"], "config": "nbfm_marine57", "traffic": "capture", "chips": 1}
    assert {m["name"] for m in spec["end_to_end"]} == {"capture_msps", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == {"fm_fused_roofline_pct", "fm_fused_tick_roofline_pct",
                                                     "resampler_tick_roofline_pct", "tick_gap_us.capture",
                                                     "device_idle_pct.capture"}
    assert spec["traffic"]["mode"] == "replay"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}["nbfm_marine57"]
    assert conf["reduced"] == [] and conf["source"] == CONFIG["source"] and len(conf["source"]) <= 200


def test_the_configuration_s_channels_sizes_and_reference_agree():
    """(f) 57 offsets every 25 kHz, whole multiples of fs / period, the same
    in the build, the reference and the signal; the granule divides the
    tick; the reference's taps are the program's."""
    cfg = CONFIG
    offsets = cfg["build"]["kwargs"]["offsets"]
    assert offsets == list(range(-700000, 700001, 25000)) and len(offsets) == 57
    assert offsets == cfg["reference"]["offsets"] == cfg["signal"]["station_offsets_hz"]
    res = cfg["rf_sample_rate"] / cfg["signal"]["period"]
    assert all(f % res == 0 for f in offsets)
    assert cfg["tick"] % GRANULE == 0 and cfg["tick"] + GRANULE > 1_280_000
    assert cfg["signal"]["station_amplitude"] * 57 + 5 * cfg["signal"]["noise_rms"] < 127 / 128
    plan = check.reference_module(cfg).plan(cfg["reference"])
    chain, info = nbfm_channels(**cfg["build"]["kwargs"])
    assert chain.granule == GRANULE and info["num_channels"] == 57
    np.testing.assert_array_equal(chain.get_block("frontend").taps.numpy(), plan["rf_taps"].astype(np.float32))
    assert (plan["up"], plan["dn"], plan["down"]) == (*info["resampler"], info["rf_decimation"])


def test_a_whole_run_of_the_cell_on_the_cpu_is_correct():
    """The harness's own run of ``nbfm.capture`` cut to 4 ticks of 16,500."""
    sizes = {"tick": 2 * GRANULE, "recording_ticks": 4, "period": 200000}
    r = run.run_cell("nbfm.capture", 2**33 + 41, 0.5, False, "cpu", sizes=sizes, say=lambda _: None)
    assert r["correct"], r["check"]
    assert set(r["metrics"]) == {"capture_msps", "setup_s"}
    assert r["check"]["audio_peak_err_db"]["value"] < -100.0


def test_a_checkpoint_of_the_channels_carry_round_trips(built, tmp_path):
    """The (C,) phases are stored as uint32 and come back as phases."""
    from tpusdr_torch.graph.checkpoint import load_state, save_state

    chain, _ = built
    state = chain.init_state()
    x = torch.from_numpy(_fm_tones(np.random.default_rng(9), GRANULE, OFFSETS))
    state, _ = chain.apply(state, x)
    save_state(str(tmp_path / "c.npz"), state)
    back = load_state(str(tmp_path / "c.npz"), chain.init_state())
    assert osc.is_phase(back["frontend"]["phase"]) and torch.equal(back["frontend"]["phase"], state["frontend"]["phase"])
    _, y1 = chain.apply(state, x)
    _, y2 = chain.apply(back, x)
    assert torch.equal(y1, y2)
