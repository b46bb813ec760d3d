"""The port's polyphase channelizer, Channelizer block, channel axis, FM
channel bank, channels app, ``create_session`` and ``fir_full`` against the
JAX package on the CPU, from the same numpy input.

Tolerances: channelizer and FIR outputs within 1e-5 of the output's peak,
carries equal (float32 on both sides; the port's FFT and the JAX package's
matmul DFT sum in another order); discriminator outputs within 1e-5 *
gain (the JAX package's polynomial atan against atan2); bank audio at
<= -80 dB error energy against JAX.  The identities the JAX package's own
tests check (channel k equals downconvert-filter-decimate, the tone in its
channel, streaming invariance, both layouts) run on the port at M = 8 and
M = 64.
"""

import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusdr.graph import blocks as JB
from tpusdr.graph.chain import Chain as JChain
from tpusdr.graph.graph import build_graph as jbuild_graph
from tpusdr.models import multichannel as JM
from tpusdr.ops import channelizer as jchan
from tpusdr.ops import cplx as jcplx
from tpusdr.ops import fir as jfir
from tpusdr.session import create_session as jcreate_session
from tpusdr_torch import convert
from tpusdr_torch import kernels
from tpusdr_torch.apps import channels as tchannels
from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.graph import build_graph
from tpusdr_torch.graph.registry import get_registry
from tpusdr_torch.graph.runner import StreamRunner
from tpusdr_torch.io.sinks import CollectSink
from tpusdr_torch.models import multichannel as TM
from tpusdr_torch.ops import channelizer as tchan
from tpusdr_torch.ops import fir as tfir
from tpusdr_torch.ops import resample as tres
from tpusdr_torch.session import create_session

torch.set_num_threads(1)

AUDIO_DB = -80.0


@pytest.fixture
def rng():
    return np.random.default_rng(71)


def crandn(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def np_out(y):
    return jcplx.to_numpy(y) if isinstance(y, jcplx.Complex) else np.asarray(y)


def jin(z):
    return jcplx.from_numpy(z) if np.iscomplexobj(z) else jnp.asarray(z)


def close_to_peak(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def err_db(ref, got):
    return 10 * np.log10(np.sum(np.abs(ref - got) ** 2) / np.sum(np.abs(ref) ** 2))


def tone_snr(x, f0, fs):
    """Least-squares fit of a tone at f0: (amplitude, SNR in dB), as
    tests/test_models_e2e.py fits it."""
    t = np.arange(len(x)) / fs
    basis = np.stack([np.sin(2 * np.pi * f0 * t), np.cos(2 * np.pi * f0 * t)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, x, rcond=None)
    fit = basis @ coef
    resid = x - fit - np.mean(x - fit)
    return float(np.hypot(*coef)), float(10 * np.log10(np.mean(fit**2) / max(np.mean(resid**2), 1e-30)))


def t_apply(state, z, plan, channel_major=False):
    s, y = tchan.channelize_apply(state, torch.from_numpy(z), plan, channel_major)
    return s, y.numpy()


# -- the op ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("channel_major", [False, True])
def test_channelize_equals_jax(rng, m, channel_major):
    """Three ticks through both packages: outputs within 1e-5 of peak,
    carries equal, in either layout."""
    taps = tchan.design_prototype(m, taps_per_channel=6)
    np.testing.assert_array_equal(taps, jchan.design_prototype(m, taps_per_channel=6))
    pj, pt = jchan.make_plan(taps, m, m * 40), tchan.make_plan(taps, m, m * 40)
    assert pt.history == pj.history == 6 * m - 1
    js, ts = jchan.channelize_init(pj), tchan.channelize_init(pt)
    for _ in range(3):
        z = crandn(rng, m * 40)
        js, jy = jchan.channelize_apply(js, jin(z), pj, channel_major)
        ts, ty = t_apply(ts, z, pt, channel_major)
        close_to_peak(ty, np_out(jy))
        np.testing.assert_array_equal(ts.numpy(), np_out(js))


@pytest.mark.parametrize("m", [8, 64])
def test_channel_equals_downconvert_filter_decimate(rng, m):
    """Channel k is shift-by-k*fs/M, low-pass, decimate by M: the identity
    that pins the taps, the index, the lane flip and the DFT's sign."""
    taps = tchan.design_prototype(m, taps_per_channel=8)
    block = m * 64
    plan = tchan.make_plan(taps, m, block)
    z = crandn(rng, block)
    _, y = t_apply(tchan.channelize_init(plan), z, plan)  # (F, M)
    padded = np.concatenate([np.zeros(plan.history, np.complex64), z])
    n_idx = np.arange(len(padded)) - plan.history
    for k in [0, 1, 3, m // 2 + 1, m - 1]:
        shifted = padded * np.exp(-2j * np.pi * k * n_idx / m)
        filt = np.convolve(shifted, taps.astype(np.float64), mode="full")
        np.testing.assert_allclose(y[:, k], filt[plan.history : plan.history + block : m], atol=1e-4)


@pytest.mark.parametrize("m", [8, 64])
def test_tone_lands_in_right_channel(m):
    taps = tchan.design_prototype(m)
    block = m * 256
    plan = tchan.make_plan(taps, m, block)
    k0 = 5
    f0 = k0 / m + 0.3 / m  # off centre within channel k0
    z = np.exp(2j * np.pi * f0 * np.arange(block)).astype(np.complex64)
    _, y = t_apply(tchan.channelize_init(plan), z, plan)
    powers = np.mean(np.abs(y[32:]) ** 2, axis=0)  # past the filter's transient
    assert powers.argmax() == k0
    others = np.delete(powers, k0)
    assert 10 * np.log10(others.max() / powers[k0]) < -50  # adjacent-channel rejection


@pytest.mark.parametrize("m", [8, 64])
def test_streaming_invariance(rng, m):
    """Four ticks one after another equal one tick of their length."""
    taps = tchan.design_prototype(m, taps_per_channel=6)
    block = m * 32
    plan = tchan.make_plan(taps, m, block)
    z = crandn(rng, 4 * block)
    s, outs = tchan.channelize_init(plan), []
    for i in range(0, len(z), block):
        s, y = t_apply(s, z[i : i + block], plan)
        outs.append(y)
    big = tchan.make_plan(taps, m, len(z))
    s_big, whole = t_apply(tchan.channelize_init(big), z, big)
    np.testing.assert_allclose(np.concatenate(outs, axis=0), whole, atol=1e-5)
    np.testing.assert_array_equal(s.numpy(), s_big.numpy())


@pytest.mark.parametrize("m", [8, 64])
def test_channel_major_matches_row_major(rng, m):
    """channel_major=True is the transpose of the row-major result, and
    both forms carry the same state, over two ticks."""
    taps = tchan.design_prototype(m, taps_per_channel=6)
    plan = tchan.make_plan(taps, m, m * 32)
    z = crandn(rng, m * 32)
    s1 = s2 = tchan.channelize_init(plan)
    for _ in range(2):
        s1, y_fm = t_apply(s1, z, plan)
        s2, y_cm = t_apply(s2, z, plan, channel_major=True)
        np.testing.assert_array_equal(y_fm.T, y_cm)
        np.testing.assert_array_equal(s1.numpy(), s2.numpy())


def test_channelize_refuses_a_block_of_another_length(rng):
    plan = tchan.make_plan(tchan.design_prototype(8), 8, 64)
    with pytest.raises(ValueError, match="expected block of 64"):
        tchan.channelize_apply(tchan.channelize_init(plan), torch.zeros(72, dtype=torch.complex64), plan)
    with pytest.raises(ValueError, match="not divisible"):
        tchan.make_plan(tchan.design_prototype(8), 8, 60)


# -- the block ------------------------------------------------------------------------


def test_channelizer_block_history_is_its_carry(rng):
    """Reference fault 10 (ROADMAP.md §3): with T = 50 taps and M = 8 the JAX block's
    ``history`` is T - 1 = 49 while its carry is ceil(T/M)*M - 1 = 55
    samples.  The port sizes both from the padded length; its outputs and
    carry equal the JAX block's."""
    m, taps = 8, tchan.design_prototype(8, taps_per_channel=7)[:50]
    jb, tb = JB.Channelizer(m, taps=taps), TB.Channelizer(m, taps=taps)
    assert (jb.history, np_out(jb.init_state()).shape) == (49, (55,))  # the JAX block's mismatch
    assert tb.history == tuple(tb.init_state().shape)[-1] == 55
    assert (tb.down, tb.num_channels, tb.adds_channel_axis, tb.granule) == (8, 8, True, 8)
    assert get_registry()["Channelizer"] is TB.Channelizer
    js, ts = jb.init_state(), tb.init_state()
    for _ in range(3):
        z = crandn(rng, m * 24)
        js, jy = jb.apply(js, jin(z))
        ts, ty = tb.apply(ts, torch.from_numpy(z))
        assert ty.shape == (m, 24)  # channel-major
        close_to_peak(ty.numpy(), np_out(jy))
        np.testing.assert_array_equal(ts.numpy(), np_out(js))


def test_channelizer_block_taps_update(rng):
    """A taps update replans and resizes ``history``; a carry sized for the
    old taps raises."""
    tb = TB.Channelizer(8, taps_per_channel=4)
    z = torch.from_numpy(crandn(rng, 64))
    old = tb.init_state()
    tb.apply(old, z)
    new_taps = tchan.design_prototype(8, taps_per_channel=6)
    tb.update_parameters(taps=new_taps)
    assert tb.history == 47
    with pytest.raises(ValueError, match="fresh init_state"):
        tb.apply(old, z)
    jb = JB.Channelizer(8, taps=new_taps)
    _, ty = tb.apply(tb.init_state(), z)
    _, jy = jb.apply(jb.init_state(), jin(z.numpy()))
    close_to_peak(ty.numpy(), np_out(jy))


def test_chain_widens_the_batch_after_the_channelizer():
    """F5 (ROADMAP.md §3): every block after a channel-adding block gets a carry with the
    channel axis, as the JAX Chain gives it; the chain reports the axis."""
    m = 8
    blocks = lambda B: [("chan", B.Channelizer(m, taps_per_channel=4)), ("dem", B.QuadFmDemod(gain=1.0)),
                        ("de", B.Deemphasis(128e3)), ("rs", B.Resampler(1, 8))]
    jc, tc = JChain(blocks(JB)), Chain(blocks(TB))
    assert (tc.adds_channel_axis, tc.num_channels, tc.granule) == (True, m, jc.granule) == (True, m, 64)
    for batch in [(), (3,)]:
        js, ts = jc.init_state(batch), tc.init_state(batch)
        jshapes = {k: np_out(v).shape for k, v in js.items()}
        tshapes = {k: tuple(v.shape) for k, v in ts.items()}
        assert tshapes == jshapes
        assert tshapes["dem"] == batch + (m, 1) and tshapes["rs"][:-1] == batch + (m,)
    assert not Chain([("dem", TB.QuadFmDemod(gain=1.0))]).adds_channel_axis


@pytest.mark.parametrize("rate,m,granule", [(20.48e6, 64, 1280), (5.12e6, 16, 320)])
def test_bank_granule_equals_jax(rate, m, granule):
    tc, tinfo = TM.fm_channel_bank(rate, m, 16000.0)
    jc, jinfo = JM.fm_channel_bank(rate, m, 16000.0)
    assert tc.granule == jc.granule == granule
    assert (tc.up, tc.down, tc.history) == (jc.up, jc.down, jc.history)
    assert tinfo == jinfo


def graph_spec(m):
    return {
        "nodes": {"chan": {"type": "Channelizer", "numChannels": m, "tapsPerChannel": 4},
                  "dem": {"type": "QuadDemod", "modulation": "Fm", "sampleRate": 128e3, "fskDeviation": 40e3}},
        "connections": [{"source": "chan", "sink": "dem"}],
        "inputPorts": [{"exposedPort": 0, "mapped": {"node": "chan", "port": 0}}],
        "outputPort": "dem",
    }


def test_graph_widens_the_batch_after_the_channelizer(rng):
    """The other half of F5, and reference fault 11: the JAX Graph passes
    one batch shape to every node, so Channelizer -> QuadDemod fails in
    JAX at its first tick (the demod's carry lacks the channel axis).  The
    port's Graph widens along the edges, and its output equals the port's
    Chain on the same blocks."""
    m = 8
    jg = jbuild_graph(graph_spec(m))
    with pytest.raises(TypeError):
        jg.apply(jg.init_state(), jin(crandn(rng, m * 16)))
    g = build_graph(graph_spec(m))
    assert (g.adds_channel_axis, g.num_channels) == (True, m)
    chain = Chain([("chan", g.get_block("chan")), ("dem", g.get_block("dem"))])
    for batch in [(), (2,)]:
        gs, cs = g.init_state(batch), chain.init_state(batch)
        assert {k: tuple(v.shape) for k, v in gs.items()} == {k: tuple(v.shape) for k, v in cs.items()}
        assert tuple(gs["dem"].shape) == batch + (m, 1)
        for _ in range(2):
            z = torch.from_numpy(crandn(rng, *batch, m * 16))
            gs, gy = g.apply(gs, z)
            cs, cy = chain.apply(cs, z)
            assert gy.shape == batch + (m, 16)
            assert torch.equal(gy, cy)


# -- the batched stages after it --------------------------------------------------------


@pytest.mark.parametrize("kind", ["demod", "deemph", "resampler"])
def test_batched_stages_equal_jax(rng, kind):
    """QuadFmDemod, Deemphasis and Resampler(1, 20) on (2, 8, n) streams
    against JAX over two ticks, with the carries."""
    m, n = 8, 400
    gain = 0.5
    if kind == "demod":
        jb, tb, make, rel = JB.QuadFmDemod(gain=gain), TB.QuadFmDemod(gain=gain), crandn, 1e-5 * gain
    elif kind == "deemph":
        jb, tb, make, rel = JB.Deemphasis(320e3), TB.Deemphasis(320e3), None, 1e-5
    else:
        jb, tb, make, rel = JB.Resampler(1, 20), TB.Resampler(1, 20), None, 1e-5
    if make is None:
        make = lambda r, *s: r.standard_normal(s).astype(np.float32)
    js, ts = jb.init_state((2, m)), tb.init_state((2, m))
    for _ in range(2):
        x = make(rng, 2, m, n)
        js, jy = jb.apply(js, jin(x))
        ts, ty = tb.apply(ts, torch.from_numpy(x))
        ref = np_out(jy)
        assert ty.shape == ref.shape
        np.testing.assert_allclose(ty.numpy(), ref, rtol=0, atol=rel * max(1.0, np.abs(ref).max()))
        np.testing.assert_allclose(convert.state_to_numpy(ts), np.asarray(jax.tree.map(np.asarray, js)),
                                   rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_resampler_moves_its_taps_to_the_device_once(rng, monkeypatch):
    """The bank's Resampler(1, 20), a decimating FIR, and a (3, 25) one
    build their taps on the stream's device once a tick length, not every
    step: a copy from host memory each step would wait for the device."""
    calls, real = [], tres.plan_taps
    monkeypatch.setattr(tres, "plan_taps", lambda plan, device=None: calls.append(plan.up) or real(plan, device))
    for up, down in ((1, 20), (3, 25)):
        blk = TB.Resampler(up, down)
        s = blk.init_state((4,))
        for _ in range(3):
            s, _ = blk.apply(s, torch.from_numpy(rng.standard_normal((4, 1000)).astype(np.float32)))
    assert calls == [1, 3]


# -- the bank -------------------------------------------------------------------------


def two_station_ticks(fs, m, n_ticks, tick, dev, k1, k2, f1, f2, noise=0.0):
    """Two FM stations on channels k1 and k2, continuous over the ticks,
    plus white noise of rms ``noise`` (seeded) in I and in Q."""
    t = np.arange(n_ticks * tick) / fs

    def fm(fk, fa):
        return np.exp(1j * (2 * np.pi * fk * t + 2 * np.pi * dev * np.cumsum(np.sin(2 * np.pi * fa * t)) / fs))

    z = 0.5 * fm(k1 * fs / m, f1) + 0.5 * fm(k2 * fs / m, f2)
    if noise:
        rng = np.random.default_rng(5)
        z = z + noise * (rng.standard_normal(len(z)) + 1j * rng.standard_normal(len(z)))
    return z.astype(np.complex64).reshape(n_ticks, tick)


def test_bank_equals_jax():
    """fm_channel_bank at (1.024 Msps, 8 channels) over 3 ticks: audio at
    <= -80 dB against JAX, every carry within 1e-5, and no single-stream
    kernel wrapper called.  The input carries a noise floor so that every
    channel holds a signal: a channel with no station holds only the
    prototype's -60 dB leakage, whose phase is float32 rounding, and there
    the discriminators of any two float32 implementations differ by
    rounding (1.2e-5 on the empty channel 0's de-emphasis carry without
    the noise, against the 1e-5 bar)."""
    fs, m = 1.024e6, 8
    jc, _ = JM.fm_channel_bank(fs, m, 16000.0)
    tc, info = TM.fm_channel_bank(fs, m, 16000.0)
    tick = tc.granule * 64
    ticks = two_station_ticks(fs, m, 3, tick, 32e3, 2, 5, 900.0, 1300.0, noise=0.05)
    js, ts = jc.init_state(), tc.init_state()
    kernels.reset_launch_counts()
    for z in ticks:
        js, jy = jc.apply(js, jin(z))
        ts, ty = tc.apply(ts, torch.from_numpy(z))
        ref = np_out(jy)
        assert ty.shape == ref.shape == (m, tick // 64)
        assert err_db(ref, ty.numpy()) <= AUDIO_DB
    assert not any(w.launches for w in kernels.WRAPPERS)
    ref_state = jax.tree.map(np.asarray, js)
    got = convert.state_to_numpy(ts)
    assert set(got) == set(ref_state) == {"channelizer", "demod", "deemph", "audio"}
    np.testing.assert_array_equal(np.asarray(got["channelizer"]), np.asarray(ref_state["channelizer"]))
    for k in ("demod", "deemph", "audio"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref_state[k]), rtol=0, atol=1e-5)


def test_two_stations_demodulated_independently():
    """tests/test_models_e2e.py's two-station bank on the port alone,
    through a StreamRunner: each channel decodes its own tone at SNR > 30
    dB over the second half, with cross-talk under a tenth."""
    fs, m = 1.024e6, 8
    chain, info = TM.fm_channel_bank(fs, m, audio_rate=16000.0, deemphasis_tau=None)
    k1, k2, f1, f2 = 2, 5, 900.0, 1300.0
    tick = chain.granule * max(1, (1 << 17) // chain.granule)
    ticks = two_station_ticks(fs, m, 6, tick, min(75e3, info["channel_rate"] / 4), k1, k2, f1, f2)
    sink = CollectSink()
    _, stats = StreamRunner(chain, device="cpu").run(iter(ticks), sink)
    audio = sink.result()
    assert audio.shape == (m, 6 * tick // 64) and stats.samples_in == 6 * tick
    half = audio.shape[-1] // 2
    a1, snr1 = tone_snr(audio[k1, half:], f1, info["audio_rate"])
    a2, snr2 = tone_snr(audio[k2, half:], f2, info["audio_rate"])
    assert snr1 > 30.0 and snr2 > 30.0, (snr1, snr2)
    a_cross, _ = tone_snr(audio[k2, half:], f1, info["audio_rate"])
    assert a_cross < 0.1 * a2, (a_cross, a2)


def test_converted_bank_state_continues_as_jax(rng):
    """A JAX bank's carry after 2 ticks, converted, continues in the port to
    the JAX bank's audio; and the port's carry converts back."""
    fs, m = 1.024e6, 8
    jc, _ = JM.fm_channel_bank(fs, m, 16000.0)
    jblk = jc.get_block("channelizer")
    tc = convert.chain_from_numpy([
        ("channelizer", "Channelizer", {"num_channels": m, "taps": jblk.taps}),
        ("demod", "QuadFmDemod", {"gain": jc.get_block("demod").gain}),
        ("deemph", "Deemphasis", {"sample_rate": fs / m, "a": jc.get_block("deemph").a,
                                  "b": jc.get_block("deemph").b}),
        ("audio", "Resampler", {"up": 1, "down": 8, "taps": jc.get_block("audio").taps}),
    ])
    tick = jc.granule * 32
    ticks = two_station_ticks(fs, m, 4, tick, 32e3, 2, 5, 900.0, 1300.0)
    js = jc.init_state()
    for z in ticks[:2]:
        js, _ = jc.apply(js, jin(z))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js))
    assert tuple(ts["demod"].shape) == (m, 1) and ts["demod"].dtype == torch.complex64
    assert tuple(ts["deemph"].shape) == (m, 1) and tuple(ts["channelizer"].shape) == (jblk.init_state().shape[-1],)
    for z in ticks[2:]:
        js, jy = jc.apply(js, jin(z))
        ts, ty = tc.apply(ts, torch.from_numpy(z))
        assert err_db(np_out(jy), ty.numpy()) <= AUDIO_DB
    back = convert.state_to_numpy(ts)
    np.testing.assert_array_equal(np.asarray(back["channelizer"]), np.asarray(jax.tree.map(np.asarray, js)["channelizer"]))


# -- the app, the session, fir_full -------------------------------------------------------


def read_wav(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.float64) / 32767, w.getframerate()


@pytest.mark.parametrize("fmt", ["cf32", "int8"])
def test_channels_app_on_the_cpu(tmp_path, capsys, fmt):
    """The app at 8 channels, 1.024 Msps, from complex64 samples and from
    packed int8 words (through IqToComplex): the WAVs of channels 2 and 5
    hold their stations' tones (700 Hz, 1,200 Hz) at SNR > 30 dB over the
    second half, each without the other's."""
    rc = tchannels.main(["--device", "cpu", "--rf-rate", "1.024e6", "--channels", "8", "--duration", "1",
                         "--tick", str(1 << 17), "--write", "2,5", "--out-dir", str(tmp_path), "--format", fmt])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("8 channels: 0.92 M RF samples in ") and "Msps); wrote [2, 5] to " in line
    for c, f, other in ((2, 700.0, 1200.0), (5, 1200.0, 700.0)):
        x, fs = read_wav(tmp_path / f"ch{c:03d}.wav")
        assert fs == 16000 and len(x) == 7 * (1 << 17) // 64
        a, snr = tone_snr(x[len(x) // 2 :], f, fs)
        a_other, _ = tone_snr(x[len(x) // 2 :], other, fs)
        assert snr > 30.0 and a_other < 0.1 * a, (c, snr, a, a_other)


def test_channels_app_needs_a_card_or_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tchannels.main(["--write", "2", "--out-dir", str(tmp_path)])
    assert e.value.code == 2 and "pass --device cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tchannels.main(["--device", "cpu", "--channels", "8", "--write", "8", "--out-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def session_spec(path):
    return {
        "nodes": {
            "src": {"type": "Synth", "kind": "fm", "sampleRate": 1.024e6, "carrierOffset": 256e3,
                    "audioHz": 1000.0, "deviation": 40e3, "numBlocks": 3},
            "chan": {"type": "Channelizer", "numChannels": 8, "tapsPerChannel": 6},
            "out": {"type": "RawWriter", "path": str(path), "dtype": "complex64"},
        },
        "connections": [{"source": "src", "sink": "chan"}, {"source": "chan", "sink": "out"}],
    }


def test_create_session_equals_jax(tmp_path):
    """A JSON spec (bytes) with a Channelizer through both packages'
    create_session: the same tick, counts and raw complex64 file."""
    spec = json.dumps(session_spec(tmp_path / "t.raw")).encode()
    app = create_session(spec, tick=1 << 12, device="cpu")
    japp = jcreate_session(json.dumps(session_spec(tmp_path / "j.raw")), tick=1 << 12)
    assert app.tick == japp.tick == 1 << 12
    stats, jstats = app.run(), japp.run()
    assert (stats.blocks, stats.samples_in, stats.samples_out) == (jstats.blocks, jstats.samples_in, jstats.samples_out)
    got, ref = np.fromfile(tmp_path / "t.raw", np.complex64), np.fromfile(tmp_path / "j.raw", np.complex64)
    assert got.shape == ref.shape == (3 * (1 << 12),)
    close_to_peak(got, ref)


@pytest.mark.parametrize("data,taps_kind,D", [("c", "r", 1), ("c", "r", 4), ("r", "r", 3), ("c", "c", 2)])
def test_fir_full_equals_jax(rng, data, taps_kind, D):
    """fir_full from a zero history, the tail short of a multiple of D
    dropped, against JAX within 1e-5 of peak."""
    x = crandn(rng, 2, 1001) if data == "c" else rng.standard_normal((2, 1001)).astype(np.float32)
    h = rng.standard_normal(37).astype(np.float32)
    if taps_kind == "c":
        h = (h * np.exp(0.3j * np.arange(37))).astype(np.complex64)
    got = tfir.fir_full(torch.from_numpy(x), torch.from_numpy(h), D, "mxu").numpy()
    ref = np_out(jfir.fir_full(jin(x), jin(h), D, "mxu"))
    assert got.shape == ref.shape == (2, 1001 // D)
    close_to_peak(got, ref)
