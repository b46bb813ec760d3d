"""The port's blocks and ``fm_receiver`` against the JAX package on the CPU:
outputs and carries, tick by tick, from the same numpy input.

Tolerances: block outputs within 1e-5 of the output's peak (complex FIR
outputs; float32 on both sides, only the summation order differs) or
within 1e-5 * gain (discriminator outputs: the JAX package's polynomial
atan against atan2); chain audio at <= -80 dB error energy against JAX;
carries within 1e-5 of max(1, peak), NCO phases and FIR tails exactly.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpusdr.graph import blocks as JB
from tpusdr.models import receiver as JR
from tpusdr.ops import cplx as jcplx
from tpusdr.ops import osc as josc
from tpusdr_torch import convert
from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.io.sources import SyntheticIqSource
from tpusdr_torch.models import receiver as TR

torch.set_num_threads(1)

AUDIO_DB = -80.0


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def fm_tone(rng, n, fs, offset, deviation=75e3):
    t = np.arange(n) / fs
    ph = 2 * np.pi * offset * t + 2 * np.pi * deviation * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / fs
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (0.9 * np.exp(1j * ph) + 0.01 * noise).astype(np.complex64)


def np_out(y):
    return jcplx.to_numpy(y) if isinstance(y, jcplx.Complex) else np.asarray(y)


def close_to_peak(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def err_db(ref, got):
    return 10 * np.log10(np.sum(np.abs(ref - got) ** 2) / np.sum(np.abs(ref) ** 2))


def assert_carry_close(jstate, tstate, path="state", rel=1e-5):
    """The port's carry (taken to the JAX layout) against the JAX carry."""
    ref = jax.tree.map(np.asarray, jstate)
    got = convert.state_to_numpy(tstate)
    _carry_close(ref, got, path, rel)


def _carry_close(ref, got, path, rel=1e-5):
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _carry_close(ref[k], got[k], f"{path}/{k}", rel)
    elif isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref), path
        for i, (r, g) in enumerate(zip(ref, got)):
            _carry_close(r, g, f"{path}[{i}]", rel)
    else:
        ref, got = np.asarray(ref), np.asarray(got)
        assert ref.shape == got.shape, path
        if ref.dtype == np.uint32:
            assert int(ref) == int(got), path
        elif ref.size:
            tol = rel * max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=path)


def jax_block_params(name, jb):
    """(name, kind, params) of a JAX block's numbers, for convert.chain_from_numpy."""
    if isinstance(jb, JB.FreqShiftFir):
        return name, "FreqShiftFir", dict(
            sample_rate=jb.sample_rate, frequency=jb.frequency, taps=np.asarray(jb.taps),
            decimation=jb.decimation, mode=jb.mode, inc=int(jb.inc))
    if isinstance(jb, JB.FusedFmDemod):
        return name, "FusedFmDemod", dict(
            sample_rate=jb.sample_rate, frequency=jb.frequency, taps=np.asarray(jb.taps),
            decimation=jb.decimation, gain=jb.gain, inc=int(jb.inc))
    if isinstance(jb, JB.QuadFmDemod):
        return name, "QuadFmDemod", dict(gain=jb.gain)
    if isinstance(jb, JB.Deemphasis):
        return name, "Deemphasis", dict(sample_rate=jb.sample_rate, tau=jb.tau, a=jb.a, b=jb.b)
    if isinstance(jb, JB.Resampler):
        return name, "Resampler", dict(up=jb.up, down=jb.down, taps=np.asarray(jb.taps))
    if isinstance(jb, JB.FreqShift):
        return name, "FreqShift", dict(sample_rate=jb.sample_rate, frequency=jb.frequency, inc=int(jb.inc))
    if isinstance(jb, JB.Fir):
        sig = "FloatComplex" if jb.in_dtype == jnp.complex64 else "Float"
        return name, "Fir", dict(taps=np.asarray(jb.taps), decimation=jb.decimation,
                                 signal_type=sig, mode=jb.mode)
    if isinstance(jb, JB.IqToComplex):
        return name, "IqToComplex", dict(input_format=jb.input_format)
    if isinstance(jb, JB.QuadAmDemod):
        return name, "QuadAmDemod", {}
    if isinstance(jb, JB.DcBlock):
        return name, "DcBlock", dict(pole=jb.pole)
    raise TypeError(f"no port for {type(jb).__name__}")


def stream_both(jblk, tblk, ticks):
    """Apply a JAX block and its port to the same ticks; yields per tick
    (jax output, port output) and returns the final carries."""
    js, ts = jblk.init_state(), tblk.init_state()
    outs = []
    for z in ticks:
        js, jy = jblk.apply(js, jcplx.from_numpy(z) if np.iscomplexobj(z) else jnp.asarray(z))
        ts, ty = tblk.apply(ts, torch.from_numpy(z))
        outs.append((np_out(jy), ty.numpy()))
    return outs, js, ts


# -- blocks -------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["auto", "banded", "mxu", "conv"])
def test_freqshiftfir_block(rng, mode):
    t = sps.firwin(89, 0.05).astype(np.float32)
    jb = JB.FreqShiftFir(1e6, -150e3, t, 8, mode=mode)
    tb = TB.FreqShiftFir(1e6, -150e3, t, 8, mode=mode)
    assert tb.inc == int(jb.inc)
    z = fm_tone(rng, 3 * 8192, 1e6, 150e3)
    outs, js, ts = stream_both(jb, tb, np.split(z, 3))
    for jy, ty in outs:
        close_to_peak(ty, jy)
    assert_carry_close(js, ts)


@pytest.mark.parametrize("mode", ["auto", "banded", "mxu", "conv"])
def test_fir_block(rng, mode):
    t = sps.firwin(65, 0.1).astype(np.float32)
    jb, tb = JB.Fir(t, 8, mode=mode), TB.Fir(t, 8, mode=mode)
    z = fm_tone(rng, 3 * 4096, 1e6, 0.0)
    outs, js, ts = stream_both(jb, tb, np.split(z, 3))
    for jy, ty in outs:
        close_to_peak(ty, jy)
    assert_carry_close(js, ts)


def test_fir_block_pallas_mode(rng):
    """Fir(mode='pallas') streams like JAX's, whose K4 kernel runs in
    interpret mode here; the port's CPU path is K4's plain version."""
    t = sps.firwin(65, 0.1).astype(np.float32)
    jb, tb = JB.Fir(t, 8, mode="pallas"), TB.Fir(t, 8, mode="pallas")
    outs, js, ts = stream_both(jb, tb, np.split(fm_tone(rng, 3 * 4096, 1e6, 0.0), 3))
    for jy, ty in outs:
        close_to_peak(ty, jy)
    assert_carry_close(js, ts)


def test_freqshift_block(rng):
    jb, tb = JB.FreqShift(2e6, -300e3, 0.2), TB.FreqShift(2e6, -300e3, 0.2)
    outs, js, ts = stream_both(jb, tb, np.split(fm_tone(rng, 3000, 2e6, 300e3), 3))
    for jy, ty in outs:
        np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5)
    assert int(js) == ts


@pytest.mark.parametrize(
    "branch,T,D,cuts",
    [
        ("prelude", 65, 8, [48 * 1024] * 3),  # whole 8G rows: prelude form
        ("mixed", 65, 8, [48 * 1024, 48 * 1024 + 64, 48 * 1024]),  # row, non-row, row
        ("fm_fused", 728, 66, [66 * 500] * 3),  # banded rule rejects: FM-fused
    ],
)
def test_fused_fm_demod_branches(rng, branch, T, D, cuts):
    fs = 1e6 if T == 65 else 2e6
    f_off = 150e3 if T == 65 else 100e3
    t = sps.firwin(T, 0.1 if T == 65 else 0.007).astype(np.float32)
    jb = JB.FusedFmDemod(fs, -f_off, t, D, gain=1.7)
    tb = TB.FusedFmDemod(fs, -f_off, t, D, gain=1.7)
    assert tb.granule == jb.granule and tb._rows_capable == jb._rows_capable
    assert tb._rows_capable == (branch != "fm_fused")
    # deviation inside the passband: on stopband samples the discriminator
    # amplifies the JAX prelude kernel's bf16 hi/lo rounding far past 1e-5
    z = fm_tone(rng, sum(cuts), fs, f_off, 20e3 if T == 65 else 5e3)
    outs, js, ts = stream_both(jb, tb, np.split(z, np.cumsum(cuts)[:-1]))
    for jy, ty in outs:
        np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5 * 1.7)
    assert_carry_close(js, ts)


# -- the receiver --------------------------------------------------------------------


CONFIGS = {
    "wbfm2M_default": ((2e6, 300e3, JR.WBFM), {}, 40000, 3),
    "wbfm2M_fused": ((2e6, 300e3, JR.WBFM), {"use_fused": True}, 128000, 3),
    "nbfm2M_fused": ((2e6, 100e3, JR.NBFM), {"use_fused": True}, 33000, 3),
    "wbfm20M_default": ((20e6, 2.5e6, JR.WBFM), {}, 1280000, 2),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_fm_receiver_matches_jax(rng, config):
    """Audio and every carry, tick by tick.  The port chain is built twice,
    from its own design code and from the JAX blocks' numbers, and the two
    give identical audio; each tick is also run from the JAX carry taken
    across with convert.state_from_numpy."""
    args, kw, tick, n_ticks = CONFIGS[config]
    jchain, jspec = JR.fm_receiver(*args, **kw)
    tchain, tspec = TR.fm_receiver(*args, **kw)
    assert tchain.granule == jchain.granule and tick % tchain.granule == 0
    assert tspec == TR.ReceiverSpec(**jspec.__dict__)
    assert [n for n, _ in tchain.blocks] == [n for n, _ in jchain.blocks]
    nchain = convert.chain_from_numpy([jax_block_params(n, b) for n, b in jchain.blocks])
    deviation = 75e3 if args[2] == JR.WBFM else 5e3
    z = fm_tone(rng, n_ticks * tick, args[0], args[1], deviation)
    js, ts, ns = jchain.init_state(), tchain.init_state(), nchain.init_state()
    for i in range(n_ticks):
        blk = z[i * tick : (i + 1) * tick]
        # the JAX carry taken across mid-stream continues the stream too
        cs = convert.state_from_numpy(jax.tree.map(np.asarray, js))
        js, jy = jchain.apply(js, jcplx.from_numpy(blk))
        ts, ty = tchain.apply(ts, torch.from_numpy(blk))
        ns, ny = nchain.apply(ns, torch.from_numpy(blk))
        _, cy = tchain.apply(cs, torch.from_numpy(blk))
        jy, ty = np.asarray(jy), ty.numpy()
        assert ty.shape == jy.shape == (tchain.out_len(tick),)
        e = err_db(jy, ty)
        assert e <= AUDIO_DB, f"tick {i}: {e:.1f} dB"
        assert err_db(jy, cy.numpy()) <= AUDIO_DB, f"tick {i}: from the JAX carry"
        np.testing.assert_array_equal(ny.numpy(), ty)
        assert_carry_close(js, ts, f"tick {i}")


def test_wbfm_tone_decodes(rng):
    """The synthetic 1 kHz tone through the port on the CPU, checked by the
    verify skill's fit: amplitude ~0.34, SNR > 60 dB."""
    chain, spec = TR.fm_receiver(2e6, 300e3, TR.WBFM)
    src = SyntheticIqSource.fm(40000, 2e6, carrier_offset=300e3, num_blocks=12)
    state = chain.init_state()
    outs = []
    for blk in src:  # 20 ms blocks: whole periods of the 1 kHz tone
        state, y = chain.apply(state, torch.from_numpy(blk))
        outs.append(y.numpy())
    x = np.concatenate(outs).astype(np.float64)
    x = x[len(x) // 3 :]
    t = np.arange(len(x)) / spec.audio_rate
    b = np.stack([np.sin(2 * np.pi * 1000 * t), np.cos(2 * np.pi * 1000 * t)], 1)
    c, *_ = np.linalg.lstsq(b, x, rcond=None)
    fit = b @ c
    r = x - fit - (x - fit).mean()
    assert abs(np.hypot(*c) - 0.375 * 0.905) < 0.02
    assert 10 * np.log10((fit**2).mean() / (r**2).mean()) > 60.0


def test_synthetic_source_matches_jax():
    from tpusdr.io.sources import SyntheticIqSource as JSource

    got = list(SyntheticIqSource.fm(5000, 2e6, carrier_offset=300e3, num_blocks=3))
    ref = list(JSource.fm(5000, 2e6, carrier_offset=300e3, num_blocks=3))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_phase_carry_is_uint32_exact():
    blk = TB.FreqShiftFir(20e6, -2.5e6, np.ones(5, np.float32), 5)
    jblk = JB.FreqShiftFir(20e6, -2.5e6, np.ones(5, np.float32), 5)
    s = blk.advance_state(blk.init_state(), 10**9 + 5)
    js = jblk.advance_state(jblk.init_state(), 10**9 + 5)
    assert s["phase"] == int(js["phase"])
    assert int(josc.advance_phase(js["phase"], jblk.inc, 7)) == (s["phase"] + blk.inc * 7) % (1 << 32)


def test_import_leaves_jax_out():
    code = (
        "import sys, tpusdr_torch, tpusdr_torch.models, tpusdr_torch.convert, "
        "tpusdr_torch.kernels, tpusdr_torch.io.sources, tpusdr_torch.io.sinks, "
        "tpusdr_torch.graph.runner, tpusdr_torch.apps.receive; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert not any(m == 'tpusdr' or m.startswith('tpusdr.') for m in sys.modules)"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
