"""The AM slice of the port against the JAX package on the CPU: the IQ
converters, the AM blocks, the FIR block's 'pallas' / 'poly' / 'fft'
modes, ``am_receiver`` and the int8 FM receiver, from the same numpy
input made from a seed.

Tolerances: converter outputs bit for bit; FIR and envelope outputs
within 1e-5 of the output's peak (float32 on both sides, only the
summation order and the square root differ); chain audio at <= -80 dB
error energy against JAX; carries within 1e-5 of max(1, peak), FIR tails
and NCO phases exactly.  One exception: behind the DC block's pole at
0.999 and the audio band-pass (a D=1 FIR of 365 taps at 40 kHz), the
resampler's carry holds a slowly drifting DC level whose float32
rounding reaches 1.5e-5 of peak, so in that configuration the carries are
held to 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch
from test_torch_receiver import (
    assert_carry_close,
    close_to_peak,
    err_db,
    jax_block_params,
    stream_both,
)

from tpusdr.graph import blocks as JB
from tpusdr.models import receiver as JR
from tpusdr.ops import convert as jconvert
from tpusdr.ops import cplx as jcplx
from tpusdr.ops import demod as jdemod
from tpusdr_torch import convert
from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.io.sources import SyntheticIqSource
from tpusdr_torch.models import receiver as TR
from tpusdr_torch.ops import convert as tconvert
from tpusdr_torch.ops import demod as tdemod

torch.set_num_threads(1)

AUDIO_DB = -80.0


@pytest.fixture
def rng():
    return np.random.default_rng(41)


def am_tone(rng, n, fs, offset):
    """The CLI's AM test signal (50% AM at 700 Hz, carrier amplitude 0.5)
    plus a little noise."""
    t = np.arange(n) / fs
    z = 0.5 * (1.0 + 0.5 * np.sin(2 * np.pi * 700.0 * t)) * np.exp(2j * np.pi * offset * t)
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (z + 0.003 * noise).astype(np.complex64)


def int8_words(z):
    """complex -> packed int8 IQ words (the HackRF wire format as int16)."""
    inter = np.empty(2 * len(z), np.float32)
    inter[0::2], inter[1::2] = z.real, z.imag
    return np.clip(np.round(inter * 127.0), -128, 127).astype(np.int8).view(np.int16)


# -- IQ conversion -----------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["int8", "int16", "float32"])
def test_iq_to_complex_bit_exact(rng, fmt):
    n = 1000
    if fmt == "int8":
        x = rng.integers(-128, 128, 2 * n).astype(np.int8).view(np.int16)
    elif fmt == "int16":
        x = rng.integers(-32768, 32768, 2 * n).astype(np.int16).view(np.int32)
    else:
        x = rng.standard_normal(2 * n).astype(np.float32)
    jb, tb = JB.IqToComplex(fmt), TB.IqToComplex(fmt)
    assert (tb.up, tb.down, tb.granule) == (jb.up, jb.down, jb.granule)
    _, jy = jb.apply((), jnp.asarray(x))
    _, ty = tb.apply((), torch.from_numpy(x))
    assert ty.dtype == torch.complex64 and ty.shape == (n,)
    np.testing.assert_array_equal(ty.numpy(), jcplx.to_numpy(jy))


@pytest.mark.parametrize("fmt,raw", [("int8", np.int8), ("int16", np.int16)])
def test_iq_to_complex_rejects_raw_scalars(fmt, raw):
    x = np.zeros(64, raw)
    with pytest.raises(TypeError, match="packed"):
        JB.IqToComplex(fmt).apply((), jnp.asarray(x))
    with pytest.raises(TypeError, match="packed"):
        TB.IqToComplex(fmt).apply((), torch.from_numpy(x))


@pytest.mark.parametrize("name,raw", [("Int8ToFloat", np.int8), ("Int16ToFloat", np.int16)])
def test_int_to_float_blocks_bit_exact(rng, name, raw):
    info = np.iinfo(raw)
    x = rng.integers(info.min, info.max + 1, 999).astype(raw)
    _, jy = getattr(JB, name)().apply((), jnp.asarray(x))
    _, ty = getattr(TB, name)().apply((), torch.from_numpy(x))
    assert ty.dtype == torch.float32
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


# the rest of ops/convert.py, on a batched (2, n) input
CONVERT_INPUTS = {
    "int8_iq_to_complex": lambda rng: rng.integers(-128, 128, (2, 600)).astype(np.int8),
    "int16_iq_to_complex": lambda rng: rng.integers(-32768, 32768, (2, 600)).astype(np.int16),
    "float_to_int16": lambda rng: (1.5 * rng.standard_normal((2, 600))).astype(np.float32),
    "complex_to_interleaved": lambda rng: (
        rng.standard_normal((2, 300)) + 1j * rng.standard_normal((2, 300))
    ).astype(np.complex64),
    "pack_int8_words": lambda rng: rng.integers(-128, 128, (2, 600)).astype(np.int8),
    "pack_int16_words": lambda rng: rng.integers(-32768, 32768, (2, 600)).astype(np.int16),
}


@pytest.mark.parametrize("fn", list(CONVERT_INPUTS))
def test_convert_ops_bit_exact(rng, fn):
    x = CONVERT_INPUTS[fn](rng)
    if fn.startswith("pack_"):  # host-side numpy views in both packages
        ref, got = getattr(jconvert, fn)(x), getattr(tconvert, fn)(x)
    else:
        jy = getattr(jconvert, fn)(jcplx.from_numpy(x) if np.iscomplexobj(x) else jnp.asarray(x))
        ref = jcplx.to_numpy(jy) if isinstance(jy, jcplx.Complex) else np.asarray(jy)
        got = getattr(tconvert, fn)(torch.from_numpy(x)).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# -- AM blocks and ops --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["QuadAmDemod", "Magnitude", "AddConst", "AddConstToVectorLength"])
def test_am_elementwise_blocks(rng, name):
    z = (rng.standard_normal(777) + 1j * rng.standard_normal(777)).astype(np.complex64)
    z[5] = 0  # the zero sample keeps its zero magnitude
    params = {"AddConst": {"add_value": 0.37}, "AddConstToVectorLength": {"add_value_to_magnitude": -0.2}}
    kw = params.get(name, {})
    x = np.abs(z).astype(np.float32) if name == "AddConst" else z
    jb, tb = getattr(JB, name)(**kw), getattr(TB, name)(**kw)
    outs, _, _ = stream_both(jb, tb, [x])
    close_to_peak(outs[0][1], outs[0][0])


def test_quad_demod_node_dispatch():
    assert isinstance(TB.make_quad_demod("AM", sample_rate=1.0, channel_width=1.0), TB.QuadAmDemod)
    assert isinstance(TB.make_quad_demod("fm", gain=2.0), TB.QuadFmDemod)
    with pytest.raises(ValueError):
        TB.make_quad_demod("ssb")


def test_dc_block_streaming_with_carry(rng):
    x = (0.4 + 0.1 * rng.standard_normal(3 * 3000)).astype(np.float32)
    jb, tb = JB.DcBlock(), TB.DcBlock()
    outs, js, ts = stream_both(jb, tb, np.split(x, 3))
    for jy, ty in outs:
        close_to_peak(ty, jy)
    assert_carry_close(js, ts)


def test_dc_block_op_and_sample_counter(rng):
    x = rng.standard_normal((2, 500)).astype(np.float32)
    np.testing.assert_allclose(
        tdemod.dc_block(torch.from_numpy(x)).numpy(), np.asarray(jdemod.dc_block(jnp.asarray(x))), atol=1e-6
    )
    jb, tb = JB.SampleCountMonitor(), TB.SampleCountMonitor()
    js, ts = jb.init_state(), tb.init_state()
    for n in (100, 250):
        js, _ = jb.apply(js, jnp.zeros(n))
        ts, y = tb.apply(ts, torch.zeros(n))
    assert int(ts) == int(js) == 350
    assert convert.state_to_numpy(ts).dtype == np.int32
    assert int(convert.state_from_numpy(np.asarray(js))) == 350


# -- the FIR block's modes ------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode,signal,T,D",
    [
        ("pallas", "FloatComplex", 868, 250),  # K4's AM stage 1
        ("pallas", "FloatComplex", 46, 2),  # K4's AM stage 2
        ("pallas", "Float", 31, 1),  # ineligible (real data, D = 1): 'poly'
        ("poly", "FloatComplex", 65, 8),
        ("fft", "FloatComplex", 65, 8),
        ("fft", "Float", 101, 1),
    ],
)
def test_fir_block_modes_streaming(rng, mode, signal, T, D):
    t = sps.firwin(T, 0.8 / max(D, 2)).astype(np.float32)
    jb, tb = JB.Fir(t, D, signal, mode), TB.Fir(t, D, signal, mode)
    n = D * 300
    z = (rng.standard_normal(3 * n) + 1j * rng.standard_normal(3 * n)).astype(np.complex64)
    if signal == "Float":
        z = z.real.astype(np.float32)
    outs, js, ts = stream_both(jb, tb, np.split(z, 3))
    for jy, ty in outs:
        close_to_peak(ty, jy)
    assert_carry_close(js, ts)


def test_fir_block_pallas_batched_takes_poly(rng):
    """A batched stream is ineligible for K4 in both packages: 'poly'."""
    t = sps.firwin(33, 0.2).astype(np.float32)
    jb, tb = JB.Fir(t, 4, mode="pallas"), TB.Fir(t, 4, mode="pallas")
    z = (rng.standard_normal((2, 800)) + 1j * rng.standard_normal((2, 800))).astype(np.complex64)
    js, ts = jb.init_state((2,)), tb.init_state((2,))
    _, jy = jb.apply(js, jcplx.from_numpy(z))
    _, ty = tb.apply(ts, torch.from_numpy(z))
    close_to_peak(ty.numpy(), jcplx.to_numpy(jy))


@pytest.mark.parametrize("mode", ["poly", "fft", "conv"])
def test_freqshiftfir_other_modes(rng, mode):
    t = sps.firwin(89, 0.05).astype(np.float32)
    jb = JB.FreqShiftFir(1e6, -150e3, t, 8, mode=mode)
    tb = TB.FreqShiftFir(1e6, -150e3, t, 8, mode=mode)
    z = (rng.standard_normal(3 * 2048) + 1j * rng.standard_normal(3 * 2048)).astype(np.complex64)
    outs, js, ts = stream_both(jb, tb, np.split(z, 3))
    for jy, ty in outs:
        close_to_peak(ty, jy)
    assert_carry_close(js, ts)


def test_freqshiftfir_pallas_mode_raises_value_error():
    """JAX fails late, with KeyError: 'pallas' (ops/fir.py:146, reached
    from blocks.py:487), and am_receiver(fir_mode='pallas') with the
    default fold_shift=True fails with it.  The port refuses the mode when
    the block is built and points at fold_shift=False."""
    t = np.ones(9, np.float32) / 9
    jb = JB.FreqShiftFir(1e6, -1e5, t, 4, mode="pallas")
    with pytest.raises(KeyError, match="pallas"):
        jb.apply(jb.init_state(), jcplx.from_numpy(np.zeros(64, np.complex64)))
    with pytest.raises(ValueError, match="fold_shift=False"):
        TB.FreqShiftFir(1e6, -1e5, t, 4, mode="pallas")
    with pytest.raises(ValueError, match="fold_shift=False"):
        TR.am_receiver(2e6, 100e3, fir_mode="pallas")


# -- receivers ----------------------------------------------------------------------------


AM_CONFIGS = {
    "am2M_default": ((2e6, 100e3), {}, 50000, 3, "cf32"),
    "am2M_int8": ((2e6, 100e3), {"input_format": "int8"}, 50000, 3, "int8"),
    "am2M_pallas": ((2e6, 100e3), {"fir_mode": "pallas", "fold_shift": False}, 50000, 3, "cf32"),
    "am8M_audio_band": ((8e6, 1e6), {"audio_band": (300.0, 3000.0)}, 200000, 2, "cf32"),
}
CARRY_REL = {"am8M_audio_band": 5e-5}


def run_both(jchain, tchain, nchain, ticks, tick_len, carry_rel=1e-5):
    """Tick by tick: JAX, the port, the port rebuilt from JAX's numbers, and
    the port from JAX's carry; audio and carries compared each tick."""
    js, ts, ns = jchain.init_state(), tchain.init_state(), nchain.init_state()
    for i, blk in enumerate(ticks):
        cs = convert.state_from_numpy(jax.tree.map(np.asarray, js))
        jin = jcplx.from_numpy(blk) if np.iscomplexobj(blk) else jnp.asarray(blk)
        js, jy = jchain.apply(js, jin)
        ts, ty = tchain.apply(ts, torch.from_numpy(blk))
        ns, ny = nchain.apply(ns, torch.from_numpy(blk))
        _, cy = tchain.apply(cs, torch.from_numpy(blk))
        jy, ty = np.asarray(jy), ty.numpy()
        assert ty.shape == jy.shape == (tchain.out_len(tick_len),)
        e = err_db(jy, ty)
        assert e <= AUDIO_DB, f"tick {i}: {e:.1f} dB"
        assert err_db(jy, cy.numpy()) <= AUDIO_DB, f"tick {i}: from the JAX carry"
        np.testing.assert_array_equal(ny.numpy(), ty)
        assert_carry_close(js, ts, f"tick {i}", carry_rel)


@pytest.mark.parametrize("config", list(AM_CONFIGS))
def test_am_receiver_matches_jax(rng, config):
    args, kw, tick, n_ticks, fmt = AM_CONFIGS[config]
    jchain, jspec = JR.am_receiver(*args, **kw)
    tchain, tspec = TR.am_receiver(*args, **kw)
    assert tchain.granule == jchain.granule and tick % tchain.granule == 0
    assert tspec == TR.ReceiverSpec(**jspec.__dict__)
    assert [n for n, _ in tchain.blocks] == [n for n, _ in jchain.blocks]
    nchain = convert.chain_from_numpy([jax_block_params(n, b) for n, b in jchain.blocks])
    z = am_tone(rng, n_ticks * tick, *args)
    if fmt == "int8":
        z = int8_words(z)
    run_both(jchain, tchain, nchain, np.split(z, n_ticks), tick, CARRY_REL.get(config, 1e-5))


def test_fm_receiver_int8_matches_jax(rng):
    args = (2e6, 300e3, JR.WBFM)
    jchain, _ = JR.fm_receiver(*args, input_format="int8")
    tchain, _ = TR.fm_receiver(*args, input_format="int8")
    assert [n for n, _ in tchain.blocks] == [n for n, _ in jchain.blocks] and tchain.blocks[0][0] == "iq"
    nchain = convert.chain_from_numpy([jax_block_params(n, b) for n, b in jchain.blocks])
    src = SyntheticIqSource.fm(40000, 2e6, carrier_offset=300e3, output_format="int8", num_blocks=3)
    run_both(jchain, tchain, nchain, list(src), 40000)


def test_rf_to_pcm_resolves_like_jax():
    for mod in ("am", "nbfm"):
        jchain, jspec = JR.rf_to_pcm(mod, 2e6, 145e6, 145.1e6)
        tchain, tspec = TR.rf_to_pcm(mod, 2e6, 145e6, 145.1e6)
        assert tspec == TR.ReceiverSpec(**jspec.__dict__)
        assert [n for n, _ in tchain.blocks] == [n for n, _ in jchain.blocks]
    with pytest.raises(ValueError):
        TR.rf_to_pcm("ssb", 2e6, 0.0, 0.0)
