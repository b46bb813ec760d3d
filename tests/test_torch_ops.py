"""tpusdr_torch.ops against tpusdr.ops on the CPU: the same numpy inputs,
made from a seed, through the JAX function and its port.

Tolerances: FIR, IIR and resampler outputs within 1e-5 of the output's
peak (both sides float32; only the summation order differs); the
discriminator within 1e-5 * gain (the JAX package's polynomial atan
against torch.atan2); NCO phases and designed taps bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusdr.ops import cplx as jcplx
from tpusdr.ops import demod as jdemod
from tpusdr.ops import design as jdesign
from tpusdr.ops import fir as jfir
from tpusdr.ops import iir as jiir
from tpusdr.ops import mix as jmix
from tpusdr.ops import osc as josc
from tpusdr.ops import resample as jres
from tpusdr_torch.ops import demod as tdemod
from tpusdr_torch.ops import design as tdesign
from tpusdr_torch.ops import fir as tfir
from tpusdr_torch.ops import iir as tiir
from tpusdr_torch.ops import mix as tmix
from tpusdr_torch.ops import osc as tosc
from tpusdr_torch.ops import resample as tres

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def crandn(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def close_to_peak(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    peak = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * peak)


def jnp_of(a):
    return jcplx.from_numpy(a) if np.iscomplexobj(a) else jnp.asarray(a)


def np_of(x):
    return jcplx.to_numpy(x) if isinstance(x, jcplx.Complex) else np.asarray(x)


# -- NCO ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "freq,fs,phase_rad,num",
    [(-2.5e6, 20e6, 0.0, 4096), (300e3, 2e6, 1.1, 1000), (-100e3, 2e6, 5.9, 70001)],
)
def test_osc_phases_bit_exact(freq, fs, phase_rad, num):
    inc = josc.freq_to_inc_u32(freq, fs)
    assert int(inc) == tosc.freq_to_inc_u32(freq, fs)
    p0 = josc.init_phase(phase_rad)
    assert int(p0) == tosc.init_phase(phase_rad)
    ref = np.asarray(josc.phase_angles(p0, inc, num))
    got = tosc.phase_angles(int(p0), int(inc), num).numpy()
    np.testing.assert_array_equal(got, ref)
    assert int(josc.advance_phase(p0, inc, num)) == tosc.advance_phase(int(p0), int(inc), num)


@pytest.mark.parametrize("num", [1000, 20000])
def test_complex_cosine_block(num):
    """Direct exp(j*theta) against the JAX package's (factorised above 8192
    samples): within a few float32 ulps of 1."""
    inc = josc.freq_to_inc_u32(-2.5e6, 20e6)
    p0 = josc.init_phase(0.7)
    ref = jcplx.to_numpy(josc.complex_cosine_block(p0, inc, num, amplitude=0.5))
    got = tosc.complex_cosine_block(int(p0), int(inc), num, amplitude=0.5).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_freq_shift_streaming(rng):
    inc = josc.freq_to_inc_u32(-300e3, 2e6)
    jp, tp = jmix.freq_shift_init(0.4), tmix.freq_shift_init(0.4)
    for _ in range(3):
        z = crandn(rng, 5000)
        jp, jy = jmix.freq_shift_apply(jp, jcplx.from_numpy(z), inc)
        tp, ty = tmix.freq_shift_apply(tp, torch.from_numpy(z), int(inc))
        np.testing.assert_allclose(ty.numpy(), jcplx.to_numpy(jy), rtol=0, atol=1e-5)
        assert int(jp) == tp


# -- discriminator ---------------------------------------------------------------


def test_quad_fm_demod_streaming(rng):
    gain = jdemod.quad_fm_demod_gain(400e3, 200e3)
    js, ts = jdemod.quad_fm_demod_init(), tdemod.quad_fm_demod_init()
    for _ in range(3):
        z = crandn(rng, 3000)
        js, jy = jdemod.quad_fm_demod_apply(js, jcplx.from_numpy(z), gain)
        ts, ty = tdemod.quad_fm_demod_apply(ts, torch.from_numpy(z), gain)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5 * gain)
        np.testing.assert_array_equal(ts.numpy(), jcplx.to_numpy(js))


def test_discriminator_arg_of_zero():
    """A zero product (cold start against a zero carry) gives 0, as the JAX
    package's atan2 does, whatever the signs of its zeros."""
    im = torch.tensor([0.0, -0.0, 0.0, -0.0])
    re = torch.tensor([0.0, 0.0, -0.0, -0.0])
    np.testing.assert_array_equal(tdemod.arg(im, re).abs().numpy(), np.zeros(4))


# -- IIR ----------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1000, 5000, 25600])
def test_single_pole_streaming(rng, n):
    """Both JAX branches (scan below 4096, blocked matmul at and above;
    5000 pads to the frame size) against the port, over several ticks."""
    a, b = tiir.deemphasis_coeffs(75e-6, 400e3)
    assert (a, b) == jiir.deemphasis_coeffs(75e-6, 400e3)
    js, ts = jiir.single_pole_init(), tiir.single_pole_init()
    for _ in range(3):
        x = rng.standard_normal(n).astype(np.float32)
        js, jy = jiir.single_pole_apply(js, jnp.asarray(x), a, b)
        ts, ty = tiir.single_pole_apply(ts, torch.from_numpy(x), a, b)
        close_to_peak(ty.numpy(), np.asarray(jy))
        peak = np.abs(np.asarray(jy)).max()
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5 * peak)


def test_single_pole_close_pole_long_tick(rng):
    """A pole near 1 (a^256 ~ 0.77) over a long tick: the frame-entry
    matmul keeps the frame states exact where inverse powers would not."""
    a, b = 0.999, 1.0
    x = rng.standard_normal(256 * 64).astype(np.float32)
    _, jy = jiir.single_pole_apply(jiir.single_pole_init(), jnp.asarray(x), a, b)
    _, ty = tiir.single_pole_apply(tiir.single_pole_init(), torch.from_numpy(x), a, b)
    close_to_peak(ty.numpy(), np.asarray(jy))


# -- resampler --------------------------------------------------------------------


@pytest.mark.parametrize("up,down,complex_data", [(3, 25, False), (12, 125, False), (3, 25, True)])
def test_resample_streaming(rng, up, down, complex_data):
    taps = jres.design_resampler_taps(up, down)
    np.testing.assert_array_equal(tres.design_resampler_taps(up, down), taps)
    n = down * 400
    jplan, tplan = jres.make_plan(taps, up, down, n), tres.make_plan(taps, up, down, n)
    np.testing.assert_array_equal(tplan.tap_rows, jplan.tap_rows)
    if complex_data:
        js, ts = jres.resample_init(jplan, "pair"), tres.resample_init(tplan).to(torch.complex64)
    else:
        js, ts = jres.resample_init(jplan, jnp.float32), tres.resample_init(tplan)
    for _ in range(3):
        x = crandn(rng, n) if complex_data else rng.standard_normal(n).astype(np.float32)
        js, jy = jres.resample_apply(js, jnp_of(x), jplan)
        ts, ty = tres.resample_apply(ts, torch.from_numpy(x), tplan)
        close_to_peak(ty.numpy(), np_of(jy))
        np.testing.assert_array_equal(ts.numpy(), np_of(js))


def test_resample_up1_delegates_to_fir(rng):
    taps = jres.design_resampler_taps(1, 5)
    n = 5 * 300
    jplan, tplan = jres.make_plan(taps, 1, 5, n), tres.make_plan(taps, 1, 5, n)
    js = jnp.zeros((len(taps) - 1,), jnp.float32)
    ts = torch.zeros(len(taps) - 1)
    for _ in range(2):
        x = rng.standard_normal(n).astype(np.float32)
        js, jy = jres.resample_apply(js, jnp.asarray(x), jplan)
        ts, ty = tres.resample_apply(ts, torch.from_numpy(x), tplan)
        close_to_peak(ty.numpy(), np.asarray(jy))


# -- FIR ---------------------------------------------------------------------------


def _fir_inputs(rng, combo, T, L):
    x = crandn(rng, L) if combo[0] == "C" else rng.standard_normal(L).astype(np.float32)
    h = rng.standard_normal(T).astype(np.float32) / np.sqrt(T)
    if combo[1] == "C":
        h = (h * np.exp(1j * 0.37 * np.arange(T))).astype(np.complex64)
    return x, h


@pytest.mark.parametrize("mode", ["mxu", "conv"])
@pytest.mark.parametrize("combo", ["FF", "CF", "CC", "FC"])
def test_fir_extended_type_combos(rng, mode, combo):
    """combo = (data, taps): F real, C complex (gsdrFirFF/FC/CC/CF)."""
    T, D, M = 65, 4, 700
    x, h = _fir_inputs(rng, combo, T, (T - 1) + M * D + 3)
    ref = np_of(jfir.fir_extended(jnp_of(x), jnp_of(h), D, mode))
    got = tfir.fir_extended(torch.from_numpy(x), torch.from_numpy(h), D, mode).numpy()
    close_to_peak(got, ref)


@pytest.mark.parametrize("T,D", [(546, 50), (33, 4)])
def test_fir_apply_streaming(rng, T, D):
    """Streaming in 'auto' (the banded kernel's plain version on the CPU)
    against the JAX package's default path, outputs and history."""
    h = (rng.standard_normal(T) / np.sqrt(T)).astype(np.float32)
    n = D * 500
    js = jfir.fir_init_state(h, "pair")
    ts = tfir.fir_init_state(T, True)
    for _ in range(3):
        x = crandn(rng, n)
        js, jy = jfir.fir_apply(js, jcplx.from_numpy(x), jnp.asarray(h), D)
        ts, ty = tfir.fir_apply(ts, torch.from_numpy(x), torch.from_numpy(h), D)
        close_to_peak(ty.numpy(), jcplx.to_numpy(jy))
        np.testing.assert_array_equal(ts.numpy(), jcplx.to_numpy(js))


@pytest.mark.parametrize("mode", ["poly", "fft"])
def test_fir_modes_not_ported_raise(mode):
    x = torch.zeros(100, dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfir.fir_extended(x, torch.ones(5), 2, mode)


# -- design ------------------------------------------------------------------------


@pytest.mark.parametrize(
    "fs,cw,d,multistage",
    [(20e6, 200e3, 50, True), (2e6, 200e3, 5, True), (2e6, 15e3, 66, False)],
)
def test_design_taps_bit_equal(fs, cw, d, multistage):
    """The copied design module gives the JAX package's taps bit for bit
    at the slice's RF stages."""
    if multistage:
        ref = jdesign.decimation_stages(fs, cw / 2, cw / 2, -60.0, d)
        got = tdesign.decimation_stages(fs, cw / 2, cw / 2, -60.0, d)
        assert [dd for _, dd in got] == [dd for _, dd in ref]
        for (tg, _), (tr, _) in zip(got, ref):
            np.testing.assert_array_equal(tg, tr)
    else:
        np.testing.assert_array_equal(
            tdesign.lowpass_taps(fs, cw / 2, cw / 2, -60.0),
            jdesign.lowpass_taps(fs, cw / 2, cw / 2, -60.0),
        )


@pytest.mark.parametrize("up,down", [(3, 25), (198, 125)])
def test_design_resampler_taps_bit_equal(up, down):
    np.testing.assert_array_equal(
        tres.design_resampler_taps(up, down), jres.design_resampler_taps(up, down)
    )
