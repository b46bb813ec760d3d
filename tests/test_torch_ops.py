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
    tp0 = tosc.init_phase(phase_rad)
    assert tp0.dtype == torch.int64 and tp0.dim() == 0 and tosc.is_phase(tp0)
    assert int(p0) == int(tp0) == tosc.radians_to_u32(phase_rad)
    ref = np.asarray(josc.phase_angles(p0, inc, num))
    got = tosc.phase_angles(tp0, int(inc), num).numpy()
    np.testing.assert_array_equal(got, ref)
    advanced = tosc.advance_phase(tp0, int(inc), num)
    assert int(josc.advance_phase(p0, inc, num)) == int(advanced) and tosc.is_phase(advanced)


@pytest.mark.parametrize("num", [1000, 20000])
def test_complex_cosine_block(num):
    """Direct exp(j*theta) against the JAX package's (factorised above 8192
    samples): within a few float32 ulps of 1."""
    inc = josc.freq_to_inc_u32(-2.5e6, 20e6)
    p0 = josc.init_phase(0.7)
    ref = jcplx.to_numpy(josc.complex_cosine_block(p0, inc, num, amplitude=0.5))
    got = tosc.complex_cosine_block(tosc.as_phase(int(p0)), int(inc), num, amplitude=0.5).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_freq_shift_streaming(rng):
    inc = josc.freq_to_inc_u32(-300e3, 2e6)
    jp, tp = jmix.freq_shift_init(0.4), tmix.freq_shift_init(0.4)
    for _ in range(3):
        z = crandn(rng, 5000)
        jp, jy = jmix.freq_shift_apply(jp, jcplx.from_numpy(z), inc)
        tp, ty = tmix.freq_shift_apply(tp, torch.from_numpy(z), int(inc))
        np.testing.assert_allclose(ty.numpy(), jcplx.to_numpy(jy), rtol=0, atol=1e-5)
        assert int(jp) == int(tp) and tp.dtype == torch.int64


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


def _recurrence_f64(x, a, b, y0=0.0):
    """y[n] = a*y[n-1] + b*x[n], one sample at a time in float64, with the
    coefficients rounded to float32 as the port holds them."""
    from scipy.signal import lfilter

    af, bf = float(np.float32(a)), float(np.float32(b))
    y, _ = lfilter([bf], [1.0, -af], x.astype(np.float64), zi=[af * y0])
    return y


@pytest.mark.parametrize("n", [1 << 22, (1 << 22) + 12345, 256 * 256 * 256 + 77])
@pytest.mark.parametrize("pole", ["deemphasis", "close"])
def test_single_pole_long_block_is_linear(rng, monkeypatch, n, pole):
    """A capture-length block (2^22 samples and more, ragged too; the
    largest needs a third level of groups): within 1e-5 of peak of the
    float64 recurrence, and no matrix the module builds exceeds 256 x 256."""
    a, b = tiir.deemphasis_coeffs(75e-6, 400e3) if pole == "deemphasis" else (0.99999, 1e-3)
    shapes = []
    for name in ("_frame_mats", "_entry_mats"):
        real = getattr(tiir, name)

        def spy(*args, _real=real):
            mats = _real(*args)
            shapes.extend(tuple(m.shape) for m in mats)
            return mats

        monkeypatch.setattr(tiir, name, spy)
    x = rng.standard_normal(n).astype(np.float32)
    state, y = tiir.single_pole_apply(torch.full((1,), 0.5), torch.from_numpy(x), a, b)
    ref = _recurrence_f64(x, a, b, 0.5)
    close_to_peak(y.numpy(), ref)
    assert abs(float(state) - ref[-1]) <= 1e-5 * np.abs(ref).max()
    assert shapes and max(max(sh) for sh in shapes) <= 256
    assert (256, 256) in shapes


def test_single_pole_tick_keeps_its_single_group_form(rng):
    """A tick of 25,600 samples (100 frames, one group) is solved by one
    (100, 100) entry matrix as before the grouping, and so agrees with the
    float64 recurrence within 1e-6 of peak."""
    a, b = tiir.deemphasis_coeffs(75e-6, 400e3)
    x = rng.standard_normal(25600).astype(np.float32)
    tiir._entry_mats.cache_clear()
    _, y = tiir.single_pole_apply(tiir.single_pole_init(), torch.from_numpy(x), a, b)
    assert tiir._entry_mats.cache_info().currsize == 1
    et, _ = tiir._entry_mats(float(np.float32(a)) ** 256, 100, "cpu")
    assert tuple(et.shape) == (100, 100)
    close_to_peak(y.numpy(), _recurrence_f64(x, a, b), rel=1e-6)


def test_single_pole_grouped_equals_single_group(rng, monkeypatch):
    """The grouped solve against the one-matrix solve of the same frames
    (groups of 8 frames over a 25,600-sample tick): within 1e-6 of peak."""
    a, b = tiir.deemphasis_coeffs(75e-6, 400e3)
    x = torch.from_numpy(rng.standard_normal((2, 25600)).astype(np.float32))
    y0 = torch.tensor([[0.3], [-0.2]])
    _, one = tiir.single_pole_apply(y0, x, a, b)
    monkeypatch.setattr(tiir, "_GROUP", 8)
    _, grouped = tiir.single_pole_apply(y0, x, a, b)
    close_to_peak(grouped.numpy(), one.numpy(), rel=1e-6)


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


@pytest.mark.parametrize(
    "up,down,rows,complex_data",
    [(33, 125, 3, False), (6, 25, 4, False), (3, 25, 1, False), (3, 25, 2, True), (12, 125, 2, False)],
)
def test_resample_poly_cpu_route_equals_jax(rng, up, down, rows, complex_data):
    """``kernels.resample_poly`` on CPU tensors (the plain version the card's
    kernel is held to) over a batch of rows, three ticks streamed, against
    the JAX package's resample_apply row by row: the audio within 1e-5 of
    peak, the carry bit for bit in the state's format."""
    from tpusdr_torch.kernels import resample_poly as trp

    taps = jres.design_resampler_taps(up, down)
    n = down * 24
    jplan, tplan = jres.make_plan(taps, up, down, n), tres.make_plan(taps, up, down, n)
    ttaps = tres.plan_taps(tplan)
    dtype = torch.complex64 if complex_data else torch.float32
    ts = torch.zeros((rows, tplan.history), dtype=dtype)
    js = [jres.resample_init(jplan, "pair" if complex_data else jnp.float32) for _ in range(rows)]
    trp.resample_poly.launches = 0
    for _ in range(3):
        x = crandn(rng, rows, n) if complex_data else rng.standard_normal((rows, n)).astype(np.float32)
        ts, ty = trp.resample_poly(ts, torch.from_numpy(x), tplan, ttaps)
        assert ty.shape == (rows, tplan.block_out) and ts.shape == (rows, tplan.history) and ts.dtype == dtype
        for r in range(rows):
            js[r], jy = jres.resample_apply(js[r], jnp_of(x[r]), jplan)
            close_to_peak(ty[r].numpy(), np_of(jy))
            np.testing.assert_array_equal(ts[r].numpy(), np_of(js[r]))
    assert trp.resample_poly.launches == 0


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
@pytest.mark.parametrize("combo", ["FF", "CF", "CC", "FC"])
def test_fir_extended_poly_fft_batched(rng, mode, combo):
    """'poly' (K4's plain version) and 'fft' (overlap-save on torch.fft)
    against JAX's fir_extended, on (2, 3, L) batched streams."""
    T, D, M = 65, 4, 700
    L = (T - 1) + M * D + 3
    x = crandn(rng, 2, 3, L) if combo[0] == "C" else rng.standard_normal((2, 3, L)).astype(np.float32)
    _, h = _fir_inputs(rng, combo, T, 1)
    ref = np_of(jfir.fir_extended(jnp_of(x), jnp_of(h), D, mode))
    got = tfir.fir_extended(torch.from_numpy(x), torch.from_numpy(h), D, mode).numpy()
    assert got.shape == (2, 3, M)
    close_to_peak(got, ref)


@pytest.mark.parametrize("mode", ["poly", "fft"])
def test_fir_modes_poly_fft_long_and_short(rng, mode):
    """Modes 'poly' and 'fft' at K4's AM shapes, and with fewer outputs
    than one FFT segment holds."""
    for T, D, M in ((868, 250, 40), (46, 2, 900), (33, 1, 5)):
        x, h = _fir_inputs(rng, "CF", T, (T - 1) + M * D)
        ref = np_of(jfir.fir_extended(jnp_of(x), jnp_of(h), D, mode))
        got = tfir.fir_extended(torch.from_numpy(x), torch.from_numpy(h), D, mode).numpy()
        close_to_peak(got, ref)


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
