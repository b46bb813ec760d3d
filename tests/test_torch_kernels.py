"""The plain versions of the port's kernels against the JAX package's Pallas
kernels (interpret mode on the CPU).  The CUDA kernels against their plain
versions on the card are in test_torch_cuda.py.

Tolerances: FIR outputs within 1e-5 of the output's peak (float32 on both
sides, only the summation order differs; the JAX prelude kernel's bf16
hi/lo split adds ~3e-6); FM discriminator outputs within 1e-5 * gain (the
TPU kernel's polynomial atan against atan2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpusdr.kernels import fir_banded_pallas as jfb
from tpusdr.kernels.fm_pallas import fused_fm_demod_pallas
from tpusdr.ops import cplx as jcplx
from tpusdr.ops import osc as josc
from tpusdr_torch import kernels
from tpusdr_torch.kernels import dispatch
from tpusdr_torch.kernels import fir_banded as tfb
from tpusdr_torch.kernels import fm_fused as tfm

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(9)


def crandn(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def close_to_peak(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _taps(T, complex_taps):
    t = sps.firwin(T, 0.1).astype(np.float32)
    if complex_taps:
        t = (t * np.exp(1j * 0.37 * np.arange(T))).astype(np.complex64)
    return t


def _pair(z):
    return jcplx.Complex(jnp.asarray(z.real.copy()), jnp.asarray(z.imag.copy()))


def fm_tone(rng, n, fs, offset, deviation):
    t = np.arange(n) / fs
    ph = 2 * np.pi * offset * t + 2 * np.pi * deviation * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / fs
    return (0.9 * np.exp(1j * ph) + 0.01 * crandn(rng, n)).astype(np.complex64)


# -- K1: banded_fir_pallas ---------------------------------------------------------


@pytest.mark.parametrize("complex_taps", [False, True])
@pytest.mark.parametrize("T,D", [(546, 50), (33, 4), (46, 2)])
def test_banded_fir_plain_matches_pallas(rng, T, D, complex_taps):
    M = 300
    L = (T - 1) + M * D
    z = crandn(rng, L)
    t = _taps(T, complex_taps)
    ref = jcplx.to_numpy(jfb.banded_fir_pallas(jcplx.from_numpy(z), t, D, interpret=True))
    got = tfb.banded_fir(torch.from_numpy(z), torch.from_numpy(t), D).numpy()
    close_to_peak(got, ref)


def test_banded_fir_history_form(rng):
    """History passed separately (no concatenation in front of the block)."""
    T, D = 546, 50
    t = _taps(T, True)
    hist, z = crandn(rng, T - 1), crandn(rng, 200 * D)
    ref = jcplx.to_numpy(
        jfb.banded_fir_pallas(jcplx.from_numpy(z), t, D, interpret=True, history=jcplx.from_numpy(hist))
    )
    got = tfb.banded_fir(torch.from_numpy(z), t, D, history=torch.from_numpy(hist)).numpy()
    assert got.shape == (200,)
    close_to_peak(got, ref)


# -- K2: banded_fir_prelude -------------------------------------------------------


def test_prelude_plain_matches_pallas_streaming(rng):
    """Three ticks; each tick's prelude is the last 8 rows of the stream."""
    T, D = 89, 8
    G, _ = jfb.prelude_plan(T, D)
    N = 24 * G
    t = (sps.firwin(T, 0.05) * np.exp(-2j * np.pi * 0.15 * np.arange(T))).astype(np.complex64)
    pre = np.zeros((8, G), np.complex64)
    for _ in range(3):
        z = crandn(rng, N)
        ref = jcplx.to_numpy(jfb.banded_fir_prelude(jcplx.from_numpy(z), _pair(pre), t, D, interpret=True))
        got = tfb.banded_fir_prelude(torch.from_numpy(z), torch.from_numpy(pre), t, D).numpy()
        assert got.shape == (N // D,)
        close_to_peak(got, ref)
        pre = z[-8 * G :].reshape(8, G)


def test_prelude_multi_backward_parts(rng):
    """T-1 > 2G: B=3 backward parts (tests/test_kernels.py:401)."""
    T, D = 2500, 8
    G, B = jfb.prelude_plan(T, D)
    assert B == 3
    N = 48 * G
    t = (sps.firwin(T, 0.01) * np.exp(-2j * np.pi * 0.11 * np.arange(T))).astype(np.complex64)
    pre, z = crandn(rng, 8, G), crandn(rng, N)
    ref = jcplx.to_numpy(jfb.banded_fir_prelude(jcplx.from_numpy(z), _pair(pre), t, D, interpret=True))
    got = tfb.banded_fir_prelude(torch.from_numpy(z), torch.from_numpy(pre), t, D).numpy()
    close_to_peak(got, ref)


def test_prelude_rejects_non_row_ticks(rng):
    G, _ = tfb.prelude_plan(89, 8)
    with pytest.raises(ValueError, match="8G"):
        tfb.banded_fir_prelude(
            torch.zeros(8 * G + 64, dtype=torch.complex64),
            torch.zeros(8, G, dtype=torch.complex64), np.ones(89, np.float32), 8,
        )


def test_shape_rules_equal_jax():
    """The port keeps the JAX package's shape rules, so FusedFmDemod picks
    the same branch and granule.  Divergence recorded (fault 3.2): the JAX
    prelude kernel doubles its tap-matrix bytes for the bf16 hi/lo split
    (fir_banded_pallas.py:641-643) while its prelude_eligible does not
    (:431); the port has no split, so its rule and kernel agree."""
    for T in (33, 46, 55, 65, 89, 546, 728, 2500, 5000, 9000):
        for D in (1, 2, 4, 5, 8, 50, 66, 128):
            assert tfb._plan(T, D) == jfb._plan(T, D)
            assert tfb.prelude_plan(T, D) == jfb.prelude_plan(T, D)
            for c in (False, True):
                assert tfb.eligible(T, D, c) == jfb.eligible(T, D, c), (T, D, c)
                G = 128 * D
                for N in (8 * G, 16 * G, 200 * G, 16 * G + 8):
                    assert tfb.prelude_eligible(T, D, N, c) == jfb.prelude_eligible(T, D, N, c)


# -- K3: fused_fm_demod_pallas ------------------------------------------------------


@pytest.mark.parametrize("phase_rad", [1.1, 5.0])
def test_fused_fm_plain_matches_pallas(rng, phase_rad):
    T, D, M = 91, 10, 800
    fs, f_off, gain = 2e6, 250e3, 0.8
    taps = (rng.standard_normal(T) * 0.05).astype(np.float32)
    inc = josc.freq_to_inc_u32(-f_off, fs)
    phase0 = josc.init_phase(phase_rad)
    z = fm_tone(rng, (T - 1) + (M + 1) * D, fs, f_off, 75e3)
    ref = np.asarray(fused_fm_demod_pallas(jcplx.from_numpy(z), taps, D, inc, phase0, gain, interpret=True))
    got = tfm.fused_fm_demod(torch.from_numpy(z), taps, D, int(inc), int(phase0), gain).numpy()
    assert got.shape == (M,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * gain)


# -- dispatch -------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_without_launching(rng):
    kernels.reset_launch_counts()
    z = torch.from_numpy(crandn(rng, 64 * 4 + 32))
    tfb.banded_fir(z, torch.ones(33), 4)
    tfm.fused_fm_demod(z, torch.ones(33), 4, 123, 0, 1.0)
    assert [w.launches for w in kernels.WRAPPERS] == [0, 0, 0]
    assert dispatch.on_cuda(z, None) is False


def test_dispatch_rejects_other_devices():
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.on_cuda(torch.zeros(4, device="meta"))
