"""tpusdr_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc; without them each skips (the
decision is taken in the ``cuda`` fixture, not at import).  This file
imports neither JAX nor tpusdr, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: FIR outputs within 1e-5 of the output's peak and FM
discriminator outputs within 1e-5 * gain (float32 on both sides, only the
summation order and the libm calls differ); chain audio at <= -60 dB
error energy against the port's CPU path.
"""

import numpy as np
import pytest
import torch

from tpusdr_torch import kernels
from tpusdr_torch.kernels import fir_banded as tfb
from tpusdr_torch.kernels import fm_fused as tfm
from tpusdr_torch.models import receiver
from tpusdr_torch.ops import osc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(31)


def crandn(rng, dev, *shape):
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(z.astype(np.complex64)).to(dev)


def taps(T, complex_taps, dev):
    n = np.arange(T) - (T - 1) / 2
    t = (0.1 * np.sinc(0.1 * n) * np.hamming(T)).astype(np.float32)
    if complex_taps:
        t = (t * np.exp(1j * 0.37 * np.arange(T))).astype(np.complex64)
    return torch.from_numpy(t).to(dev)


def close_to_peak(got, ref, rel=1e-5):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def fm_tone(rng, n, fs, offset, deviation):
    t = np.arange(n) / fs
    ph = 2 * np.pi * offset * t + 2 * np.pi * deviation * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / fs
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (0.9 * np.exp(1j * ph) + 0.01 * noise).astype(np.complex64)


def err_db(ref, got):
    return 10 * np.log10(np.sum((ref - got) ** 2) / np.sum(ref**2))


@pytest.mark.parametrize("T,D,complex_taps", [(546, 50, True), (33, 4, False), (46, 2, True)])
def test_decim_fir_history_form(cuda, rng, T, D, complex_taps):
    h = taps(T, complex_taps, cuda)
    hist, x = crandn(rng, cuda, T - 1), crandn(rng, cuda, 25600 * D)
    before = tfb.banded_fir.launches
    got = tfb.banded_fir(x, h, D, history=hist)
    assert tfb.banded_fir.launches == before + 1
    close_to_peak(got, tfb.decim_fir_plain(hist, x, h, D, 0, 25600))


@pytest.mark.parametrize("T,D,rows", [(546, 50, 200), (89, 8, 48), (2500, 8, 48)])
def test_decim_fir_prelude_form_streaming(cuda, rng, T, D, rows):
    G, _ = tfb.prelude_plan(T, D)
    h = taps(T, True, cuda)
    pre = torch.zeros(8, G, dtype=torch.complex64, device=cuda)
    for _ in range(2):
        x = crandn(rng, cuda, rows * G)
        got = tfb.banded_fir_prelude(x, pre, h, D)
        ref = tfb.decim_fir_plain(pre.reshape(-1), x, h, D, 8 * G - (T - 1), rows * G // D)
        close_to_peak(got, ref)
        pre = x[-8 * G :].reshape(8, G)


@pytest.mark.parametrize("T,D,M", [(728, 66, 20000), (91, 10, 800)])
def test_fm_fused(cuda, rng, T, D, M):
    h = taps(T, False, cuda)
    z = torch.from_numpy(fm_tone(rng, (T - 1) + (M + 1) * D, 2e6, 100e3, 5e3)).to(cuda)
    inc, ph = osc.freq_to_inc_u32(-100e3, 2e6), osc.init_phase(0.3)
    before = tfm.fused_fm_demod.launches
    got = tfm.fused_fm_demod(z, h, D, inc, ph, 0.32)
    assert tfm.fused_fm_demod.launches == before + 1
    ref = tfm.fused_fm_demod_plain(z, h, D, inc, ph, 0.32, M)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5 * 0.32)


@pytest.mark.parametrize(
    "args,kw,tick,wrapper",
    [
        ((2e6, 300e3, receiver.WBFM), {}, 40000, "banded_fir"),
        ((2e6, 300e3, receiver.WBFM), {"use_fused": True}, 128000, "banded_fir_prelude"),
        ((2e6, 100e3, receiver.NBFM), {"use_fused": True}, 33000, "fused_fm_demod"),
    ],
)
def test_receiver_on_the_card_matches_cpu(cuda, rng, args, kw, tick, wrapper):
    counter = {w.__name__: w for w in kernels.WRAPPERS}[wrapper]
    gpu_chain, _ = receiver.fm_receiver(*args, **kw)
    cpu_chain, _ = receiver.fm_receiver(*args, **kw)
    gpu_chain.to(cuda)
    z = fm_tone(rng, 3 * tick, args[0], args[1], 75e3 if args[2] == receiver.WBFM else 5e3)
    gs, cs = gpu_chain.init_state(device=cuda), cpu_chain.init_state()
    before = counter.launches
    for i in range(3):
        blk = torch.from_numpy(z[i * tick : (i + 1) * tick])
        gs, gy = gpu_chain.apply(gs, blk.to(cuda))
        cs, cy = cpu_chain.apply(cs, blk)
        assert err_db(cy.numpy(), gy.cpu().numpy()) <= -60.0
    assert counter.launches == before + 3


def test_kernel_refuses_too_much_shared_memory(cuda):
    x = torch.zeros(1 << 16, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tfb.banded_fir(x, torch.ones(30000, dtype=torch.complex64, device=cuda), 2)


def test_mixed_devices_raise(cuda):
    x = torch.zeros(4096, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.banded_fir(x, torch.ones(33), 4)
