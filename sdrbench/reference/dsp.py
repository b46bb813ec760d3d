"""Plain stages of the reference receivers, written from the textbook
definitions and not from the program's blocks.

Complex streams are pairs of real tensors ``(re, im)``, so one code path
runs in float64 (the reference) and in bfloat16 (the control, which the
benchmark's tests and ``sdrbench.control`` put in the program's place).
Every stage starts from silence: the samples before the first one given
are zeros, and each output sample is a finite sum over the input up to
it.  Long sums are cut into blocks of rows so that a stage fits beside
what else lies on the card.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from sdrbench.reference import design

ELEMS = 1 << 24  # elements a block of a windowed sum holds


def _rows(x: torch.Tensor, width: int) -> int:
    """Output rows a block, so that a block's windows over every leading
    (channel) row hold about ``ELEMS`` elements."""
    return max(16, ELEMS // (max(1, x[..., :1].numel()) * width))


def int8_words(words: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """HackRF int8 IQ, one little-endian int16 word a sample (I the low
    byte): the bytes over 128."""
    b = words.contiguous().view(torch.int8).reshape(-1, 2).to(torch.float64) / 128.0
    return b[:, 0].to(dtype), b[:, 1].to(dtype)


def cf32(x: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    return x.real.to(torch.float64).to(dtype), x.imag.to(torch.float64).to(dtype)


def mix(x, cycles_per_sample: Fraction, start: int):
    """x[n] * exp(-j 2 pi f n), with n counted from the stream's first
    sample (``start`` is x[0]'s index) and the phase reduced exactly in
    integers: f is a fraction p/q of the sample rate."""
    re, im = x
    p, q = cycles_per_sample.numerator % cycles_per_sample.denominator, cycles_per_sample.denominator
    if p * (re.shape[-1] + q) >= 2**62:
        raise ValueError("phase product overflows int64")
    n = torch.arange(re.shape[-1], dtype=torch.int64, device=re.device)
    k = ((p * start) % q + p * n) % q
    ang = k.to(torch.float64) * (2.0 * math.pi / q)
    c, s = torch.cos(ang).to(re.dtype), torch.sin(ang).to(re.dtype)
    # (re + j im)(c - j s)
    return re * c + im * s, im * c - re * s


def _windows(x: torch.Tensor, taps: int, step: int, lo: int, hi: int) -> torch.Tensor:
    """Rows lo..hi-1 of the windows xpad[m*step : m*step + taps] of x with
    taps-1 zeros in front: window m ends at x[m*step]."""
    xpad = torch.nn.functional.pad(x, (taps - 1, 0))
    seg = xpad[..., lo * step : (hi - 1) * step + taps]
    return seg.unfold(-1, taps, step)


def fir_real(x: torch.Tensor, h: np.ndarray, down: int) -> torch.Tensor:
    """y[m] = sum_k h[k] x[m*down - k] for real x and real taps h."""
    m_out = -(-x.shape[-1] // down)
    hr = torch.from_numpy(np.ascontiguousarray(h[::-1], dtype=np.float64)).to(x.device, x.dtype)
    rows = _rows(x, len(h))
    return torch.cat(
        [_windows(x, len(h), down, lo, min(lo + rows, m_out)) @ hr for lo in range(0, m_out, rows)], -1
    )


def fir_decimate(x, h: np.ndarray, down: int):
    """The same sum over a complex stream (real taps)."""
    return fir_real(x[0], h, down), fir_real(x[1], h, down)


def filterbank(x, h: np.ndarray, channels: int):
    """Maximally decimated filterbank: channel k is
    y_k[m] = sum_n h[n] exp(+j 2 pi k n / M) x[m*M - n], the band centred
    at +k fs/M brought to baseband by the decimation.  Returns
    (re, im) of shape (M, frames)."""
    re, im = x
    T, M = len(h), channels
    n = np.arange(T)[::-1]  # window column j holds x[m*M - (T-1-j)]
    ang = 2.0 * np.pi * np.outer(n, np.arange(M)) / M
    hr = torch.from_numpy(h[::-1, None] * np.cos(ang)).to(re.device, re.dtype)  # (T, M)
    hi_ = torch.from_numpy(h[::-1, None] * np.sin(ang)).to(re.device, re.dtype)
    frames = -(-re.shape[-1] // M)
    rows = _rows(re, T)
    ys_r, ys_i = [], []
    for lo in range(0, frames, rows):
        hi = min(lo + rows, frames)
        wr = _windows(re, T, M, lo, hi)
        wi = _windows(im, T, M, lo, hi)
        ys_r.append(wr @ hr - wi @ hi_)
        ys_i.append(wr @ hi_ + wi @ hr)
    return torch.cat(ys_r, 0).T.contiguous(), torch.cat(ys_i, 0).T.contiguous()


def fm_discriminate(x, gain: float) -> torch.Tensor:
    """gain * arg(x[n] conj(x[n-1])), x[-1] = 0 and arg(0) = 0."""
    re, im = x
    pr = torch.nn.functional.pad(re, (1, 0))[..., :-1]
    pi = torch.nn.functional.pad(im, (1, 0))[..., :-1]
    a = re * pr + im * pi
    b = im * pr - re * pi
    zero = (a == 0) & (b == 0)
    ang = torch.atan2(b, a)
    return gain * torch.where(zero, torch.zeros_like(ang), ang)


def one_pole_taps(tau: float, rate: float) -> int:
    """Terms of the de-emphasis sum: a^k falls under 1e-18 (below
    float64's step at 1) after this many."""
    a = math.exp(-1.0 / (tau * rate))
    return int(math.ceil(math.log(1e-18) / math.log(a)))


def one_pole(x: torch.Tensor, tau: float, rate: float) -> torch.Tensor:
    """De-emphasis y[n] = a y[n-1] + (1-a) x[n], a = exp(-1/(tau rate)),
    from rest: the same sum written out, y[n] = sum_k (1-a) a^k x[n-k],
    over ``one_pole_taps`` terms."""
    a = math.exp(-1.0 / (tau * rate))
    h = (1.0 - a) * a ** np.arange(one_pole_taps(tau, rate), dtype=np.float64)
    return fir_real(x, h, 1)


def resampler_taps(up: int, down: int, db_attenuation: float) -> np.ndarray:
    """The rational resampler's prototype: a Kaiser lowpass at the lower of
    the two Nyquist rates, less a fifth for the transition, with passband
    gain ``up`` (float64)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    cutoff = 0.5 * up / max(up, down)
    transition = cutoff * 0.2
    return design.kaiser_lowpass(float(up), cutoff - transition, transition, db_attenuation) * up


def resample(x: torch.Tensor, up: int, down: int, h: np.ndarray) -> torch.Tensor:
    """Upsample by ``up`` (zeros between samples), filter with h, keep every
    ``down``-th: y[m] = sum_i h[p + i up] x[q - i] with p = (m down) mod up,
    q = (m down) div up."""
    n = x.shape[-1]
    m_out = n * up // down
    P = -(-len(h) // up)
    hp = np.zeros(P * up)
    hp[: len(h)] = h
    dev, dt = x.device, x.dtype
    xpad = torch.nn.functional.pad(x, (P - 1, 0))
    i = np.arange(P)
    rows = _rows(x, P)
    out = []
    for lo in range(0, m_out, rows):
        m = np.arange(lo, min(lo + rows, m_out))
        p, q = (m * down) % up, (m * down) // up
        idx = torch.from_numpy(q[:, None] - i[None, :] + (P - 1)).to(dev)
        taps = torch.from_numpy(hp[p[:, None] + up * i[None, :]]).to(dev, dt)
        out.append((xpad[..., idx] * taps).sum(-1))
    return torch.cat(out, -1)
