"""Decimating FIR filtering with Fir.cpp streaming semantics.

Port of tpusdr/ops/fir.py:77-483.

  * with A available input samples, T taps and decimation D, the number
    of outputs is (A - (T-1)) // D;
  * producing M outputs consumes M*D input samples and retains the last
    T-1 samples as history (an explicit carry).

y[..., m] = sum_j taps[j] * x_ext[..., m*D + T-1-j].  Data and taps may
each be real (float32) or complex (complex64): the four type combinations
of the reference (gsdrFirFF/FC/CC/CF).

Modes:
  * 'auto', 'banded' — a single complex stream goes through
    ``kernels.fir_banded.banded_fir``: the hand-written decimating-FIR
    kernel for a CUDA tensor, its plain version for a CPU tensor.  Real
    data and batched streams take 'mxu' (the JAX package's banded kernel
    also takes planar complex single streams only).
  * 'mxu'  — the plain banded matmul: outputs tiled c at a time, row r of
    the window matrix A[r, i] = x[r*G + i] (G = c*D), contracted against
    the banded tap matrix W[i, j] = h_rev[i - j*D] as a sum over row-chunk
    views, A @ W = sum_j A_j @ W_j (no window copy).
  * 'conv' — ``F.conv1d`` with stride D, with cuDNN's TF32 turned off.
  * 'poly' — polyphase frames: y[m] = sum_p frames[m+p] . H[p], one
    accumulated pass over P shifted (frame, D) views; the plain version
    of kernel K4 (``kernels.fir_poly``).
  * 'fft'  — segmented overlap-save on ``torch.fft`` with the JAX
    package's segment plan (hop a multiple of D).

The JAX package's mode 'pallas' belongs to the ``Fir`` block, which sends
eligible streams to kernel K4 and the rest to 'poly'.
"""

from __future__ import annotations

import functools
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F

from tpusdr_torch.utils.numerics import cdiv, next_pow2, round_up

FirMode = Literal["auto", "banded", "mxu", "conv", "poly", "fft"]


def num_outputs(available: int, num_taps: int, decimation: int) -> int:
    """Output count for a given number of available samples (Fir.cpp:180-187)."""
    if available < num_taps:
        return 0
    return (available - (num_taps - 1)) // decimation


def history_len(num_taps: int) -> int:
    """Samples of history a streaming FIR must retain (Fir.cpp:274-276)."""
    return num_taps - 1


def fir_extended(x_ext: torch.Tensor, taps: torch.Tensor, decimation: int = 1, mode: FirMode = "auto"):
    """Valid-mode convolution of ``x_ext`` (..., L) with ``taps``, decimated
    by D: L = (T-1) + M*D gives (..., M); an unusable tail is ignored."""
    T = taps.shape[-1]
    D = int(decimation)
    M = num_outputs(x_ext.shape[-1], T, D)
    out_complex = x_ext.is_complex() or taps.is_complex()
    if mode not in ("auto", "banded", "mxu", "conv", "poly", "fft"):
        raise ValueError(f"unknown FIR mode {mode!r}")
    if M <= 0:
        dt = torch.complex64 if out_complex else torch.float32
        return torch.zeros(x_ext.shape[:-1] + (0,), dtype=dt, device=x_ext.device)
    x_ext = x_ext[..., : (T - 1) + M * D]

    if mode in ("auto", "banded"):
        if x_ext.is_complex() and x_ext.dim() == 1:
            from tpusdr_torch.kernels.fir_banded import banded_fir

            return banded_fir(x_ext, taps, D)
        mode = "mxu"
    if mode == "fft":
        return _fir_fft(x_ext, taps, D, M)
    impl = {"mxu": _fir_mxu, "conv": _fir_conv, "poly": _fir_poly}[mode]

    cx, ch = x_ext.is_complex(), taps.is_complex()
    if not cx and not ch:  # FF
        return impl(x_ext, taps, D, M)
    if cx and not ch:  # FC: I and Q as two real channels
        y = impl(torch.stack([x_ext.real, x_ext.imag]), taps, D, M)
        return torch.complex(y[0], y[1])
    if cx and ch:  # CC
        if mode == "mxu":
            return _fir_mxu_cc(x_ext, taps, D, M)
        xr, xi, hr, hi = x_ext.real, x_ext.imag, taps.real, taps.imag
        k1 = impl(xr + xi, hr, D, M)  # 3-multiply complex convolution
        k2 = impl(xi, hr + hi, D, M)
        k3 = impl(xr, hi - hr, D, M)
        return torch.complex(k1 - k2, k1 + k3)
    # CF: real input, complex taps
    return torch.complex(impl(x_ext, taps.real, D, M), impl(x_ext, taps.imag, D, M))


def _fir_conv(x: torch.Tensor, taps: torch.Tensor, D: int, M: int) -> torch.Tensor:
    """conv1d path (real only; the caller splits complex)."""
    batch = x.shape[:-1]
    lhs = x.reshape(-1, 1, x.shape[-1]).to(torch.float32)
    rhs = torch.flip(taps, [-1]).reshape(1, 1, -1).to(torch.float32)
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled,
        benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic,
        allow_tf32=False,
    ):
        out = F.conv1d(lhs, rhs, stride=D)
    return out.reshape(batch + (M,))


def _fir_poly(x: torch.Tensor, taps: torch.Tensor, D: int, M: int) -> torch.Tensor:
    """Polyphase-frame path (real only; the caller splits complex),
    fir.py:196-226.  Reversed taps zero-padded to P*D as H (P, D); x
    zero-padded to (M+P-1)*D as frames (M+P-1, D); then
    y[m] = sum_p frames[m+p] . H[p], accumulated over P shifted views of
    the frames (no P-fold stacked copy)."""
    T = taps.shape[-1]
    P = cdiv(T, D)
    h_poly = F.pad(torch.flip(taps, [-1]).to(torch.float32), (0, P * D - T)).reshape(P, D)
    need = (M + P - 1) * D
    x = x.to(torch.float32)
    x = F.pad(x, (0, need - x.shape[-1])) if need > x.shape[-1] else x[..., :need]
    frames = x.reshape(x.shape[:-1] + (M + P - 1, D))
    acc = torch.matmul(frames[..., 0:M, :], h_poly[0])
    for p in range(1, P):
        acc = acc + torch.matmul(frames[..., p : p + M, :], h_poly[p])
    return acc


def _fft_segment_plan(T: int, D: int, M: int) -> tuple[int, int, int]:
    """(n_fft, hop, n_segments) for overlap-save (fir.py:343-357): segments
    of ~8x the taps, clamped to [1024, 32768], hop a multiple of D."""
    n_fft = min(max(next_pow2(8 * T), 1024), 1 << 15)
    while n_fft - T + 1 < D:
        n_fft *= 2
    hop = ((n_fft - T + 1) // D) * D
    return n_fft, hop, cdiv(M * D, hop)


def _fir_fft(x: torch.Tensor, taps: torch.Tensor, D: int, M: int) -> torch.Tensor:
    """Segmented overlap-save, then decimation (fir.py:371-421, its native
    complex path).  Segment s is x[s*hop : s*hop + n_fft]; its circular
    outputs [T-1, T-1+hop) are linear, so the segments together give the
    valid convolution, and every D-th of them the decimated output."""
    T = taps.shape[-1]
    n_fft, hop, n_seg = _fft_segment_plan(T, D, M)
    complex_io = x.is_complex() or taps.is_complex()
    x = x.to(torch.complex64 if complex_io else torch.float32)
    need = (n_seg - 1) * hop + n_fft
    x = F.pad(x, (0, need - x.shape[-1])) if need > x.shape[-1] else x[..., :need]
    A = x.unfold(-1, n_fft, hop)  # (..., n_seg, n_fft) views
    if complex_io:
        H = torch.fft.fft(taps.to(torch.complex64), n=n_fft)
        y = torch.fft.ifft(torch.fft.fft(A, dim=-1) * H, dim=-1)
    else:
        H = torch.fft.rfft(taps.to(torch.float32), n=n_fft)
        y = torch.fft.irfft(torch.fft.rfft(A, dim=-1) * H, n=n_fft, dim=-1)
    valid = y[..., T - 1 : T - 1 + hop]
    if D > 1:
        valid = valid.reshape(valid.shape[:-1] + (hop // D, D))[..., 0]
    return valid.reshape(valid.shape[:-2] + (-1,))[..., :M]


def _mxu_tile_width(T: int, D: int, M: int) -> int:
    """Outputs per row tile (fir.py:229-240)."""
    c = max(128, round_up(cdiv(T - D, 2 * D), 128))
    if M < c:
        c = round_up(M, 8)
    return c


def _mxu_row_chunks(x: torch.Tensor, c: int, D: int, T: int, M: int):
    """(..., L) -> the zero-padded (..., rows+q, G) row-chunk view + (q, K)."""
    G = c * D
    K = (c - 1) * D + T
    n_rows = cdiv(M, c)
    q = cdiv(T - 1, G)
    pad = (n_rows + q) * G - x.shape[-1]
    x = F.pad(x.to(torch.float32), (0, pad))
    return x.reshape(x.shape[:-1] + (n_rows + q, G)), q, K, n_rows


@functools.lru_cache(maxsize=16)
def _band_index(T: int, c: int, D: int, device: str):
    """Gather index and mask of the banded tap matrix, kept on the device."""
    K = (c - 1) * D + T
    i_idx = np.arange(K)[:, None] - np.arange(c)[None, :] * D
    mask = torch.from_numpy((i_idx >= 0) & (i_idx < T)).to(device)
    return torch.from_numpy(np.clip(i_idx, 0, T - 1)).to(device), mask


def _mxu_band(taps: torch.Tensor, c: int, D: int) -> torch.Tensor:
    """Banded tap matrix W[i, j] = h_rev[i - j*D] (zero outside the band)."""
    idx, mask = _band_index(taps.shape[-1], c, D, str(taps.device))
    h_rev = torch.flip(taps, [-1]).to(torch.float32)
    return torch.where(mask, h_rev[idx], torch.zeros((), device=taps.device))


def _mxu_matmul(R, q, K, n_rows, W, c, D, M) -> torch.Tensor:
    """Banded contraction over row-chunk views: y = sum_j A_j @ W_j."""
    G = c * D
    acc = None
    for j in range(q + 1):
        w = min(G, K - j * G)
        if w <= 0:
            break
        term = torch.matmul(R[..., j : j + n_rows, :w], W[j * G : j * G + w, :])
        acc = term if acc is None else acc + term
    return acc.reshape(acc.shape[:-2] + (-1,))[..., :M]


def _fir_mxu(x: torch.Tensor, taps: torch.Tensor, D: int, M: int) -> torch.Tensor:
    """Banded-matmul FIR, real data and real taps (fir.py:297-314)."""
    T = taps.shape[-1]
    c = _mxu_tile_width(T, D, M)
    R, q, K, n_rows = _mxu_row_chunks(x, c, D, T, M)
    return _mxu_matmul(R, q, K, n_rows, _mxu_band(taps, c, D), c, D, M)


def _fir_mxu_cc(x: torch.Tensor, taps: torch.Tensor, D: int, M: int) -> torch.Tensor:
    """Complex data x complex taps: four real matmuls over two shared
    row-chunk views (fir.py:317-340)."""
    T = taps.shape[-1]
    c = _mxu_tile_width(T, D, M)
    Rr, q, K, n_rows = _mxu_row_chunks(x.real, c, D, T, M)
    Ri, _, _, _ = _mxu_row_chunks(x.imag, c, D, T, M)
    Wr = _mxu_band(taps.real, c, D)
    Wi = _mxu_band(taps.imag, c, D)

    def mm(R, W):
        return _mxu_matmul(R, q, K, n_rows, W, c, D, M)

    return torch.complex(mm(Rr, Wr) - mm(Ri, Wi), mm(Rr, Wi) + mm(Ri, Wr))


# ---------------------------------------------------------------------------
# Streaming interface
# ---------------------------------------------------------------------------


def fir_init_state(num_taps: int, complex_data: bool, batch_shape=(), device=None):
    """Zero history carry of length T-1 (the cold-start state)."""
    dt = torch.complex64 if complex_data else torch.float32
    shape = tuple(batch_shape) + (history_len(num_taps),)
    return torch.zeros(shape, dtype=dt, device=device)


def fir_apply(state, x, taps, decimation: int = 1, mode: FirMode = "auto"):
    """One streaming step: (history, block) -> (history', outputs).

    ``x.shape[-1]`` must be a multiple of ``decimation``, so exactly
    len(x)/D outputs come out and the history stays T-1 samples long."""
    D = int(decimation)
    N = x.shape[-1]
    if N % D != 0:
        raise ValueError(f"block length {N} not divisible by decimation {D}")
    ext = torch.cat([state, x], dim=-1)
    y = fir_extended(ext, taps, D, mode)
    T = taps.shape[-1]
    return ext[..., ext.shape[-1] - (T - 1) :].clone(), y
