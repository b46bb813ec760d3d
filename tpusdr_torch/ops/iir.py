"""One-pole IIR (FM de-emphasis) as blocked triangular matmuls.

Port of tpusdr/ops/iir.py:23-139.  y[n] = a*y[n-1] + b*x[n] is solved per
frame of B samples with one lower-triangular matmul (the JAX package's
``_first_order_blocked``):

    frame f, entry state s_f:  y_f[i] = a^(i+1) s_f + (L @ u_f)[i],
    L[i, j] = a^(i-j) (j <= i).

Torch has no ``associative_scan``, so the frame-entry recurrence
s_{f+1} = a^B s_f + w_f (w_f = last sample of L @ u_f) is a second F x F
lower-triangular matmul, s_f = a^(Bf) s_0 + sum_{g<f} a^(B(f-1-g)) w_g,
with the powers formed in float64 and rounded once.  A cumulative sum over
a^(-Bk) would be shorter but overflows float32: at the 400 kHz WBFM quad
rate a^256 ~ 2e-4, and a 1.28M-sample tick has 100 frames.  Powers that
underflow to 0 are exact to float32.  Every block length takes this one
path (zero-padded to a frame multiple: outputs depend only on the past).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_BLOCK = 256


def single_pole_coeffs(tau_seconds: float, sample_rate: float) -> tuple[float, float]:
    """y[n] = a*y[n-1] + b*x[n]; one-pole RC de-emphasis (same numbers as
    the JAX package: alpha = 1 - exp(-1/(tau*fs)), a = 1 - alpha, b = alpha)."""
    alpha = 1.0 - math.exp(-1.0 / (tau_seconds * sample_rate))
    return (1.0 - alpha, alpha)


def deemphasis_coeffs(tau_seconds: float, sample_rate: float) -> tuple[float, float]:
    return single_pole_coeffs(tau_seconds, sample_rate)


def single_pole_init(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros(tuple(batch_shape) + (1,), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=32)
def _frame_mats(a: float, block: int, device: str):
    """L^T (B, B) and a^(i+1) (B,) as the JAX package builds them."""
    i = np.arange(block)
    lower = np.tril(np.float32(a) ** np.maximum(i[:, None] - i[None, :], 0))
    pow_in = np.float32(a) ** (i + 1)
    return (
        torch.from_numpy(np.ascontiguousarray(lower.T.astype(np.float32))).to(device),
        torch.from_numpy(pow_in.astype(np.float32)).to(device),
    )


@functools.lru_cache(maxsize=32)
def _entry_mats(a: float, block: int, frames: int, device: str):
    """(F, F) map from frame sums w to entry states, and a^(B f) (F,)."""
    ab = float(np.float32(a)) ** block
    f = np.arange(frames)
    e = f[:, None] - 1 - f[None, :]
    m = np.where(e >= 0, ab ** np.maximum(e, 0).astype(np.float64), 0.0)
    return (
        torch.from_numpy(np.ascontiguousarray(m.T.astype(np.float32))).to(device),
        torch.from_numpy((ab ** f.astype(np.float64)).astype(np.float32)).to(device),
    )


def _first_order_blocked(a: float, bx: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    n = bx.shape[-1]
    f = n // _BLOCK
    dev = str(bx.device)
    lt, pow_in = _frame_mats(float(a), _BLOCK, dev)
    et, pow_entry = _entry_mats(float(a), _BLOCK, f, dev)
    u = bx.reshape(bx.shape[:-1] + (f, _BLOCK))
    v = torch.matmul(u, lt)  # (..., F, B): v[f, i] = sum_j L[i, j] u[f, j]
    w = v[..., _BLOCK - 1]  # (..., F)
    entry = torch.matmul(w, et) + y0 * pow_entry  # (..., F)
    y = v + entry[..., None] * pow_in
    return y.reshape(bx.shape)


def single_pole_apply(state: torch.Tensor, x: torch.Tensor, a: float, b: float):
    """Streaming one-pole IIR step; the carry is the previous output."""
    n = x.shape[-1]
    bx = float(np.float32(b)) * x
    pad = (-n) % _BLOCK
    if pad:
        bx = torch.nn.functional.pad(bx, (0, pad))
    y = _first_order_blocked(a, bx, state)[..., :n]
    return y[..., -1:].clone(), y
