"""FM quadrature discriminator (port of tpusdr/ops/demod.py:24-58).

y[n] = gain * arg(x[n+1] * conj(x[n])), with ``torch.atan2`` in place of
the JAX package's polynomial atan (a TPU workaround, ops/xmath.py).
"""

from __future__ import annotations

import math

import torch

from tpusdr_torch.ops import cplx


def arg(im: torch.Tensor, re: torch.Tensor) -> torch.Tensor:
    """atan2(im, re) with arg(0) = 0.  A zero product (the cold-start
    sample against a zero carry) can come out as (+-0, -0), where libm's
    atan2 gives +-pi; adding +0.0 turns -0 into +0, so the result is 0 as
    in the JAX package's atan2 (ops/xmath.py)."""
    return torch.atan2(im, re + 0.0)


def quad_fm_demod_ext(x_ext: torch.Tensor, gain: float) -> torch.Tensor:
    """Discriminator on an extended block: (..., N+1) complex -> (..., N)."""
    prod = x_ext[..., 1:] * x_ext[..., :-1].conj()
    return gain * arg(prod.imag, prod.real)


def quad_fm_demod_init(batch_shape=(), device=None) -> torch.Tensor:
    return cplx.zeros(tuple(batch_shape) + (1,), device)


def quad_fm_demod_apply(state: torch.Tensor, x: torch.Tensor, gain: float):
    """Streaming step; the carry is the previous complex sample."""
    ext = torch.cat([state, x], dim=-1)
    return ext[..., -1:].clone(), quad_fm_demod_ext(ext, gain)


def quad_fm_demod_gain(sample_rate: float, channel_width: float) -> float:
    """gain = Fs / (2*pi*channelWidth)."""
    return sample_rate / (2.0 * math.pi * channel_width)
