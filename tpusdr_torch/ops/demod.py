"""Demodulators and elementwise ops (port of tpusdr/ops/demod.py:24-92).

FM quadrature discriminator: y[n] = gain * arg(x[n+1] * conj(x[n])), with
``torch.atan2`` in place of the JAX package's polynomial atan (a TPU
workaround, ops/xmath.py).  AM envelope, magnitude, constant adds and the
block-mean DC removal are stateless 1:1 maps.
"""

from __future__ import annotations

import math

import numpy as np
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


def quad_am_demod(x: torch.Tensor) -> torch.Tensor:
    """AM envelope demod: |x|, 1:1, stateless (QuadAmDemod.cpp:81-108)."""
    return torch.abs(x).to(torch.float32)


def magnitude(x: torch.Tensor) -> torch.Tensor:
    """|z| of a complex stream (Magnitude.cpp:91-96)."""
    return quad_am_demod(x)


def add_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """Scalar add (AddConst.cpp:99); on a complex stream, to the real part."""
    return x + float(np.float32(c))


def add_const_to_vector_length(x: torch.Tensor, c: float) -> torch.Tensor:
    """Add a constant to the magnitude of each complex sample, keeping its
    phase (AddConstToVectorLength.cpp:97-103); zero stays zero."""
    mag = torch.abs(x)
    c = float(np.float32(c))
    scale = torch.where(mag > 0, (mag + c) / torch.clamp(mag, min=1e-30), torch.zeros_like(mag))
    return x * scale


def dc_block(x: torch.Tensor) -> torch.Tensor:
    """Remove the block mean (simple DC removal after the AM envelope)."""
    return x - torch.mean(x, dim=-1, keepdim=True)
