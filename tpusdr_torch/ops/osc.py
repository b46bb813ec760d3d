"""Numerically-controlled oscillator with a uint32 phase accumulator.

Port of tpusdr/ops/osc.py.  The phase is a uint32 fixed-point count of
cycles (units of 2^-32), so the per-block update is exact integer
arithmetic and the oscillator never drifts.  The carried phase depends
only on sample counts, so it is a Python int in the stream state: it stays
on the host and costs no device sync per tick.

Per-sample phases are ``phase + k * inc (mod 2^32)``.  Torch has no uint32
add on the CPU, so they are computed in int64 and masked to 32 bits
(k * inc < 2^53 for any realistic block).  The angle is then
``float32(phase) * 2*pi/2^32`` exactly as the JAX package computes it;
exp(j*angle) is evaluated directly (the JAX package's angle-addition
factorisation is a TPU transcendental workaround and is not ported).
"""

from __future__ import annotations

import numpy as np
import torch

from tpusdr_torch.ops import cplx

TWO_PI = 2.0 * np.pi
_PHASE_SCALE = np.float32(TWO_PI / 4294967296.0)  # 2*pi / 2^32
_MASK = (1 << 32) - 1


def freq_to_inc_u32(frequency: float, sample_rate: float) -> int:
    """Quantize a frequency to a uint32 phase increment (cycles * 2^32)."""
    cycles_per_sample = float(frequency) / float(sample_rate)
    return int(round((cycles_per_sample % 1.0) * 4294967296.0)) % 4294967296


def init_phase(initial_radians: float = 0.0) -> int:
    cycles = (initial_radians / TWO_PI) % 1.0
    return int(round(cycles * 4294967296.0)) % 4294967296


def advance_phase(phase_u32: int, inc_u32: int, num: int) -> int:
    """Exact phase accumulator update for a block of ``num`` samples."""
    return (int(phase_u32) + int(inc_u32) * int(num)) & _MASK


def phase_angles(phase_u32: int, inc_u32: int, num: int, device=None) -> torch.Tensor:
    """Radian angles float32(phase) * 2*pi/2^32 of ``num`` consecutive
    samples, the uint32 phases held in int64."""
    k = torch.arange(num, dtype=torch.int64, device=device)
    ph = (k * int(inc_u32) + int(phase_u32)) & _MASK
    return ph.to(torch.float32) * float(_PHASE_SCALE)


def complex_cosine_block(
    phase_u32: int, inc_u32: int, num: int, amplitude: float = 1.0, device=None
) -> torch.Tensor:
    """exp(j*theta[k]) for ``num`` samples as complex64 (gsdrCosineC)."""
    out = cplx.expj(phase_angles(phase_u32, inc_u32, num, device))
    if amplitude != 1.0:
        out = out * amplitude
    return out
