"""Numerically-controlled oscillator with a uint32 phase accumulator.

Port of tpusdr/ops/osc.py.  The phase is a uint32 fixed-point count of
cycles (units of 2^-32), so the per-block update is exact integer
arithmetic and the oscillator never drifts.

The carried phase is a 0-d int64 tensor on the stream's device holding
the uint32 value, as the JAX package carries a uint32 device scalar.  It
is advanced on the device by ``(phase + k*inc) & (2^32 - 1)`` and never
read back to the host, so a tick costs no device sync and a captured step
(``graph/runner.py``) replays the advance with the rest of the tick.  The
increment stays a host int: it is a parameter, not a carry.  A bank of C
oscillators carries C phases, a (C,) int64 tensor, and its C increments
are a (C,) int64 tensor on the same device (``as_phases``).  Phase tensors
carry a mark (``is_phase``) that tells them apart from other 0-d int64
leaves, such as a sample count, where a checkpoint or ``convert`` stores
them as uint32.

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


def radians_to_u32(radians: float) -> int:
    """Quantize an angle to a uint32 phase value (cycles * 2^32)."""
    cycles = (radians / TWO_PI) % 1.0
    return int(round(cycles * 4294967296.0)) % 4294967296


def _mark(phase: torch.Tensor) -> torch.Tensor:
    phase._tpusdr_u32_phase = True
    return phase


def is_phase(leaf) -> bool:
    """True for a carried NCO phase (made by this module)."""
    return isinstance(leaf, torch.Tensor) and getattr(leaf, "_tpusdr_u32_phase", False)


def as_phase(value_u32, device=None) -> torch.Tensor:
    """A uint32 value (a host int, or a tensor holding one) as the carried
    phase: a 0-d int64 tensor on ``device``."""
    if isinstance(value_u32, torch.Tensor):
        return _mark(value_u32.to(device=device, dtype=torch.int64).reshape(()) & _MASK)
    return _mark(torch.tensor(int(value_u32) & _MASK, dtype=torch.int64, device=device))


def as_phases(values_u32, device=None) -> torch.Tensor:
    """C uint32 values (host ints) as the carried phases of C oscillators:
    a (C,) int64 tensor on ``device``."""
    return _mark(torch.tensor([int(v) & _MASK for v in values_u32], dtype=torch.int64, device=device))


def init_phase(initial_radians: float = 0.0, device=None) -> torch.Tensor:
    return as_phase(radians_to_u32(initial_radians), device)


def advance_phase(phase_u32: torch.Tensor, inc_u32, num: int) -> torch.Tensor:
    """Exact phase accumulator update for ``num`` samples (a host int; a
    negative count goes back), on the phase's device; ``inc_u32`` a host
    int, or C increments (a tensor) for C phases."""
    step = inc_u32 * int(num) if isinstance(inc_u32, torch.Tensor) else int(inc_u32) * int(num)
    return _mark((phase_u32 + (step & _MASK)) & _MASK)


def phase_angles(phase_u32: torch.Tensor, inc_u32, num: int) -> torch.Tensor:
    """Radian angles float32(phase) * 2*pi/2^32 of ``num`` consecutive
    samples on the phase's device, the uint32 phases held in int64; with C
    increments (a tensor) and C phases, (C, num) of them."""
    k = torch.arange(num, dtype=torch.int64, device=phase_u32.device)
    if isinstance(inc_u32, torch.Tensor):
        ph = (k * inc_u32[..., None] + phase_u32[..., None]) & _MASK
    else:
        ph = (k * int(inc_u32) + phase_u32) & _MASK
    return ph.to(torch.float32) * float(_PHASE_SCALE)


def cosine_block(phase_u32: torch.Tensor, inc_u32: int, num: int, amplitude: float = 1.0) -> torch.Tensor:
    """cos(theta[k]) for ``num`` samples as float32 (gsdrCosineF)."""
    out = torch.cos(phase_angles(phase_u32, inc_u32, num))
    if amplitude != 1.0:
        out = out * amplitude
    return out


def complex_cosine_block(phase_u32: torch.Tensor, inc_u32: int, num: int, amplitude: float = 1.0) -> torch.Tensor:
    """exp(j*theta[k]) for ``num`` samples as complex64 (gsdrCosineC)."""
    out = cplx.expj(phase_angles(phase_u32, inc_u32, num))
    if amplitude != 1.0:
        out = out * amplitude
    return out
