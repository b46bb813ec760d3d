"""Frequency translation with a uint32 NCO (port of tpusdr/ops/mix.py).

Oscillator and multiply fuse into one elementwise op,
``freq_shift_apply``, whose carry is the uint32 phase (a Python int).
"""

from __future__ import annotations

import torch

from tpusdr_torch.ops import osc


def freq_shift_init(initial_radians: float = 0.0) -> int:
    return osc.init_phase(initial_radians)


def freq_shift_apply(phase_u32: int, x: torch.Tensor, inc_u32: int):
    """Multiply a complex block by exp(j*theta[n]); theta advances by the
    NCO increment per sample.  Use ``osc.freq_to_inc_u32(-f, fs)`` to shift
    a component at +f down to baseband."""
    n = x.shape[-1]
    lo = osc.complex_cosine_block(phase_u32, inc_u32, n, device=x.device)
    return osc.advance_phase(phase_u32, inc_u32, n), x.to(torch.complex64) * lo
