"""Rational polyphase resampling with streaming state.

Port of tpusdr/ops/resample.py:37-231 (upfirdn semantics):

    y[m] = sum_i h[p_m + i*U] * x[n_m - i],  p_m = (m*D) mod U,
                                             n_m = (m*D) div U.

Outputs of phase class c (m = c + U*t) form a regular P-tap decimate-by-D
FIR, so the resampler is U such FIRs over polyphase frames plus an
interleave (``_resample_real``, the plain version of the card's kernel
``kernels/resample_poly.py``).  Streaming requires N*U % D == 0 per block;
the carry is the last ceil(T/U)-1 input samples.  ``up == 1`` delegates to the decimating
FIR with the same T-1 history.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from tpusdr_torch.ops import design
from tpusdr_torch.utils.numerics import cdiv


def design_resampler_taps(
    up: int,
    down: int,
    db_attenuation: float = -60.0,
    transition_frac: float = 0.2,
    dtype=np.float32,
) -> np.ndarray:
    """Anti-alias/anti-image prototype for a U/D resampler (passband gain U)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return np.array([1.0], dtype=dtype)
    fs_up = float(up)
    cutoff = 0.5 * fs_up / max(up, down)
    transition = cutoff * transition_frac
    taps = design.kaiser_lowpass(fs_up, cutoff - transition, transition, db_attenuation)
    return (np.asarray(taps, np.float64) * up).astype(dtype)


@dataclass(frozen=True)
class ResamplerPlan:
    """Static plan for one block size."""

    up: int
    down: int
    num_taps: int
    taps_per_phase: int  # Pmax = ceil(T / U)
    block_in: int
    block_out: int
    # (block_out, Pmax) per-output tap rows (phase-selected, zero-padded)
    tap_rows: np.ndarray = field(repr=False)
    # the original prototype (for the up == 1 decimating-FIR path)
    taps: np.ndarray = field(repr=False, default=None)
    # (U, pp, D) reversed per-class taps in polyphase-frame layout
    frame_taps: np.ndarray = field(repr=False, default=None)

    @property
    def history(self) -> int:
        return self.taps_per_phase - 1


def make_plan(taps: np.ndarray, up: int, down: int, block_in: int) -> ResamplerPlan:
    g = math.gcd(up, down)
    up, down = up // g, down // g
    T = len(taps)
    pmax = cdiv(T, up)
    if (block_in * up) % down != 0:
        raise ValueError(
            f"block_in*up ({block_in}*{up}) must be divisible by down ({down}) "
            "for phase-continuous streaming"
        )
    block_out = block_in * up // down

    m = np.arange(block_out, dtype=np.int64)
    p = (m * down) % up
    h_pad = np.zeros(up * pmax, dtype=np.float32)
    h_pad[:T] = np.asarray(taps, np.float32)
    h_poly = h_pad.reshape(pmax, up).T  # (up, pmax): row p = h[p::up]
    rows = h_poly[p]  # (block_out, pmax)

    # class c's taps (phase (c*D) mod U), reversed and framed by D
    pp = cdiv(pmax, down)
    h_classes = h_poly[(np.arange(up) * down) % up]  # (U, Pmax)
    frames = np.zeros((up, pp * down), np.float32)
    frames[:, :pmax] = h_classes[:, ::-1]
    return ResamplerPlan(
        up=up,
        down=down,
        num_taps=T,
        taps_per_phase=pmax,
        block_in=block_in,
        block_out=block_out,
        tap_rows=rows,
        taps=np.asarray(taps, np.float32),
        frame_taps=frames.reshape(-1, pp, down),
    )


def resample_init(plan: ResamplerPlan, batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros(tuple(batch_shape) + (plan.history,), dtype=torch.float32, device=device)


def _resample_real(ext: torch.Tensor, plan: ResamplerPlan, frame_taps: torch.Tensor) -> torch.Tensor:
    U, D, P = plan.up, plan.down, plan.taps_per_phase
    t_count = plan.block_out // U
    pp = frame_taps.shape[1]
    lc = (P - 1) + t_count * D
    starts = [(c * D) // U for c in range(U)]  # n_c
    overrun = max(starts) + lc - ext.shape[-1]
    if overrun > 0:
        ext = torch.nn.functional.pad(ext, (0, overrun))
    xs = torch.stack([ext[..., s : s + lc] for s in starts], dim=-2)  # (..., U, Lc)
    need = (t_count + pp - 1) * D
    if need > lc:
        xs = torch.nn.functional.pad(xs, (0, need - lc))
    else:
        xs = xs[..., :need]
    frames = xs.reshape(xs.shape[:-1] + (t_count + pp - 1, D))
    v = torch.zeros(frames.shape[:-2] + (t_count,), dtype=torch.float32, device=ext.device)
    for p in range(pp):
        w = frames[..., p : p + t_count, :]  # (..., U, t, D)
        v = v + torch.einsum("...utd,ud->...ut", w, frame_taps[:, p])
    # interleave classes: m = c + U*t
    return v.transpose(-1, -2).reshape(v.shape[:-2] + (plan.block_out,))


def plan_taps(plan: ResamplerPlan, device=None) -> torch.Tensor:
    """The taps a step reads, on ``device``: the prototype where up == 1
    (a decimating FIR), else ``kernels.resample_poly.tap_table``."""
    if plan.up == 1 and plan.down > 1:
        return torch.from_numpy(plan.taps).to(device)
    from tpusdr_torch.kernels.resample_poly import tap_table

    return tap_table(plan, device)


def resample_apply(state, x, plan: ResamplerPlan, taps: torch.Tensor | None = None):
    """One streaming step of the polyphase resampler (real or complex64).

    ``taps`` is ``plan_taps(plan, x.device)``; the Resampler block caches
    it, since a copy from host memory every step would wait for the device
    each time.  Built here when not given.  ``up == 1`` is the decimating
    FIR; else ``kernels.resample_poly``: on the card one kernel over every
    row, on the CPU ``_resample_real`` behind the ``cat``."""
    if x.shape[-1] != plan.block_in:
        raise ValueError(f"expected block of {plan.block_in}, got {x.shape[-1]}")
    if taps is None:
        taps = plan_taps(plan, x.device)
    if plan.up == 1 and plan.down > 1:
        from tpusdr_torch.ops import fir

        return fir.fir_apply(state, x, taps, plan.down)
    from tpusdr_torch.kernels.resample_poly import resample_poly

    return resample_poly(state, x, plan, taps)
