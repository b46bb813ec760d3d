"""Polyphase filterbank channelizer, M channels, maximally decimated (port
of tpusdr/ops/channelizer.py).

With the prototype low-pass h padded to P*M taps,

    v[m, r] = sum_p h[p*M + r] * x[(m-p)*M - r]
    y_k[m]  = sum_r e^{+j 2 pi k r / M} * v[m, r]      (an unscaled inverse DFT)

so channel k equals "shift by -k*fs/M, low-pass h, decimate by M" (channel
k sits at +k*fs/M, read mod M).  The carry is the last P*M - 1 input
samples.

Computed in channel-major layout, (..., M, F), as the JAX package's
``channel_major`` form is:

  * frames Zt[r', k] = ext[k*M + r'] of ext = [carry, x], from a reshape
    and one transpose (``_frames_cm``);
  * the branch filter along the frame axis, with the lane flip r = M-1-r'
    folded into the taps: v'[r', f] = sum_p h[p*M + M-1-r'] *
    Zt[r', f + P-1-p], P shifted multiply-adds (``_branch_filter_cm``);
  * the DFT across the branches.  The flip makes it
    sum_r' e^{+j 2 pi k (M-1-r') / M} v'[r'] = e^{-j 2 pi k / M} FFT(v')[k]:
    one ``torch.fft.fft`` along the channel axis and a phase a channel, in
    place of the JAX package's matmul DFT (ops/fft.py, a TPU workaround).

``channel_major=False`` returns the transpose, (..., F, M), of the same
computation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpusdr_torch.ops import design
from tpusdr_torch.utils.numerics import cdiv


def design_prototype(
    num_channels: int,
    taps_per_channel: int = 12,
    db_attenuation: float = -60.0,
    dtype=np.float32,
) -> np.ndarray:
    """Prototype low-pass for an M-channel filterbank: cutoff at half the
    channel spacing, length taps_per_channel * M."""
    m = num_channels
    cutoff = 0.5 / m  # input fs = 1, channel width 1/M
    transition = 0.8 * cutoff
    h = design.kaiser_lowpass(
        1.0, cutoff - transition / 2, transition, db_attenuation, num_taps=taps_per_channel * m
    )
    return np.asarray(h, dtype)


def carry_len(num_taps: int, num_channels: int) -> int:
    """Carried input samples: the taps padded to a multiple of M, less one."""
    return cdiv(num_taps, num_channels) * num_channels - 1


@dataclass(frozen=True)
class ChannelizerPlan:
    num_channels: int
    taps_per_phase: int  # P
    block_in: int
    frames_out: int  # block_in / M
    h_poly: np.ndarray = field(repr=False)  # (P, M): h[p*M + r]

    @property
    def history(self) -> int:
        return self.taps_per_phase * self.num_channels - 1


def make_plan(taps: np.ndarray, num_channels: int, block_in: int) -> ChannelizerPlan:
    m = num_channels
    p = cdiv(len(taps), m)
    if block_in % m != 0:
        raise ValueError(f"block_in {block_in} not divisible by channels {m}")
    h_pad = np.zeros(p * m, np.float32)
    h_pad[: len(taps)] = np.asarray(taps, np.float32)
    return ChannelizerPlan(
        num_channels=m, taps_per_phase=p, block_in=block_in, frames_out=block_in // m,
        h_poly=h_pad.reshape(p, m),
    )


def plan_tensors(plan: ChannelizerPlan, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plan's constants on ``device``: the taps with the lane flip
    folded in, h_cm[p, r'] = h_poly[p, M-1-r'], as (P, M, 1, 1) float32,
    and the phase e^{-j 2 pi k / M} a channel, (M, 1) complex64."""
    m = plan.num_channels
    h_cm = np.ascontiguousarray(plan.h_poly[:, ::-1]).reshape(plan.taps_per_phase, m, 1, 1)
    phase = np.exp(-2j * np.pi * np.arange(m) / m).astype(np.complex64).reshape(m, 1)
    return torch.from_numpy(h_cm).to(device), torch.from_numpy(phase).to(device)


def channelize_init(plan: ChannelizerPlan, batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros(tuple(batch_shape) + (plan.history,), dtype=torch.complex64, device=device)


def _frames_cm(ext: torch.Tensor, plan: ChannelizerPlan) -> torch.Tensor:
    """(..., L) -> (..., M, F+P-1) channel-major frames Zt[r', k] =
    ext[k*M + r'] as a real view (..., M, F+P-1, 2).  The frame after them
    would only feed outputs past this block, so it is left out."""
    m, k = plan.num_channels, plan.frames_out + plan.taps_per_phase - 1
    z = ext[..., : k * m].reshape(ext.shape[:-1] + (k, m))
    return torch.view_as_real(z.transpose(-1, -2).contiguous())


def _branch_filter_cm(zt: torch.Tensor, h_cm: torch.Tensor, plan: ChannelizerPlan) -> torch.Tensor:
    """v'[r', f] = sum_p h_cm[p, r'] * Zt[r', f + P-1-p]: P shifted slices
    along the frame axis, one multiply-add each; (..., M, F) complex64."""
    p_taps, f = plan.taps_per_phase, plan.frames_out
    acc = zt[..., p_taps - 1 : p_taps - 1 + f, :] * h_cm[0]
    for p in range(1, p_taps):
        s = p_taps - 1 - p
        acc.addcmul_(zt[..., s : s + f, :], h_cm[p])
    return torch.view_as_complex(acc)


def branch_filter(state, x, plan: ChannelizerPlan, h_cm: torch.Tensor):
    """The first half of a step: (carry', v') with v' the branch filter's
    output, (..., M, F) complex64 with the branches in flipped order."""
    ext = torch.cat([state, x], dim=-1)
    v = _branch_filter_cm(_frames_cm(ext, plan), h_cm, plan)
    return ext[..., ext.shape[-1] - plan.history :].clone(), v


def branch_dft(v: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """The second half: the DFT across the branches of ``branch_filter``'s
    v', e^{-j 2 pi k / M} FFT(v')[k] along the channel axis."""
    return torch.fft.fft(v, dim=-2) * phase


def channelize_apply(state, x, plan: ChannelizerPlan, channel_major: bool = False, consts=None):
    """One streaming step: complex64 (..., block_in) -> (..., M, F) with
    ``channel_major``, else (..., F, M); out[..., k, f] is sample f of
    channel k.  ``consts`` is ``plan_tensors(plan, x.device)`` (the
    Channelizer block caches it); built here when not given."""
    if x.shape[-1] != plan.block_in:
        raise ValueError(f"expected block of {plan.block_in}, got {x.shape[-1]}")
    h_cm, phase = consts if consts is not None else plan_tensors(plan, x.device)
    new_state, v = branch_filter(state, x, plan, h_cm)
    y = branch_dft(v, phase)
    return new_state, (y if channel_major else y.transpose(-1, -2))
