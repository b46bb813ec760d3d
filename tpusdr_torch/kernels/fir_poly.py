"""Polyphase decimating FIR, complex data x real taps: kernel K4
(``csrc/fir_poly.cu``) and its plain version.

Replaces ``fir_decim_pallas`` (tpusdr/kernels/fir_pallas.py).  With no
history the contract is that of ``ops.fir.fir_extended`` for a complex
stream and real taps: x_ext of length L gives M = (L - (T-1)) // D outputs

    y[m] = sum_j taps[j] * x_ext[m*D + T-1-j].

With ``history`` the stream is s = [history, x], read through two
pointers, so a streaming caller hands over its carried samples and the
tick as they lie and nothing is copied in front of the launch.  A CUDA
tensor launches the kernel; a CPU tensor takes the plain version,
``ops.fir._fir_poly`` on the stacked I and Q (the FC branch of
``fir_extended``).

``fir_decim_plan`` is the card's shape rule: from (T, D, M) it picks the
kernel's inner loop (phase-major for a long tick at a moderate D, lanes
across outputs for D < 8, lanes across taps else), its tile and tap chunk,
so that one block's shared memory stays within an H100's 232,448 bytes
for every shape the receivers build and the grid fills the card's 132 SMs
where M allows it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpusdr_torch.kernels.dispatch import check_launch, launch_target, on_cuda
from tpusdr_torch.kernels.fir_banded import (
    KERNEL_WARPS,
    PHASE_MIN_BLOCKS,
    SM_COUNT,
    SMEM_LIMIT,
    phase_pitch,
    tap_chunk,
)
from tpusdr_torch.utils.numerics import cdiv

FORMS = ("taps", "phase", "outputs")  # the kernel's inner loops, by their index on the C side
PHASE_TILES = (224, 160)  # outputs a block of the phase-major form: R = 7 and 5 a lane
TAP_TILES = (64, 56, 48, 40, 32, 24, 16, 8)  # outputs a block of the lanes-across-taps form: k a warp
OUTPUT_TILES = (256, 128, 64, 32)  # outputs a block of the lanes-across-outputs form
KERNEL_THREADS = 32 * KERNEL_WARPS


class FirDecimPlan(NamedTuple):
    """How one K4 launch is cut: the kernel's inner loop (``FORMS``),
    ``tile`` outputs a block, ``chunk`` taps a pass (T unless shared memory
    forces less)."""

    form: str
    tile: int
    chunk: int


def fir_decim_smem(T: int, D: int, plan: FirDecimPlan) -> int:
    """Shared memory of one K4 block (csrc/fir_poly.cu, smem_bytes).  Form
    "taps": the window of ``tile`` outputs over ``chunk`` taps, then the
    chunk's taps.  Form "phase": tile + Q - 1 rows of D samples at an odd
    pitch, the warps' partial sums, the taps by phase.  Form "outputs": the
    window, 256 partial sums, the chunk's taps."""
    if plan.form == "phase":
        Q = cdiv(T, D)
        return ((plan.tile + Q - 1) * phase_pitch(D) + KERNEL_WARPS * plan.tile) * 8 + D * Q * 4
    red = KERNEL_THREADS if plan.form == "outputs" else 0
    return ((plan.tile - 1) * D + plan.chunk + red) * 8 + plan.chunk * 4


def fir_decim_blocks(M: int, plan: FirDecimPlan) -> int:
    """Blocks of a launch of M outputs."""
    return cdiv(M, plan.tile)


def busiest_sm_samples(D: int, M: int, plan: FirDecimPlan) -> int:
    """Window samples the busiest SM stages in a launch of a window form:
    ceil(blocks / 132) blocks of (tile-1)*D + chunk samples each."""
    return cdiv(fir_decim_blocks(M, plan), SM_COUNT) * ((plan.tile - 1) * D + plan.chunk)


def _fill_the_card(T: int, D: int, M: int, form: str, tiles) -> FirDecimPlan:
    """The tile rule of the forms with a contiguous window: among the tiles
    whose window and all T taps fit ``SMEM_LIMIT``, the one whose busiest
    SM stages the fewest samples (``busiest_sm_samples``; the fill leads a
    launch, and every block of the grid fills at once), and among equals
    the smaller.  Where not even the smallest tile fits with all the taps,
    the taps go in chunks."""

    def plan(tile, chunk=T):
        return FirDecimPlan(form, tile, chunk)

    fits = [t for t in tiles if fir_decim_smem(T, D, plan(t)) <= SMEM_LIMIT]
    if not fits:
        tile = tiles[-1]
        fixed = fir_decim_smem(T, D, plan(tile, 0))
        return plan(tile, tap_chunk(T, fixed, 12))
    return plan(min(fits, key=lambda t: (busiest_sm_samples(D, M, plan(t)), t)))


def fir_decim_plan(T: int, D: int, M: int) -> FirDecimPlan:
    """The plan of a K4 launch of M outputs.

    The phase-major form where a block fits shared memory, every warp has a
    phase (D >= 8) and the grid covers at least ``PHASE_MIN_BLOCKS`` SMs:
    among its built R, the one whose longest SM filters the fewest outputs,
    ceil(blocks / 132) * 32R (a launch lasts as long as its longest block),
    and among equals the smaller block.  Else lanes across outputs for
    D < 8 and lanes across taps from D = 8 on, each with the tile rule of
    ``_fill_the_card``."""
    phases = [
        p for p in (FirDecimPlan("phase", t, T) for t in PHASE_TILES)
        if fir_decim_smem(T, D, p) <= SMEM_LIMIT and fir_decim_blocks(M, p) >= PHASE_MIN_BLOCKS
    ]
    if D >= KERNEL_WARPS and phases:
        return min(phases, key=lambda p: (cdiv(fir_decim_blocks(M, p), SM_COUNT) * p.tile, p.tile))
    if D < KERNEL_WARPS:
        return _fill_the_card(T, D, M, "outputs", OUTPUT_TILES)
    return _fill_the_card(T, D, M, "taps", TAP_TILES)


# -- kernel and plain version ----------------------------------------------


def fir_decim_plain(x: torch.Tensor, taps: torch.Tensor, D: int, M: int,
                    history: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: ``_fir_poly`` on the I and Q of [history, x]."""
    from tpusdr_torch.ops import fir

    s = x if history is None else torch.cat([history, x])
    y = fir._fir_poly(torch.stack([s.real, s.imag]), taps, D, M)
    return torch.complex(y[0], y[1])


def launch_args(lib, history, x, taps, D: int, M: int, plan: FirDecimPlan, y: torch.Tensor) -> tuple:
    """The C entry point's arguments after the checks:
    ``tpusdr_fir_poly(*head, y, dev, stream)``."""
    T = taps.shape[-1]
    for name, t in (("x", x), ("history", history)):
        if t is not None and (t.dtype != torch.complex64 or t.dim() != 1 or not t.is_contiguous()):
            raise ValueError(f"fir_decim: {name} must be a contiguous 1-D complex64 tensor")
    if taps.dtype != torch.float32 or taps.dim() != 1 or not taps.is_contiguous():
        raise ValueError("fir_decim: taps must be contiguous 1-D float32")
    form = FORMS.index(plan.form)
    smem = lib.tpusdr_fir_poly_smem(T, D, form, plan.tile, plan.chunk)
    dev, stream = launch_target(x, smem, f"fir_decim (T={T}, D={D})")
    head = (
        history.data_ptr() if history is not None else None,
        history.shape[-1] if history is not None else 0,
        x.data_ptr(),
        x.shape[-1],
        taps.data_ptr(),
        T,
        D,
        M,
        form,
        plan.tile,
        plan.chunk,
    )
    return head, (y.data_ptr(), dev, stream)


def _launch(history, x, taps, D: int, M: int) -> torch.Tensor:
    from tpusdr_torch.kernels.build import library

    lib = library()
    x = x.contiguous()
    history = history.contiguous() if history is not None else None
    taps = taps.contiguous()
    y = torch.empty(M, dtype=torch.complex64, device=x.device)
    head, tail = launch_args(lib, history, x, taps, D, M, fir_decim_plan(taps.shape[-1], D, M), y)
    check_launch(lib.tpusdr_fir_poly(*head, *tail), "fir_decim")
    return y


def fir_decim(x: torch.Tensor, taps, decimation: int, history: torch.Tensor | None = None) -> torch.Tensor:
    """Decimating FIR of s = [history, x], a 1-D complex64 stream, with
    real taps (D >= 2): M = (H + N - (T-1)) // D outputs."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.from_numpy(np.asarray(taps, np.float32)).to(x.device)
    D = int(decimation)
    T = taps.shape[-1]
    if D < 2 or x.dim() != 1 or taps.is_complex() or (history is not None and history.dim() != 1):
        raise ValueError("fir_decim takes a 1-D complex stream, real taps and D >= 2")
    H = history.shape[-1] if history is not None else 0
    M = (H + x.shape[-1] - (T - 1)) // D
    if M <= 0:
        return torch.zeros(0, dtype=torch.complex64, device=x.device)
    if on_cuda(x, history, taps):
        y = _launch(history, x, taps, D, M)
        fir_decim.launches += 1
        return y
    return fir_decim_plain(x, taps, D, M, history)


fir_decim.launches = 0
