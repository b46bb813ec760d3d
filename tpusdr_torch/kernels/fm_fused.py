"""Fused NCO mix -> decimating FIR -> FM discriminator: kernel FM-fused
(``csrc/fm_fused.cu``) and its plain version.

Replaces ``fused_fm_demod_pallas`` (tpusdr/kernels/fm_pallas.py), with the
same contract: s of length (T-1) + (M+1)*D gives M float32 outputs.  Here
s = [history, x_ext] is a virtual concatenation read through two pointers,
so a streaming caller hands over its carried samples and the tick as they
lie, and nothing is copied in front of the launch.  A CUDA tensor launches
the kernel; a CPU tensor takes the plain version, the torch mix ->
``fir_extended`` -> ``quad_fm_demod_ext`` pipeline.

A launch may also demodulate C channels of the same samples: the NCO
increments and carried phases are then C-element int64 tensors on the
device, read by the kernel when it runs, the output is (C, M), and the
channels are a second grid axis of the one launch.  ``launches`` counts
launches and ``channel_rows`` the channel rows they write.

``fm_fused_plan`` is the card's shape rule: from (T, D, M, C) it picks the
kernel's inner loop (phase-major with register reuse for a long tick at a
moderate D, lanes across taps else), the filtered samples a block (a block
of n owns n - 1 outputs and recomputes one overlap sample) and the tap
chunk, so that one block's shared
memory stays within an H100's 232,448 bytes for every shape the receivers
build and the grid (C x blocks) covers the card's 132 SMs where M and C
allow it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpusdr_torch.kernels.dispatch import check_launch, launch_target, on_cuda
from tpusdr_torch.kernels.fir_banded import (
    FORMS,
    KERNEL_WARPS,
    MIN_BLOCKS,
    PHASE_MIN_BLOCKS,
    SM_COUNT,
    SMEM_LIMIT,
    TILES,
    DecimFirPlan,
    blocks_per_sm,
    decim_fir_smem,
    tap_chunk,
)
from tpusdr_torch.utils.numerics import cdiv


PHASE_R = 5  # filtered samples one thread owns in the phase-major form
PHASE_TILE = 32 * PHASE_R  # its filtered samples per block: lanes across them
PROBE_PHASE_TILES = (224, 160)  # what the kernel is built for: R = 7 (for the timing probe) and 5
MAX_CHANNELS = 65535  # the grid's second axis


class FmFusedPlan(NamedTuple):
    """How one FM-fused launch is cut: the kernel's inner loop
    (``fir_banded.FORMS``), ``tile`` filtered samples a block (tile - 1
    outputs), ``chunk`` taps a pass (T unless shared memory forces less)."""

    form: str
    tile: int
    chunk: int


def fm_fused_smem(T: int, D: int, plan: FmFusedPlan) -> int:
    """Shared memory of one FM-fused block (csrc/fm_fused.cu
    taps_smem_bytes and phase_smem_bytes).  Form "taps": the mixed window
    of ``tile`` filtered samples over ``chunk`` taps, the filtered samples,
    the chunk's taps.  Form "phase": D-FIR's phase-major layout with real
    taps; the filtered samples land where the window was."""
    if plan.form == "phase":
        return decim_fir_smem(T, D, False, DecimFirPlan(*plan))
    return ((plan.tile - 1) * D + plan.chunk + plan.tile) * 8 + plan.chunk * 4


def fm_fused_blocks(M: int, plan: FmFusedPlan) -> int:
    """Blocks of a launch of M outputs: a block owns tile - 1 of them."""
    return cdiv(M, plan.tile - 1)


def fm_fused_plan(T: int, D: int, M: int, C: int = 1) -> FmFusedPlan:
    """The plan of an FM-fused launch of M outputs in each of C channels;
    the grid is C times ``fm_fused_blocks``, and every count of blocks
    below is the grid's.

    The phase-major form where its 160-sample blocks fit shared memory,
    every warp has a phase (D >= 8) and the grid covers at least
    ``PHASE_MIN_BLOCKS`` SMs.  A launch takes as long as its longest block,
    so 5 filtered samples a lane beat D-FIR's 7 here: the NBFM tick is 126
    blocks on 132 SMs instead of 90 larger ones.

    Else lanes across taps.  Among the tiles whose window and all T taps
    fit ``SMEM_LIMIT``: of those small enough for two blocks to share an
    SM, the largest that still gives ``MIN_BLOCKS`` blocks, else the
    smallest.  Where no tile lets two blocks share an SM, the one with the
    fewest rounds of one block an SM and, among equals, the smallest: below
    one round (9660, /666) at M = 625 is 90 blocks of 8 where 16 gives 42,
    and a round of the smaller block is the shorter one; above it the
    larger tile has half the rounds.  Where not even 8 filtered samples fit
    with all the taps, the taps go in chunks."""
    def grid(plan):
        return C * fm_fused_blocks(M, plan)

    phase = FmFusedPlan("phase", PHASE_TILE, T)
    if (D >= KERNEL_WARPS and fm_fused_smem(T, D, phase) <= SMEM_LIMIT
            and grid(phase) >= PHASE_MIN_BLOCKS):
        return phase

    def plan(tile, chunk=T):
        return FmFusedPlan("taps", tile, chunk)

    fits = [t for t in TILES if fm_fused_smem(T, D, plan(t)) <= SMEM_LIMIT]
    if not fits:
        tile = TILES[-1]
        return plan(tile, tap_chunk(T, ((tile - 1) * D + tile) * 8, 12))
    shared = [t for t in fits if blocks_per_sm(fm_fused_smem(T, D, plan(t))) >= 2]
    if shared:
        return plan(next((t for t in shared if grid(plan(t)) >= MIN_BLOCKS), shared[-1]))
    return plan(min(reversed(fits), key=lambda t: cdiv(grid(plan(t)), SM_COUNT)))


def _phase_tensor(phase0_u32, phase_offset: int, device) -> torch.Tensor:
    """The phase of s[0] as the carried-phase tensor, from either form
    (C phases stay C phases)."""
    from tpusdr_torch.ops import osc

    if isinstance(phase0_u32, torch.Tensor):
        return osc.advance_phase(phase0_u32.to(device), 1, phase_offset)
    return osc.as_phase(int(phase0_u32) + int(phase_offset), device)


def channels(inc_u32, phase0_u32) -> int | None:
    """C for the channel form (C-element int64 increments and phases),
    None for the single-channel form (a host int increment)."""
    if not isinstance(inc_u32, torch.Tensor):
        return None
    ok = (inc_u32.dtype == torch.int64 and inc_u32.dim() == 1 and isinstance(phase0_u32, torch.Tensor)
          and phase0_u32.dtype == torch.int64 and phase0_u32.shape == inc_u32.shape)
    if not ok:
        raise ValueError("fm_fused: the channel form takes C int64 increments and C int64 phases")
    return inc_u32.shape[0]


def fused_fm_demod_plain(x_ext, taps, D: int, inc_u32, phase0_u32, gain: float, M: int,
                         history=None, phase_offset: int = 0):
    """The plain version; ``inc_u32`` and ``phase0_u32`` in either form of
    ``fused_fm_demod`` ((C, M) outputs in the channel form)."""
    from tpusdr_torch.ops import demod, fir, osc

    if history is not None:
        x_ext = torch.cat([history, x_ext])
    L = (taps.shape[-1] - 1) + (M + 1) * D
    x_ext = x_ext[:L]
    if channels(inc_u32, phase0_u32) is not None:
        inc_u32 = inc_u32.to(x_ext.device)
    lo = osc.complex_cosine_block(_phase_tensor(phase0_u32, phase_offset, x_ext.device), inc_u32, L)
    v = fir.fir_extended(x_ext * lo, taps, D, "mxu")
    return demod.quad_fm_demod_ext(v, gain)


def launch_args(lib, history, x, taps, D: int, inc_u32: int, phase0_u32, gain: float, M: int,
                plan: FmFusedPlan, out: torch.Tensor, phase_offset: int = 0) -> tuple:
    """The arguments both C entry points share, up to the plan, after the
    checks: ``tpusdr_fm_fused(*head, out, dev, stream)``.  A tensor
    ``phase0_u32`` (0-d int64 on x's device) goes by pointer, read by the
    kernel when it runs, with ``phase_offset`` added by value; a host int
    goes by value with a null pointer.  In the channel form the C
    increments and C phases (int64 on x's device) go by pointer and ``out``
    is (C, M)."""
    T = taps.shape[-1]
    for name, t in (("x", x), ("history", history)):
        if t is not None and (t.dtype != torch.complex64 or t.dim() != 1 or not t.is_contiguous()):
            raise ValueError(f"fm_fused: {name} must be a contiguous 1-D complex64 tensor")
    if taps.dtype != torch.float32 or taps.dim() != 1 or not taps.is_contiguous():
        raise ValueError("fm_fused: taps must be contiguous 1-D float32")
    C = channels(inc_u32, phase0_u32)
    if C is not None:
        for t in (inc_u32, phase0_u32):
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"fm_fused: the increments and phases must be contiguous on {x.device}")
        if not 1 <= C <= MAX_CHANNELS:
            raise ValueError(f"fm_fused: {C} channels; a launch takes 1 to {MAX_CHANNELS}")
        incs_ptr, inc = inc_u32.data_ptr(), 0
        phase_ptr, phase0 = phase0_u32.data_ptr(), int(phase_offset)
    elif isinstance(phase0_u32, torch.Tensor):
        if phase0_u32.dtype != torch.int64 or phase0_u32.dim() != 0 or phase0_u32.device != x.device:
            raise ValueError(f"fm_fused: a phase tensor must be 0-d int64 on {x.device}")
        incs_ptr, inc = None, int(inc_u32)
        phase_ptr, phase0 = phase0_u32.data_ptr(), int(phase_offset)
    else:
        incs_ptr, inc = None, int(inc_u32)
        phase_ptr, phase0 = None, int(phase0_u32) + int(phase_offset)
    form = FORMS.index(plan.form)
    smem = lib.tpusdr_fm_fused_smem(T, D, form, plan.tile, plan.chunk)
    dev, stream = launch_target(x, smem, f"fm_fused (T={T}, D={D})")
    head = (
        history.data_ptr() if history is not None else None,
        history.shape[-1] if history is not None else 0,
        x.data_ptr(),
        x.shape[-1],
        taps.data_ptr(),
        T,
        D,
        inc & 0xFFFFFFFF,
        incs_ptr,
        phase_ptr,
        phase0 & 0xFFFFFFFF,
        float(np.float32(gain)),
        M,
        C or 1,
        form,
        plan.tile,
        plan.chunk,
    )
    return head, (out.data_ptr(), dev, stream)


def _launch(history, x, taps, D, inc_u32, phase0_u32, gain, M, phase_offset):
    from tpusdr_torch.kernels.build import library

    lib = library()
    x = x.contiguous()
    history = history.contiguous() if history is not None else None
    taps = taps.contiguous()
    C = channels(inc_u32, phase0_u32)
    out = torch.empty(M if C is None else (C, M), dtype=torch.float32, device=x.device)
    plan = fm_fused_plan(taps.shape[-1], D, M, C or 1)
    head, tail = launch_args(lib, history, x, taps, D, inc_u32, phase0_u32, gain, M, plan, out, phase_offset)
    check_launch(lib.tpusdr_fm_fused(*head, *tail), "fm_fused")
    return out


def fused_fm_demod(x_ext: torch.Tensor, taps, decimation: int, inc_u32: int, phase0_u32, gain: float,
                   history: torch.Tensor | None = None, phase_offset: int = 0) -> torch.Tensor:
    """Fused mix + filter + decimate + discriminate of s = [history, x_ext]:
    M = (H + N - (T-1)) // D - 1 outputs.

    The NCO phase (uint32 cycles) of s[0] is ``phase0_u32 + phase_offset``
    mod 2^32.  ``phase0_u32`` is a host int or the carried phase, a 0-d
    int64 tensor on x's device (``ops/osc.py``), which the kernel reads
    through a pointer when it runs, so a captured launch replays with the
    phase of its tick; ``phase_offset`` is a host int.  Pass
    ``osc.freq_to_inc_u32(-f_offset, fs)`` as ``inc_u32`` to downconvert a
    channel at +f_offset.  Real taps.

    The channel form: ``inc_u32`` and ``phase0_u32`` are C-element int64
    tensors on x's device, channel c's increment and carried phase (both
    read through pointers when the kernel runs), ``phase_offset`` is added
    to every channel, and the result is (C, M), in one launch."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.from_numpy(np.asarray(taps, np.float32)).to(x_ext.device)
    D = int(decimation)
    T = taps.shape[-1]
    H = history.shape[-1] if history is not None else 0
    M = (H + x_ext.shape[-1] - (T - 1)) // D - 1
    C = channels(inc_u32, phase0_u32)
    if M <= 0:
        return torch.zeros((0,) if C is None else (C, 0), dtype=torch.float32, device=x_ext.device)
    if on_cuda(x_ext, history, taps):
        y = _launch(history, x_ext, taps, D, inc_u32, phase0_u32, gain, M, phase_offset)
        fused_fm_demod.launches += 1
        fused_fm_demod.channel_rows += C or 1
        return y
    return fused_fm_demod_plain(x_ext, taps, D, inc_u32, phase0_u32, gain, M, history=history,
                                phase_offset=phase_offset)


fused_fm_demod.launches = 0
fused_fm_demod.channel_rows = 0
