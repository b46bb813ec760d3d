"""Rational polyphase resampler over a batch of rows: kernel
``csrc/resample_poly.cu`` and its plain version.

One streaming step of ``ops.resample``'s contract (upfirdn's): a tick x of
N samples a row, behind the carried P-1 samples, gives M = N*U/D outputs a
row,

    y[m] = sum_{i<P} h[p_m + i*U] * x[n_m - i],  p_m = (m*D) mod U,
                                                 n_m = (m*D) div U,

and the new carry, the last P-1 samples of [state, x], in the format of
the state.  The kernel reads the carry and the tick through two pointers,
so nothing is concatenated in front of the launch, and writes the next
carry itself.  It takes the taps as ``tap_table`` gives them on the card,
the banded table of ``group_taps`` (on the CPU the plain version takes
``plan.frame_taps``).  Complex data goes through as its real
and imaginary planes, read and written in place at an element stride of
2: two launches.  A CUDA tensor launches the kernel; a CPU tensor takes the
plain version, ``ops.resample._resample_real`` behind the ``cat``.
``launches`` counts launches and ``rows`` the rows they resample.

``resample_plan`` is the card's shape rule: from (U, D, P, rows, M) it
picks the t a block (``tile``), the threads an item (``split``) and the
groups of classes a block (``groups``), so that one block's shared memory
stays within an H100's 232,448 bytes for every Resampler the receivers
build and the grid gives each of the card's 132 SMs a block where rows x t
allow.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpusdr_torch.kernels.dispatch import check_launch, launch_target, on_cuda
from tpusdr_torch.kernels.fir_banded import SM_COUNT, SMEM_LIMIT
from tpusdr_torch.utils.numerics import cdiv

GROUP = 4  # classes an item of the kernel: one 16-byte tap load
THREADS = 256  # threads a block the rule aims at
MAX_THREADS = 1024
SPLITS = (1, 2, 4, 8, 16, 32)  # threads an item: what the kernel is built for


class ResamplePlan(NamedTuple):
    """How one launch is cut: ``tile`` t a block, ``split`` threads an item
    (one t of a group of four classes) and ``groups`` groups a block."""

    tile: int
    split: int
    groups: int


def class_starts(U: int, D: int) -> np.ndarray:
    """n_c = (c*D) div U: where class c's first output starts in s."""
    return (np.arange(U, dtype=np.int64) * D) // U


@functools.lru_cache(maxsize=None)
def group_len(U: int, D: int, P: int) -> int:
    """L, the steps of an item: P plus the widest spread of the n_c of a
    group of four classes."""
    n = class_starts(U, D)
    return P + max(int(n[min(g + GROUP, U) - 1] - n[g]) for g in range(0, U, GROUP))


def group_taps(plan) -> np.ndarray:
    """The kernel's tap table G, (ceil(U/4), L, 4) float32: G[g][k][r] is
    class c = 4g + r's reversed tap k + n_{4g} - n_c inside its band and
    zero outside it or past U, so that y[c, t] = sum_k s[t*D + n_{4g} + k]
    * G[g][k][r]."""
    U, D, P = plan.up, plan.down, plan.taps_per_phase
    n = class_starts(U, D)
    hr = plan.frame_taps.reshape(U, -1)[:, :P]
    G = np.zeros((cdiv(U, GROUP), group_len(U, D, P), GROUP), np.float32)
    for c in range(U):
        g, r = divmod(c, GROUP)
        off = int(n[c] - n[g * GROUP])
        G[g, off : off + P, r] = hr[c]
    return G


def tap_table(plan, device=None) -> torch.Tensor:
    """The taps a step of ``plan`` reads, on ``device``: on the card the
    kernel's table ``group_taps``, elsewhere the plain version's
    ``plan.frame_taps`` (``ops.resample.plan_taps`` for up > 1)."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.from_numpy(group_taps(plan)).to(device)
    return torch.from_numpy(plan.frame_taps).to(device)


def window_len(U: int, D: int, L: int, tile: int, groups: int) -> int:
    """Samples a block's window may need (csrc/resample_poly.cu, window_of):
    ``tile`` t of a run of ``groups`` groups, whose first classes' n spread
    by at most 4 (groups-1) D / U + 1."""
    return (tile - 1) * D + GROUP * (groups - 1) * D // U + 1 + L


def resample_smem(U: int, D: int, L: int, tile: int, groups: int) -> int:
    """Shared memory of one block (csrc/resample_poly.cu, smem_bytes): its
    groups' part of G, the window, then their outputs."""
    return groups * L * 16 + (window_len(U, D, L, tile, groups) + GROUP * groups * tile) * 4


def resample_threads(plan: ResamplePlan) -> int:
    """Threads of a block: one item a ``split`` threads, rounded up to a
    warp."""
    return cdiv(plan.groups * plan.tile * plan.split, 32) * 32


def resample_blocks(U: int, rows: int, M: int, plan: ResamplePlan) -> int:
    """Blocks of a launch of M outputs in each of ``rows`` rows."""
    return rows * cdiv(M // U, plan.tile) * cdiv(cdiv(U, GROUP), plan.groups)


@functools.lru_cache(maxsize=None)
def resample_plan(U: int, D: int, P: int, rows: int, M: int) -> ResamplePlan:
    """The plan of a launch of M outputs in each of ``rows`` rows.

    ``split``: one thread an item where the launch has at least a block of
    256 threads for each of the card's 132 SMs, else the fewest threads an
    item (up to a warp) that make it so.  ``groups``: all of them, unless a
    block of one t would not fit ``SMEM_LIMIT`` or 1,024 threads.
    ``tile``: the most t whose items fill a block of 256 threads, fewer
    where the grid would leave an SM without a block (as far as rows x t
    allow) or a block would not fit; then evened out over the row's
    tiles."""
    t, Ng, L = M // U, cdiv(U, GROUP), group_len(U, D, P)
    split = 1
    while split < SPLITS[-1] and rows * t * Ng * split < SM_COUNT * THREADS:
        split *= 2
    groups = min(Ng, MAX_THREADS // split)
    while groups > 1 and resample_smem(U, D, L, 1, groups) > SMEM_LIMIT:
        groups -= 1
    if resample_smem(U, D, L, 1, groups) > SMEM_LIMIT:
        raise ValueError(f"resample_poly: no block of (U={U}, D={D}, P={P}) fits {SMEM_LIMIT} B of shared memory")
    want = min(SM_COUNT, rows * t * cdiv(Ng, groups))
    tile = max(1, min(t, THREADS // (groups * split)))
    while tile > 1 and (resample_blocks(U, rows, M, ResamplePlan(tile, split, groups)) < want
                        or resample_smem(U, D, L, tile, groups) > SMEM_LIMIT):
        tile -= 1
    return ResamplePlan(cdiv(t, cdiv(t, tile)), split, groups)


# -- kernel and plain version ----------------------------------------------


def resample_poly_plain(state: torch.Tensor, x: torch.Tensor, plan, taps: torch.Tensor):
    """The plain version: ``_resample_real`` on [state, x] (each plane of a
    complex tick), and the last P-1 samples of [state, x] as the carry."""
    from tpusdr_torch.ops.resample import _resample_real

    hist = plan.history
    ext = torch.cat([state, x], dim=-1)
    if ext.is_complex():
        y = torch.complex(
            _resample_real(ext.real.contiguous(), plan, taps),
            _resample_real(ext.imag.contiguous(), plan, taps),
        )
    else:
        y = _resample_real(ext, plan, taps)
    new_state = ext[..., ext.shape[-1] - hist :].clone() if hist > 0 else ext[..., :0]
    return new_state, y


def _planes(t: torch.Tensor) -> list[tuple[int | None, int]]:
    """(address, row stride in floats) of each real plane of t: one for
    float32, the real and imaginary planes for complex64."""
    n = t.shape[-1]
    if t.numel() == 0:
        return [(None, 0)] * (2 if t.is_complex() else 1)
    if t.is_complex():
        return [(t.data_ptr(), 2 * n), (t.data_ptr() + 4, 2 * n)]
    return [(t.data_ptr(), n)]


def _launch(state: torch.Tensor, x: torch.Tensor, plan, taps: torch.Tensor):
    from tpusdr_torch.kernels.build import library

    U, D, P = plan.up, plan.down, plan.taps_per_phase
    H, N, M = P - 1, x.shape[-1], plan.block_out
    batch = tuple(x.shape[:-1])
    if x.dtype not in (torch.float32, torch.complex64) or state.dtype != x.dtype:
        raise ValueError(f"resample_poly: float32 or complex64 data and state, got {x.dtype}, {state.dtype}")
    if tuple(state.shape) != batch + (H,):
        raise ValueError(f"resample_poly: state {tuple(state.shape)} for a tick {tuple(x.shape)}; expected {batch + (H,)}")
    L = group_len(U, D, P)
    if taps.dtype != torch.float32 or tuple(taps.shape) != (cdiv(U, GROUP), L, GROUP):
        raise ValueError(f"resample_poly: taps must be the plan's tap table ({cdiv(U, GROUP)}, {L}, {GROUP}), "
                         "tap_table(plan) on the card")
    x, state, taps = x.contiguous(), state.contiguous(), taps.contiguous()
    y = torch.empty(batch + (M,), dtype=x.dtype, device=x.device)
    rows = math.prod(batch)
    if rows == 0 or M == 0:  # an empty tick (N = M = 0) carries the state
        return state.clone(), y, 0
    lib = library()
    pplan = resample_plan(U, D, P, rows, M)
    dev, stream = launch_target(x, lib.tpusdr_resample_poly_smem(U, D, L, pplan.tile, pplan.groups),
                                f"resample_poly (U={U}, D={D}, P={P})")
    carry = torch.empty(batch + (H,), dtype=x.dtype, device=x.device)
    es = 2 if x.is_complex() else 1
    planes = list(zip(_planes(state), _planes(x), _planes(y), _planes(carry)))
    for (h, h_row), (xp, x_row), (yp, y_row), (cp, c_row) in planes:
        err = lib.tpusdr_resample_poly(h, h_row, xp, x_row, H, N, es, taps.data_ptr(), L, U, D, M, rows,
                                       pplan.tile, pplan.split, pplan.groups, yp, y_row, cp, c_row, dev, stream)
        check_launch(err, "resample_poly")
    return carry, y, len(planes)


def resample_poly(state: torch.Tensor, x: torch.Tensor, plan, taps: torch.Tensor):
    """One streaming step of the polyphase resampler (up > 1) over every row
    of x (..., N), float32 or complex64: (new state, y).  ``plan`` is the
    ``ops.resample.ResamplerPlan`` of the tick length, ``taps`` its
    ``tap_table`` on x's device."""
    if on_cuda(state, x, taps):
        carry, y, launched = _launch(state, x, plan, taps)
        resample_poly.launches += launched
        resample_poly.rows += launched * math.prod(x.shape[:-1])
        return carry, y
    return resample_poly_plain(state, x, plan, taps)


resample_poly.launches = 0
resample_poly.rows = 0
