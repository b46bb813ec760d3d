"""Staging probes: kernels K6-K8 (``csrc/staging_probes.cu``) and their
plain versions.

Replace the probes W4, X1 and X2 of benchmarks/pallas_mosaic_probes.py,
which established what a TPU kernel may ask of its asynchronous copies.
Each stages a window of rows of a (rows, W) float32 array in on-chip
memory and writes from it:

  * ``staged_add_one`` (W4, :44-63): block g copies rows [g*B, g*B + B)
    from an offset computed at run time, and writes ``s + 1``;
  * ``staged_window_double`` (X1, :64-84): block g copies the window of
    B + P-1 rows at g*B, which overlaps the next block's and is not a
    multiple of 8 rows, and writes rows 0:B of it times 2;
  * ``staged_shift_sum`` (X2, :85-102): ``out[r] = sum_{p<P} x[r + p]``,
    reading the staged block at every row offset.

K6 and K7 stage what the TPU stages, the windows one after another (K7:
each probe block's output and its halo of P-1 rows, once), cut into one
span a block of a persistent grid, each span walked in pieces through a
ring of shared-memory stages by bulk copies (``staging_plan``).  K8 cuts
the output rows into runs of nearly equal length on a persistent grid,
stages each run's window (its rows and the P-1 after them) by bulk copies
into a ring, and sums it by 16-byte reads at every row offset
(``shift_sum_plan``).  A CUDA tensor launches the kernel; a CPU tensor
takes the plain version.  All three are exact: the kernels add in the
plain versions' order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpusdr_torch.kernels.copy_floor import sm_count
from tpusdr_torch.kernels.dispatch import check_launch, launch_target, on_cuda
from tpusdr_torch.kernels.fir_banded import SM_COUNT, SMEM_LIMIT
from tpusdr_torch.utils.numerics import cdiv

UNIT = 128  # bytes: spans and pieces start on 128-byte lines of the staged windows
PIECE_BYTES = 8192  # the largest piece: a span is cut into the fewest equal pieces up to this
BAR_BYTES = 8  # one mbarrier a stage
GROUPS = (1, 2, 4, 8)  # groups of a block's 8 warps that take the pieces in turn
MAX_BYTES = 1 << 32  # the kernels' byte offsets are 32-bit
MAX_TILE = 1024  # floats of a K8 column tile: a float4 column a thread, 256 threads
MAX_THREADS = 256  # threads of a K8 block


class StagingPlan(NamedTuple):
    """How one K6 or K7 launch is cut: ``blocks`` blocks, spans in units of
    ``unit`` bytes, pieces of ``piece`` bytes through a ring of ``stages``
    (a multiple of ``groups``), and ``groups`` groups of a block's warps
    that take the pieces in turn."""

    blocks: int
    unit: int
    piece: int
    stages: int
    groups: int


def staging_smem(plan: StagingPlan) -> int:
    """Dynamic shared memory of one block (csrc/staging_probes.cu,
    ``tpusdr_staging_smem``): the ring and a barrier a stage."""
    return plan.stages * (plan.piece + BAR_BYTES)


def staged_bytes(rows_out: int, W: int, B: int, halo_rows: int) -> int:
    """Bytes a launch stages: the windows of B + halo_rows rows one after
    another (the last one ending with x), the output and one halo a probe
    block of ``B`` rows."""
    return (int(rows_out) + cdiv(int(rows_out), int(B)) * int(halo_rows)) * 4 * int(W)


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def staging_plan(rows_out: int, W: int, B: int, halo_rows: int, sms: int = SM_COUNT, *,
                 piece: int = PIECE_BYTES, groups: int | None = None) -> StagingPlan:
    """The plan of a K6 (``halo_rows`` 0) or K7 (``halo_rows`` P-1) launch
    that writes ``rows_out`` rows of ``W`` floats, with probe blocks of
    ``B`` rows.

    The staged windows (``staged_bytes``) are cut into one span a block, in
    128-byte units, the tail that is no whole unit going with the last
    span: ``blocks`` is ``sms``, or one block a unit where there are fewer
    (one at least), so that no span is empty and every SM stages the same
    bytes.  The longest span is cut into the fewest equal pieces of at most
    ``piece`` bytes, rounded up to whole units.  The warps are cut into
    ``groups`` groups, by default the largest of 1, 2, 4, 8 that is at most
    the pieces of a span, and the ring holds those pieces rounded up to a
    multiple of ``groups``, up to what fits a block's shared memory."""
    if groups is not None and groups not in GROUPS:
        raise ValueError(f"staging: groups={groups} is not one of {GROUPS}")
    n_s = staged_bytes(max(1, int(rows_out)), W, B, halo_rows)
    n_units = n_s // UNIT
    blocks = max(1, min(int(sms), n_units))
    longest = cdiv(n_units, blocks) * UNIT + n_s % UNIT
    largest = max(UNIT, min(int(piece), SMEM_LIMIT - BAR_BYTES) // UNIT * UNIT)
    piece = cdiv(cdiv(longest, cdiv(longest, largest)), UNIT) * UNIT
    room = SMEM_LIMIT // (piece + BAR_BYTES)
    n_pieces = cdiv(longest, piece)
    groups = min(groups or _pow2_floor(min(n_pieces, GROUPS[-1])), _pow2_floor(room))
    stages = min(cdiv(n_pieces, groups), room // groups) * groups
    return StagingPlan(blocks, UNIT, piece, stages, groups)


def staged_add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def staged_window_double_plain(x: torch.Tensor, taps: int = 11) -> torch.Tensor:
    return 2.0 * x[: x.shape[0] - (taps - 1)]


def staged_shift_sum_plain(x: torch.Tensor, taps: int = 11) -> torch.Tensor:
    B = x.shape[0] - (taps - 1)
    return sum(x[p : p + B] for p in range(taps))


def _check(x: torch.Tensor, name: str, halo: int) -> int:
    """Validate the input; returns the number of output rows."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name} takes a 2-D float32 tensor (rows, W)")
    if x.shape[1] % 4:
        raise ValueError(f"{name}: W={x.shape[1]} is not a multiple of 4 floats (16-byte copies)")
    if halo < 0 or x.shape[0] < halo:
        raise ValueError(f"{name}: {x.shape[0]} rows cannot hold a halo of {halo}")
    return x.shape[0] - halo


@functools.lru_cache(maxsize=None)
def _rule(rows_out: int, W: int, B: int, halo_rows: int, device_index: int) -> StagingPlan:
    """The rule's plan for a shape on a card, worked out once."""
    return staging_plan(rows_out, W, B, halo_rows, sm_count(device_index))


def windows(op: int, rows_out: int, B: int, P: int) -> tuple[int, int]:
    """(probe block rows, halo rows) of the staged windows: K6 stages its
    output as one window, K7 one window of B + P-1 rows a probe block."""
    return (min(B, rows_out), P - 1) if op else (rows_out, 0)


def launch(op: int, x: torch.Tensor, B: int, P: int, plan: StagingPlan) -> torch.Tensor:
    """One K6 (op 0) or K7 (op 1) launch by ``plan`` on a checked CUDA
    tensor (no count: the wrappers count; the probe's plan sweep calls
    this directly)."""
    from tpusdr_torch.kernels.build import library

    name = "staged_window_double" if op else "staged_add_one"
    W = x.shape[1]
    rows_out = x.shape[0] - (P - 1 if op else 0)
    dev, stream = launch_target(x, staging_smem(plan), f"{name} (W={W}, {plan})")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be aligned to 16 bytes")
    out = torch.empty((rows_out, W), dtype=torch.float32, device=x.device)
    Bw, halo_rows = windows(op, rows_out, B, P)
    err = library().tpusdr_staging(
        op, x.data_ptr(), rows_out * W * 4, Bw * W * 4, halo_rows * W * 4, cdiv(rows_out, Bw),
        plan.unit, plan.blocks, plan.piece, plan.stages, plan.groups, out.data_ptr(), dev, stream,
    )
    check_launch(err, name)
    return out


def _check_staged(x: torch.Tensor, name: str, halo: int, block_rows: int) -> int:
    """``_check``, and what K6 and K7 add: probe blocks of a row or more,
    and x and the windows it stages under 4 GB.  Returns the number of
    output rows."""
    rows = _check(x, name, halo)
    if block_rows < 1:
        raise ValueError(f"{name}: block_rows must be positive")
    staged = staged_bytes(rows, x.shape[1], min(block_rows, max(1, rows)), halo)
    if max(x.numel() * 4, staged) >= MAX_BYTES:
        raise ValueError(f"{name}: x of {x.numel() * 4} B staging {staged} B; "
                         f"the kernel's offsets take under {MAX_BYTES}")
    return rows


def _staged(op: int, x: torch.Tensor, rows: int, B: int, P: int) -> torch.Tensor:
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    return launch(op, x, B, P, _rule(rows, x.shape[1], *windows(op, rows, B, P), index))


def staged_add_one(x: torch.Tensor, block_rows: int = 1024) -> torch.Tensor:
    """``x + 1`` through a staged copy of each block of ``block_rows`` rows."""
    rows = _check_staged(x, "staged_add_one", 0, block_rows)
    if rows and on_cuda(x):
        out = _staged(0, x, rows, int(block_rows), 1)
        staged_add_one.launches += 1
        return out
    return staged_add_one_plain(x)


staged_add_one.launches = 0


def staged_window_double(x: torch.Tensor, block_rows: int = 1024, taps: int = 11) -> torch.Tensor:
    """``2 * x[:R]`` for x of R + taps-1 rows, each block of ``block_rows``
    rows staging its overlapping window of ``block_rows + taps - 1`` rows."""
    rows = _check_staged(x, "staged_window_double", taps - 1, block_rows)
    if rows and on_cuda(x):
        out = _staged(1, x, rows, int(block_rows), int(taps))
        staged_window_double.launches += 1
        return out
    return staged_window_double_plain(x, taps)


staged_window_double.launches = 0


class ShiftSumPlan(NamedTuple):
    """How one K8 launch is cut: ``blocks`` blocks of a persistent grid,
    the output rows in ``runs`` runs (of R or R+1 rows), the columns in
    tiles of ``tile`` floats, a ring of ``stages`` windows a block and
    ``groups`` groups of threads that each sum a slice of a run's rows."""

    blocks: int
    runs: int
    tile: int
    stages: int
    groups: int


def shift_sum_window_bytes(rows_out: int, P: int, plan: ShiftSumPlan) -> int:
    """Bytes of one stage: the longest run's window (its rows and the P-1
    after them, of one tile) rounded up to 128."""
    return cdiv((cdiv(rows_out, plan.runs) + P - 1) * plan.tile * 4, UNIT) * UNIT


def shift_sum_smem(rows_out: int, P: int, plan: ShiftSumPlan) -> int:
    """Dynamic shared memory of one K8 block (csrc/staging_probes.cu,
    ``tpusdr_shift_sum_smem``): the ring and a barrier a stage."""
    return plan.stages * (shift_sum_window_bytes(rows_out, P, plan) + BAR_BYTES)


def shift_sum_staged(rows_out: int, W: int, P: int, plan: ShiftSumPlan) -> tuple[int, int]:
    """(bytes all blocks stage, bytes the busiest block stages): unit u
    (run u // tiles, tile u % tiles) stages its run's rows and the P-1 after
    them, of its tile's columns, and block b takes units b, b + blocks, ..."""
    n_ct = cdiv(W, plan.tile)
    u = np.arange(plan.runs * n_ct, dtype=np.int64)
    r, t = u // n_ct, u % n_ct
    rows = rows_out // plan.runs + (r < rows_out % plan.runs) + P - 1
    cols = np.minimum(plan.tile, W - t * plan.tile)
    per_block = np.bincount(u % plan.blocks, weights=rows * cols * 4, minlength=plan.blocks)
    return int(per_block.sum()), int(per_block.max())


def shift_sum_plan(rows_out: int, W: int, P: int, sms: int = SM_COUNT, *, run_rows: int | None = None,
                   groups: int | None = None) -> ShiftSumPlan:
    """The plan of a K8 launch that writes ``rows_out`` rows of ``W``
    floats from ``rows_out + P-1``.

    Column tiles: the fewest of at most 1024 floats (a float4 column a
    thread) whose one-row windows fit two stages, cut nearly equal in
    whole float4s.  Runs: as long as fits, so that the busiest SM stages
    the fewest bytes (each run stages P-1 rows more than it writes): one
    unit (a run of a tile) a block on ``sms`` blocks where its window fits
    the shared memory, else the fewest units a block whose windows fit a
    ring of two, the runs then shortened to fill every block's last turn,
    and the ring as deep as a block's units, up to what fits.  ``run_rows``
    forces the run length instead.  Threads: a float4 column each and
    ``groups`` groups over a run's rows, by default one row a thread, up
    to 256 threads (more threads won at every shape timed on an H100).
    Raises where P rows of 4 floats do not fit two stages."""
    rows_out, W, P, sms = max(1, int(rows_out)), int(W), int(P), int(sms)
    if groups is not None and groups < 1:
        raise ValueError(f"staged_shift_sum: groups={groups} must be positive")
    whole = (SMEM_LIMIT - BAR_BYTES) // UNIT * UNIT  # a stage alone
    half = (SMEM_LIMIT // 2 - BAR_BYTES) // UNIT * UNIT  # a stage of a ring of two
    widest = min(MAX_TILE, half // (4 * P) // 4 * 4)
    if widest < 4:
        raise ValueError(f"staged_shift_sum: P={P} rows do not fit two stages of shared memory")
    n_ct = cdiv(W, widest)
    tile = 4 * cdiv(W // 4, n_ct)

    def fitting(stage_bytes: int) -> int:  # the longest run whose window fits stage_bytes
        return stage_bytes // (4 * tile) - (P - 1)

    if run_rows is not None:
        runs = cdiv(rows_out, max(1, min(int(run_rows), fitting(whole))))
    else:
        runs = max(1, min(rows_out, sms // n_ct))
        if n_ct > sms or cdiv(rows_out, runs) > fitting(whole):
            per_block = cdiv(cdiv(rows_out, fitting(half)) * n_ct, sms)
            runs = max(1, min(rows_out, sms * per_block // n_ct))
    units = runs * n_ct
    blocks = min(sms, units)
    plan = ShiftSumPlan(blocks, runs, tile, 1, 1)
    room = SMEM_LIMIT // (shift_sum_window_bytes(rows_out, P, plan) + BAR_BYTES)
    stages = min(cdiv(units, blocks), room)
    longest, per_row = cdiv(rows_out, runs), max(1, MAX_THREADS // (tile // 4))
    groups = min(groups or longest, per_row)
    return plan._replace(stages=stages, groups=groups)


@functools.lru_cache(maxsize=None)
def _shift_sum_rule(rows_out: int, W: int, P: int, device_index: int) -> ShiftSumPlan:
    """The rule's plan for a K8 shape on a card, worked out once."""
    return shift_sum_plan(rows_out, W, P, sm_count(device_index))


def launch_shift_sum(x: torch.Tensor, P: int, plan: ShiftSumPlan) -> torch.Tensor:
    """One K8 launch by ``plan`` on a checked CUDA tensor (no count: the
    wrapper counts; the probe's plan sweep calls this directly)."""
    from tpusdr_torch.kernels.build import library

    W = x.shape[1]
    rows_out = x.shape[0] - (P - 1)
    dev, stream = launch_target(x, shift_sum_smem(rows_out, P, plan), f"staged_shift_sum (W={W}, P={P}, {plan})")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("staged_shift_sum: x must be aligned to 16 bytes")
    out = torch.empty((rows_out, W), dtype=torch.float32, device=x.device)
    err = library().tpusdr_shift_sum(
        x.data_ptr(), rows_out, W, P, plan.blocks, plan.runs, plan.tile, plan.stages, plan.groups,
        out.data_ptr(), dev, stream,
    )
    check_launch(err, "staged_shift_sum")
    return out


def staged_shift_sum(x: torch.Tensor, taps: int = 11) -> torch.Tensor:
    """``sum_{p<taps} x[p : p + B]`` for x of B + taps-1 rows, added in
    that order."""
    if taps < 1:
        raise ValueError("staged_shift_sum: taps must be positive")
    rows = _check(x, "staged_shift_sum", taps - 1)
    if x.numel() * 4 >= MAX_BYTES:
        raise ValueError(f"staged_shift_sum: x of {x.numel() * 4} B; the kernel's offsets take under {MAX_BYTES}")
    if rows and on_cuda(x):
        index = x.device.index if x.device.index is not None else torch.cuda.current_device()
        out = launch_shift_sum(x, int(taps), _shift_sum_rule(rows, x.shape[1], int(taps), index))
        staged_shift_sum.launches += 1
        return out
    return staged_shift_sum_plain(x, taps)


staged_shift_sum.launches = 0
