"""Copy floor: kernel K5 (``csrc/copy_floor.cu``) and its plain version.

Replaces the kernel of ``dma_once`` (benchmarks/kernel_floor_probe.py:
280-360): a tick viewed as (n_rows, G) is pulled whole through on-chip
memory by asynchronous copies and only columns 0:128 of each row are
written back.  It does no arithmetic: its time is the least any kernel
that stages the same tick can take, the memory floor the FIR kernels are
read against.

The port's input is one interleaved ``complex64`` (n_rows, G) tensor, not
two float32 planes, and the output is (n_rows, 128) ``complex64``.
``n_split`` keeps its name and meaning: the number of concurrent copies
each staged piece is cut into.

``copy_floor_plan`` cuts a launch: the flat tick in one span of equal
bytes a block of a persistent grid, one block an SM, each span walked in
equal pieces of up to 96 KB through a ring of shared-memory stages.  A CUDA tensor launches the kernel; a CPU
tensor takes the plain version, ``x[:, :128].clone()``.  The plain version
reads 2% of the bytes, so its time says nothing about the kernel's: only
the values are compared.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpusdr_torch.kernels.dispatch import check_launch, launch_target, on_cuda
from tpusdr_torch.kernels.fir_banded import SM_COUNT, SM_SMEM, SMEM_LIMIT
from tpusdr_torch.utils.numerics import cdiv

OUT_COLS = 128  # columns of each row that are written back
PER_SM = 1  # blocks an SM
PIECE_BYTES = 96 << 10  # the largest piece: a span is cut into the fewest equal pieces up to this
ALIGN = 128  # bytes: each of a piece's n_split copies starts on a 128-byte line
BAR_BYTES = 8  # one mbarrier a stage
MAX_TICK_BYTES = 1 << 32  # the kernel's byte offsets are 32-bit


class CopyFloorPlan(NamedTuple):
    """How one K5 launch is cut: ``per_sm`` blocks an SM, pieces of
    ``piece`` bytes, a ring of ``stages`` pieces a block, ``blocks`` blocks,
    and the ``unit`` of bytes spans are cut in."""

    per_sm: int
    piece: int
    stages: int
    blocks: int
    unit: int


def copy_floor_smem(plan: CopyFloorPlan) -> int:
    """Dynamic shared memory of one block (csrc/copy_floor.cu,
    ``tpusdr_copy_floor_smem``): the ring and a barrier a stage."""
    return plan.stages * (plan.piece + BAR_BYTES)


def copy_floor_plan(n_rows: int, G: int, n_split: int = 1, sms: int = SM_COUNT, *,
                    per_sm: int = PER_SM, piece: int = PIECE_BYTES) -> CopyFloorPlan:
    """The plan of a K5 launch over an (n_rows, G) tick.

    Spans are cut in units of 128 * n_split bytes, so that each of a
    piece's n_split copies starts on a 128-byte line, or of 16 * n_split
    where such a unit is longer than ``piece`` (the tick's bytes are whole
    units of 16 * n_split: G % (2 * n_split) == 0).  ``blocks`` is
    ``per_sm`` blocks on each of ``sms`` SMs, so that every SM moves the
    same bytes, or one block a unit where the tick holds fewer units (one
    at least), so that no span is empty; each block's span is a whole
    number of units, within one unit of every other, and the last also
    takes the tail of the tick that is no whole unit.  The longest span is
    cut into the fewest equal pieces of at most ``piece`` bytes (and of
    the block's share of the SM's shared memory), rounded up to whole
    units; the ring holds as many pieces as a span has, at most as many as
    fit that share.  Raises for a shape the copy's 16-byte rule or the
    shared memory cannot take."""
    n_rows, G, n_split = int(n_rows), int(G), int(n_split)
    if G < OUT_COLS:
        raise ValueError(f"copy_floor: rows of {G} samples are shorter than the {OUT_COLS} columns kept")
    if n_split < 1 or G % (2 * n_split):
        raise ValueError(
            f"copy_floor: n_split={n_split} does not cut a row of {G} complex64 samples "
            "into pieces of whole 16-byte units"
        )
    unit = ALIGN * n_split if ALIGN * n_split <= piece else 16 * n_split
    if unit + BAR_BYTES > SMEM_LIMIT:
        raise ValueError(
            f"copy_floor: a piece of n_split={n_split} copies of 16 bytes or more ({unit} B) "
            f"does not fit the {SMEM_LIMIT} B of shared memory a block may have"
        )
    room = min(SMEM_LIMIT, SM_SMEM // per_sm - 1024)  # each resident block reserves 1 KB
    if room < unit + BAR_BYTES:
        per_sm, room = 1, SMEM_LIMIT
    n_bytes = max(1, n_rows) * G * 8
    n_units = n_bytes // unit
    blocks = max(1, min(sms * per_sm, n_units))
    longest = cdiv(n_units, blocks) * unit + n_bytes % unit
    largest = max(unit, min(piece, room - BAR_BYTES) // unit * unit)
    n_pieces = cdiv(longest, largest)
    piece = cdiv(cdiv(longest, n_pieces), unit) * unit
    stages = min(room // (piece + BAR_BYTES), n_pieces)
    return CopyFloorPlan(per_sm, piece, stages, blocks, unit)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a card, read once."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def copy_floor_plain(x: torch.Tensor) -> torch.Tensor:
    return x[:, :OUT_COLS].clone()


def moved_bytes(n_rows: int, G: int) -> int:
    """Bytes the function must move: the tick read once, the kept columns
    written once."""
    return n_rows * G * 8 + n_rows * OUT_COLS * 8


def launch(x: torch.Tensor, n_split: int, plan: CopyFloorPlan) -> torch.Tensor:
    """One launch of the kernel by ``plan`` on a CUDA tensor (no count: the
    wrapper counts; a plan probe calls this directly)."""
    from tpusdr_torch.kernels.build import library

    n_rows, G = x.shape
    dev, stream = launch_target(x, copy_floor_smem(plan), f"copy_floor (G={G}, {plan})")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("copy_floor: x must be aligned to 16 bytes")
    out = torch.empty((n_rows, OUT_COLS), dtype=torch.complex64, device=x.device)
    err = library().tpusdr_copy_floor(
        x.data_ptr(), n_rows, G, n_split, plan.unit, plan.blocks, plan.piece, plan.stages,
        out.data_ptr(), dev, stream,
    )
    check_launch(err, "copy_floor")
    return out


def copy_floor(x: torch.Tensor, n_split: int = 1) -> torch.Tensor:
    """Columns 0:128 of each row of ``x`` (n_rows, G) complex64, after
    staging every byte of ``x`` through shared memory."""
    if x.dim() != 2 or x.dtype != torch.complex64:
        raise ValueError("copy_floor takes a 2-D complex64 tensor (n_rows, G)")
    if x.numel() * 8 >= MAX_TICK_BYTES:
        raise ValueError(f"copy_floor: a tick of {x.numel() * 8} B; the kernel's offsets take under {MAX_TICK_BYTES}")
    n_rows, G = x.shape
    if not on_cuda(x):
        copy_floor_plan(n_rows, G, n_split)  # the shape rule holds on the CPU too
        return copy_floor_plain(x)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan = copy_floor_plan(n_rows, G, n_split, sm_count(index))
    if n_rows == 0:
        return torch.zeros((0, OUT_COLS), dtype=torch.complex64, device=x.device)
    out = launch(x, n_split, plan)
    copy_floor.launches += 1
    return out


copy_floor.launches = 0
