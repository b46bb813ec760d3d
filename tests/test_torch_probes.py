"""The port's probe kernels K5-K8 (plain versions), their entry points and
the profiling helpers, on the CPU.

The TPU probes' ``pl.pallas_call`` sites sit inside ``main()`` and
``dma_floor`` of benchmarks/ with no ``interpret`` argument, so they cannot
run here; each plain version is held instead to a numpy expression of the
kernel body, block by block, with the lines it was read from.  The floor
probe's K1/K2 arms run at a small shape against ``banded_fir_pallas`` and
``banded_fir_prelude`` in interpret mode (tolerance: 1e-5 of the output's
peak, float32 on both sides with another summation order).  K5-K8 move or
add in the same order as their plain versions, so they compare exactly.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpusdr.kernels import fir_banded_pallas as jfb
from tpusdr.ops import cplx as jcplx
from tpusdr.utils import profiling as jprof
from tpusdr_torch import kernels
from tpusdr_torch.benchmarks import kernel_floor_probe as floor
from tpusdr_torch.benchmarks import plan_probe
from tpusdr_torch.benchmarks import staging_probes as probes
from tpusdr_torch.kernels import copy_floor as cf
from tpusdr_torch.kernels import staging_probes as sp
from tpusdr_torch.models import receiver as TR
from tpusdr_torch.utils import profiling as tprof

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(77)


def crandn(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def close_to_peak(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


# -- plain versions against the TPU kernel bodies -----------------------------------


@pytest.mark.parametrize("n_rows,G", [(200, 6400), (320, 6400), (40, 256), (7, 128)])
def test_copy_floor_plain_is_the_dma_kernel_body(rng, n_rows, G):
    """benchmarks/kernel_floor_probe.py:319-323: grid step k waits for its
    block of R rows of each plane and writes ``or_ref[:] = sr[0:R, 0:128]``,
    ``oi_ref[:] = si[0:R, 0:128]`` into output block k (:344-347)."""
    z = crandn(rng, n_rows, G)
    R = 160 if n_rows % 160 == 0 else (40 if n_rows % 40 == 0 else n_rows)  # :275
    out_re = np.empty((n_rows, 128), np.float32)
    out_im = np.empty((n_rows, 128), np.float32)
    for k in range(n_rows // R):
        sr, si = z.real[k * R : (k + 1) * R], z.imag[k * R : (k + 1) * R]  # the staged block
        out_re[k * R : (k + 1) * R] = sr[0:R, 0:128]
        out_im[k * R : (k + 1) * R] = si[0:R, 0:128]
    got = cf.copy_floor(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, out_re + 1j * out_im)
    assert cf.moved_bytes(n_rows, G) == z.nbytes + got.nbytes


@pytest.mark.parametrize("B,grid,W", [(1024, 4, 128), (100, 3, 36)])
def test_staged_add_one_plain_is_probe_w4(rng, B, grid, W):
    """benchmarks/pallas_mosaic_probes.py:47-52: block g copies
    ``x_ref[g*B : g*B + B]`` into ``s`` and writes ``o_ref = s + 1.0``."""
    x = rng.standard_normal((grid * B, W)).astype(np.float32)
    want = np.empty_like(x)
    for g in range(grid):
        s = x[g * B : g * B + B]
        want[g * B : (g + 1) * B] = s + np.float32(1.0)
    np.testing.assert_array_equal(sp.staged_add_one(torch.from_numpy(x), B).numpy(), want)


@pytest.mark.parametrize("B,P,grid,W", [(1024, 11, 4, 128), (100, 11, 3, 36), (64, 1, 2, 8)])
def test_staged_window_double_plain_is_probe_x1(rng, B, P, grid, W):
    """pallas_mosaic_probes.py:65-73: block g copies the ROWS = B + P - 1
    rows at g*B into ``s`` and writes ``o_ref = s[0:B] * 2.0``."""
    rows = B + P - 1
    x = rng.standard_normal((grid * B + P - 1, W)).astype(np.float32)
    want = np.empty((grid * B, W), np.float32)
    for g in range(grid):
        s = x[g * B : g * B + rows]
        want[g * B : (g + 1) * B] = s[0:B] * np.float32(2.0)
    np.testing.assert_array_equal(sp.staged_window_double(torch.from_numpy(x), B, P).numpy(), want)


@pytest.mark.parametrize("B,P,W", [(1024, 11, 128), (777, 11, 36), (50, 3, 4), (100, 11, 128), (1, 11, 4),
                                   (1024, 1, 128), (1024, 33, 128), (1024, 11, 4096), (200_003, 11, 4)])
def test_staged_shift_sum_plain_is_probe_x2(rng, B, P, W):
    """pallas_mosaic_probes.py:89-93: ``a = x_ref[0:B]``, then for p in
    1..P-1 ``a = a + x_ref[p : p + B]`` (the same order of additions)."""
    x = rng.standard_normal((B + P - 1, W)).astype(np.float32)
    a = x[0:B]
    for p in range(1, P):
        a = a + x[p : p + B]
    np.testing.assert_array_equal(sp.staged_shift_sum(torch.from_numpy(x), P).numpy(), a)


def test_probe_wrappers_take_the_plain_version_on_the_cpu_without_launching(rng):
    kernels.reset_launch_counts()
    cf.copy_floor(torch.from_numpy(crandn(rng, 4, 256)), 2)
    x = torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32))
    sp.staged_add_one(x, 8), sp.staged_window_double(x, 8, 3), sp.staged_shift_sum(x, 3)
    assert {w.__name__: w.launches for w in kernels.WRAPPERS} == {
        "banded_fir": 0, "banded_fir_prelude": 0, "fused_fm_demod": 0, "fir_decim": 0,
        "resample_poly": 0, "copy_floor": 0, "staged_add_one": 0, "staged_window_double": 0, "staged_shift_sum": 0,
    }


@pytest.mark.parametrize(
    "shape,dtype,n_split,match",
    [
        ((4, 6400), np.complex64, 3, "n_split=3"),  # 6400 % (2*3) != 0: not whole 16-byte units
        ((4, 6400), np.complex64, 0, "n_split=0"),
        ((4, 6400), np.complex64, 6400, "n_split=6400"),  # pieces of 8 bytes
        ((4, 64), np.complex64, 1, "shorter than the 128"),
        ((4, 40000), np.complex64, 20000, "does not fit"),  # 20,000 copies of 16 B: a 320,000-byte piece
        ((4, 6400), np.float32, 1, "2-D complex64"),
        ((6400,), np.complex64, 1, "2-D complex64"),
    ],
)
def test_copy_floor_refuses_what_the_copy_cannot_take(shape, dtype, n_split, match):
    with pytest.raises(ValueError, match=match):
        cf.copy_floor(torch.zeros(shape, dtype=torch.from_numpy(np.zeros(1, dtype)).dtype), n_split)


def test_copy_floor_refuses_a_tick_of_4_gb():
    """The kernel's byte offsets are 32-bit: a tick of 2^32 bytes is refused
    (a broadcast view, so nothing is allocated)."""
    x = torch.zeros(1, 1, dtype=torch.complex64).expand(1 << 16, 1 << 13)
    with pytest.raises(ValueError, match="offsets"):
        cf.copy_floor(x)
    assert cf.copy_floor(x[: (1 << 16) - 1]).shape == ((1 << 16) - 1, 128)


def test_copy_floor_plan_fits_shared_memory():
    """One block an SM, spans in units of 128 * n_split bytes, the longest
    cut into the fewest equal pieces of at most 96 KB, as many stages as
    it has pieces up to what fits."""
    assert cf.copy_floor_plan(200, 6400) == (1, 77696, 1, 132, 128)  # spans of 77,568-77,696 B: one piece
    assert cf.copy_floor_plan(320, 6400, 10) == (1, 62720, 2, 132, 1280)  # 124,160 B and the tail: two
    assert cf.copy_floor_plan(2000, 6400) == (1, 97024, 2, 132, 128)  # spans of 775,757 B: eight, a ring of two
    assert cf.copy_floor_plan(2000, 6400, sms=114) == (1, 89856, 2, 114, 128)
    assert cf.copy_floor_plan(200, 6400, per_sm=2, piece=16384) == (2, 13056, 3, 264, 128)
    assert cf.copy_floor_plan(1, 128) == (1, 128, 1, 8, 128)  # 8 units of 128 B: one block each
    assert cf.copy_floor_plan(1, 128, 64) == (1, 8192, 1, 1, 8192)  # a unit longer than the tick: one block
    assert cf.copy_floor_plan(4, 20000) == (1, 4864, 1, 132, 128)  # a 160,000-byte row is taken
    assert cf.copy_floor_plan(4, 20000, 10000) == (1, 160000, 1, 4, 160000)  # units of 16 * n_split
    for n_rows, G, n_split in [(200, 6400, 1), (2000, 6400, 10), (4, 20000, 10000), (50, 512, 4)]:
        for per_sm, piece in [(2, 16384), (1, 32768), (2, 8192), (3, 4096)]:
            plan = cf.copy_floor_plan(n_rows, G, n_split, per_sm=per_sm, piece=piece)
            assert plan.per_sm * cf.copy_floor_smem(plan) <= cf.SMEM_LIMIT and plan.stages >= 1
    got = cf.copy_floor(torch.from_numpy(crandn(np.random.default_rng(5), 4, 20000)))
    assert got.shape == (4, 128)


def k5_model(n_rows, G, n_split, plan):
    """The span, ring and row-head arithmetic of csrc/copy_floor.cu, block
    by block: returns each block's (begin, end, [(a, len, parts), ...])
    and every 16-byte output write as (output vector, input byte offset).
    The ring is walked as the kernel walks it: thread 0 issues pieces 0 ..
    stages-1, piece i waits on barrier i % stages for parity
    (i // stages) & 1, and the stage is refilled with piece i + stages
    after that wait."""
    unit, row, n_bytes = plan.unit, G * 8, n_rows * G * 8
    per_block, extra = divmod(n_bytes // unit, plan.blocks)
    blocks, writes = [], []
    for b in range(plan.blocks):
        begin = (b * per_block + min(b, extra)) * unit
        span = (per_block + (b < extra)) * unit + (n_bytes % unit if b + 1 == plan.blocks else 0)
        n_pieces = -(-span // plan.piece)
        holds = [None] * plan.stages  # the piece each stage was last filled with
        done = [0] * plan.stages  # phases each barrier has completed
        for i in range(min(plan.stages, n_pieces)):
            holds[i] = i
        pieces = []
        for i in range(n_pieces):
            s = i % plan.stages
            assert holds[s] == i and (i // plan.stages) & 1 == done[s] & 1  # the wait returns on piece i's phase
            done[s] += 1
            a = begin + i * plan.piece
            ln = min(plan.piece, begin + span - a)
            pieces.append((a, ln, [ln // n_split] * n_split))
            r0 = a // row
            if a - r0 * row < 1024 or (r0 + 1) * row < a + ln:
                v = np.arange(((a + ln - 1) // row - r0 + 1) * 64)
                r, q = r0 + v // 64, v % 64
                g = r * row + q * 16
                keep = (g >= a) & (g < a + ln)
                writes.append(np.stack([r[keep] * 64 + q[keep], g[keep]], 1))
            if i + plan.stages < n_pieces:
                holds[s] = i + plan.stages
        assert sum(done) == n_pieces  # every piece issued was waited on before the block exits
        blocks.append((begin, begin + span, pieces))
    return blocks, np.concatenate(writes)


K5_SHAPES = [(200, 6400), (320, 6400), (12_800_000 // 6400, 6400), (1, 128), (133, 128), (50, 512),
             (30, 12800), (4, 20000)]


@pytest.mark.parametrize("n_rows,G", K5_SHAPES)
@pytest.mark.parametrize("n_split", [1, 2, 5, 10])
@pytest.mark.parametrize("per_sm,piece", [(cf.PER_SM, cf.PIECE_BYTES), (2, 16384)])
def test_copy_floor_spans_pieces_and_heads(n_rows, G, n_split, per_sm, piece):
    """A numpy model of the kernel's arithmetic (``k5_model``) over the
    rule's plan: every input byte in exactly one piece of one block, every
    piece 16-byte aligned and cut into n_split 16-byte multiples (each
    starting on a 128-byte line but the tail's), no empty span, the
    busiest block within one piece of the mean, and every output
    byte written once from the right input byte, row heads cut by a piece
    or a span boundary included.  A shape the 16-byte rule refuses is
    refused."""
    if G % (2 * n_split):
        with pytest.raises(ValueError, match=f"n_split={n_split}"):
            cf.copy_floor_plan(n_rows, G, n_split)
        return
    plan = cf.copy_floor_plan(n_rows, G, n_split, per_sm=per_sm, piece=piece)
    n_bytes, row = n_rows * G * 8, G * 8
    blocks, writes = k5_model(n_rows, G, n_split, plan)
    assert plan.per_sm * cf.copy_floor_smem(plan) <= cf.SMEM_LIMIT
    pieces = [p for _, _, ps in blocks for p in ps]
    assert [a for a, _, _ in pieces] == list(np.cumsum([0] + [ln for _, ln, _ in pieces[:-1]]))
    assert sum(ln for _, ln, _ in pieces) == n_bytes
    for a, ln, parts in pieces:
        assert a % 16 == 0 and 0 < ln <= plan.piece and sum(parts) == ln
        assert len(parts) == n_split and all(p > 0 and p % 16 == 0 for p in parts)
        assert a % 128 == 0 and (parts[0] % 128 == 0 or a + ln == n_bytes)
    spans = [end - begin for begin, end, _ in blocks]
    assert min(spans) > 0 and all(sp % (16 * n_split) == 0 for sp in spans)
    assert max(spans) <= n_bytes / plan.blocks + plan.piece
    out_vec, src = writes[:, 0], writes[:, 1]
    np.testing.assert_array_equal(np.bincount(out_vec, minlength=n_rows * 64), 1)
    np.testing.assert_array_equal(src, out_vec // 64 * row + out_vec % 64 * 16)
    cuts = [begin for begin, _, _ in blocks[1:]], [a for _, _, ps in blocks for a, _, _ in ps[1:]]
    heads_cut = [sum(0 < a % row < 1024 for a in c) for c in cuts]
    if G <= 512:
        assert heads_cut[0] > 0  # span boundaries inside row heads
    if G == 6400 and n_split < 10 and per_sm == 2:
        assert heads_cut[1] > 0  # piece boundaries inside row heads
    if n_bytes <= 16 << 20:
        x = np.random.default_rng(n_rows + G).integers(0, 256, n_bytes, dtype=np.uint8)
        out = np.empty((n_rows * 64, 16), np.uint8)
        out[out_vec] = x.reshape(-1, 16)[src // 16]
        np.testing.assert_array_equal(out.reshape(n_rows, 1024), x.reshape(n_rows, row)[:, :1024])


def k67_model(rows_out, W, B, halo_rows, plan):
    """The span, window, ring and store arithmetic of ``staged_kernel`` in
    csrc/staging_probes.cu, block by block, over the staged windows S
    (window g: the B output rows of probe block g, then its halo of
    ``halo_rows`` rows; the last ends with x): returns each block's (begin,
    span, [[(window, S offset, x offset, bytes, bytes written), ...] a
    piece]).  The ring is walked as the kernel walks it: thread 0 of group
    g issues its pieces g, g + groups, ... up to the ring's depth, piece i
    waits on barrier i % stages for parity (i // stages) & 1, and the
    stage is refilled with piece i + stages after that wait; each stage is
    waited on by one group only, so the group alone meets before it
    refills the stage."""
    assert plan.stages % plan.groups == 0 and plan.groups in sp.GROUPS
    row, unit = 4 * W, plan.unit
    n_out, halo, blk = rows_out * row, halo_rows * row, B * row
    n_win = -(-rows_out // B)
    win, last = blk + halo, n_win - 1
    n_s = n_out + n_win * halo
    n_units = n_s // unit
    per_block, extra = divmod(n_units, plan.blocks)
    blocks = []
    for b in range(plan.blocks):
        begin = (b * per_block + min(b, extra)) * unit
        span = (per_block + (b < extra)) * unit + (n_s - n_units * unit if b + 1 == plan.blocks else 0)
        n_pieces = -(-span // plan.piece)
        holds = [None] * plan.stages  # the piece each stage was last filled with
        done = [0] * plan.stages  # phases each barrier has completed
        for i in range(min(plan.stages, n_pieces)):
            holds[i] = i
        pieces = []
        for i in range(n_pieces):
            s = i % plan.stages
            assert s % plan.groups == i % plan.groups  # the stage is the group's own
            assert holds[s] == i and (i // plan.stages) & 1 == done[s] & 1  # the wait returns on piece i's phase
            done[s] += 1
            a = begin + i * plan.piece
            ln = min(plan.piece, span - i * plan.piece)
            w = min(a // win, last)
            r, at, parts = a - w * win, 0, []
            while at < ln:
                n = min(ln - at, (n_out - w * blk + halo if w == last else win) - r)
                out_bytes = n_out - w * blk if w == last else blk
                parts.append((w, a + at, w * blk + r, n, max(0, min(out_bytes - r, n))))
                at, w, r = at + n, w + 1, 0
            pieces.append(parts)
            if i + plan.stages < n_pieces:
                holds[s] = i + plan.stages
        assert sum(done) == n_pieces  # every piece issued was waited on before the block exits
        blocks.append((begin, span, pieces))
    return blocks


# (rows_out, W, B, P): the probes' shape (W4: B = 1024; X1: P = 11) and
# the card test's odd ones, each staged as K6 (one window, no halo) and as
# K7 (a window of B + P-1 rows a probe block)
K67_SHAPES = [(4096, 128, 1024, 11), (777, 36, 100, 11), (33, 4, 32, 3), (5, 8, 1, 1), (4096, 128, 1000, 11),
              (2000, 64, 33, 40), (100, 128, 16, 5), (20, 4, 3, 2), (4099, 128, 1024, 11), (1, 4, 1, 4)]


@pytest.mark.parametrize("rows_out,W,B,P", K67_SHAPES)
@pytest.mark.parametrize("op", [0, 1])
@pytest.mark.parametrize("sms", [132, 60, 7])
def test_staging_spans_ring_and_windows(rows_out, W, B, P, op, sms):
    """A numpy model of K6's and K7's arithmetic (``k67_model``) over the
    rule's plan and over plans whose ring must be refilled: every output
    byte written once, from the same byte of x; every copy 16-byte sized,
    inside x and starting on a 128-byte line of S or at a window's start;
    no span empty and none a unit and the tail longer than another; a
    block's shared memory within 232,448 B; K7 staging each probe block's
    whole window of B + P-1 rows (up to the end of x) once, and so the
    output and one halo a probe block, no more."""
    Bw, halo_rows = sp.windows(op, rows_out, B, P)
    row = 4 * W
    n_out, n_x = rows_out * row, (rows_out + halo_rows) * row
    n_s = sp.staged_bytes(rows_out, W, Bw, halo_rows)
    n_win = -(-rows_out // Bw)
    assert n_s == n_out + n_win * halo_rows * row
    rule = sp.staging_plan(rows_out, W, Bw, halo_rows, sms)
    assert sp.staging_smem(rule) <= sp.SMEM_LIMIT and rule.unit == 128
    assert rule.blocks == min(sms, max(1, n_s // 128))
    x = np.random.default_rng(rows_out + W).integers(0, 256, n_x, dtype=np.uint8)
    refilled = (rule._replace(stages=rule.groups), rule._replace(piece=256, stages=4, groups=2),
                rule._replace(piece=128, stages=3, groups=1), rule._replace(piece=256, stages=8, groups=8))
    for plan in (rule, *refilled):
        blocks = k67_model(rows_out, W, Bw, halo_rows, plan)
        spans = [span for _, span, _ in blocks]
        assert min(spans) > 0 and max(spans) - min(spans) <= 128 + n_s % 128
        out = np.zeros(n_out, np.uint8)
        written = np.zeros(n_out, np.int64)
        per_window = np.zeros(n_win, np.int64)
        s_next = 0
        for begin, span, pieces in blocks:
            assert begin == s_next and begin % 128 == 0
            s_next += span
            for parts in pieces:
                assert sum(n for *_, n, _ in parts) <= plan.piece
                at = 0
                for w, s_off, x_off, n, wr in parts:
                    assert n > 0 and n % 16 == 0 and x_off % 16 == 0 and x_off + n <= n_x
                    assert s_off % 128 == 0 or x_off == w * Bw * row  # a piece's start or a window's
                    stage = x[x_off : x_off + n]  # what the bulk copy lands at stage offset `at`
                    out[x_off : x_off + wr] = stage[:wr]
                    written[x_off : x_off + wr] += 1
                    per_window[w] += n
                    at += n
        assert s_next == n_s
        np.testing.assert_array_equal(written, 1)
        np.testing.assert_array_equal(out, x[:n_out])
        # window g is rows [g*B, g*B + B + P-1) up to the end of x, staged once
        want = [min(Bw * (g + 1) + halo_rows, rows_out + halo_rows) * row - g * Bw * row for g in range(n_win)]
        np.testing.assert_array_equal(per_window, want)
    if (rows_out, W, B, P, op, sms) == (4096, 128, 1024, 11, 1, 132):
        assert n_s == 2_117_632  # 2,752,512 B before: a halo a 32-row sub-tile


def test_staging_plan_rule():
    """One block an SM (one a 128-byte unit where fewer), the longest span
    in the fewest equal pieces of at most 8 KB, a group of warps for each
    (up to 8, a power of two), a ring as deep as a span has pieces,
    rounded up to whole groups."""
    assert sp.staging_plan(4096, 128, 4096, 0) == (132, 128, 8064, 2, 2)  # spans of 15,872-16,000 B
    assert sp.staging_plan(4096, 128, 1024, 10) == (132, 128, 8064, 2, 2)  # 16,000-16,128 B with the halos
    assert sp.staging_plan(4096, 128, 1024, 10, piece=4096) == (132, 128, 4096, 4, 4)
    assert sp.staging_plan(4096, 128, 1024, 10, piece=2048, groups=2) == (132, 128, 2048, 8, 2)
    assert sp.staging_plan(5, 8, 5, 0) == (1, 128, 256, 1, 1)  # 160 B: one unit and a tail of 32
    assert sp.staging_plan(1, 4, 1, 0) == (1, 128, 128, 1, 1)  # 16 B: the tail alone
    assert sp.staging_plan(1 << 20, 128, 1 << 20, 0) == (132, 128, 8192, 24, 8)  # 4 MB spans: a ring of 24
    assert sp.staged_bytes(4096, 128, 1024, 10) == 2_117_632
    with pytest.raises(ValueError, match="groups"):
        sp.staging_plan(4096, 128, 4096, 0, groups=3)


def div_magic(d):
    """csrc/staging_probes.cu ``div_magic``: n // d as a multiply and shifts."""
    s = max(0, (d - 1).bit_length())
    return ((1 << 32) * ((1 << s) - d) // d + 1) & 0xFFFFFFFF, s


def k8_model(x, P, plan):
    """The unit, window, ring and thread arithmetic of ``shift_sum_kernel``
    in csrc/staging_probes.cu, block by block, on x (numpy float32): unit u
    is run u // tiles (by the host's multiply-shift where there are two
    tiles or more) of column tile u % tiles; warp 0 stages a block's units
    b, b + blocks, ... up to the ring's depth (a window of full rows by one
    copy, else a copy a row, row i by lane i mod min(threads, 32) of warp
    0), unit j of the block waits on stage j % stages, which is refilled
    with unit j + stages once every thread is past it; thread (c, g) sums
    float4 column c over its group's slice of the run's rows, the rows
    added in order.  Every copy, window and output is checked as the kernel
    would need it (each row of a window copied once, else its barrier never
    completes); returns the output and the count of writes of each
    element."""
    rows_x, W = x.shape
    rows_out = rows_x - (P - 1)
    R, extra = divmod(rows_out, plan.runs)
    n_ct = -(-W // plan.tile)
    n_units = plan.runs * n_ct
    magic, shift = div_magic(n_ct) if n_ct > 1 else (0, 0)
    stage_bytes = sp.shift_sum_window_bytes(rows_out, P, plan)
    assert stage_bytes % 128 == 0 and plan.stages * (stage_bytes + 8) == sp.shift_sum_smem(rows_out, P, plan)
    threads = plan.tile // 4 * plan.groups
    assert plan.tile % 4 == 0 and threads <= 256
    lanes = min(threads, 32)  # the threads of warp 0, which issue the row copies
    stride = lanes  # the kernel's lane_count
    n_long, n_short = -(-(R + 1) // plan.groups), -(-R // plan.groups)
    out = np.zeros((rows_out, W), np.float32)
    written = np.zeros((rows_out, W), np.int64)

    def unit(u):
        r, t = u, 0
        if n_ct > 1:
            hi = (u * magic) >> 32
            r = (hi + ((u - hi) >> 1)) >> (shift - 1)
            t = u - r * n_ct
        assert (r, t) == divmod(u, n_ct)
        col0 = t * plan.tile
        return r * R + min(r, extra), R + (r < extra), col0, min(plan.tile, W - col0)

    def issue(u):
        row0, rows, col0, cols = unit(u)
        assert row0 + rows + P - 1 <= rows_x and (rows + P - 1) * cols * 4 <= stage_bytes
        assert cols % 4 == 0 and (row0 * W + col0) % 4 == 0  # 16-byte copies from 16-byte addresses
        window = np.full((rows + P - 1, cols), np.nan, np.float32)
        if n_ct == 1:
            assert cols == W  # full rows: one contiguous copy
            window[:] = x[row0 : row0 + rows + P - 1]
            return u, window
        copies = np.zeros(rows + P - 1, np.int64)
        for lane in range(lanes):
            for i in range(lane, rows + P - 1, stride):
                window[i] = x[row0 + i, col0 : col0 + cols]
                copies[i] += 1
        np.testing.assert_array_equal(copies, 1)  # the barrier was armed for every row's bytes
        return u, window

    for b in range(plan.blocks):
        ring = [issue(b + s * plan.blocks) if b + s * plan.blocks < n_units else None for s in range(plan.stages)]
        s = 0
        for u in range(b, n_units, plan.blocks):
            held, window = ring[s]
            assert held == u
            row0, rows, col0, cols = unit(u)
            n = n_long if rows > R else n_short
            covered = np.zeros(rows, np.int64)
            assert cols // 4 <= plan.tile // 4  # a thread for every float4 column
            for g in range(plan.groups):
                i0 = min(g * n, rows)
                i1 = min(i0 + n, rows)
                covered[i0:i1] += 1
                if i0 < i1:
                    a = window[i0:i1]
                    for p in range(1, P):
                        a = a + window[i0 + p : i1 + p]
                    out[row0 + i0 : row0 + i1, col0 : col0 + cols] = a
                    written[row0 + i0 : row0 + i1, col0 : col0 + cols] += 1
            np.testing.assert_array_equal(covered, 1)
            if u + plan.stages * plan.blocks < n_units:
                ring[s] = issue(u + plan.stages * plan.blocks)
            s = (s + 1) % plan.stages
    return out, written


def check_shift_sum_plan(rows_out, W, P, sms, plan):
    """What every K8 plan must give the kernel: runs of R or R+1 rows that
    hold every output row once, no empty block and none past ``sms``, a
    ring whose windows and barriers fit a block's shared memory, column
    tiles that hold every column once, at most 256 threads a block."""
    assert 1 <= plan.runs <= rows_out and 1 <= plan.blocks <= min(sms, plan.runs * -(-W // plan.tile))
    R, extra = divmod(rows_out, plan.runs)
    lengths = [R + (r < extra) for r in range(plan.runs)]
    assert sum(lengths) == rows_out and max(lengths) - min(lengths) <= 1
    assert plan.stages >= 1 and sp.shift_sum_smem(rows_out, P, plan) <= sp.SMEM_LIMIT
    assert plan.tile % 4 == 0 and 4 <= plan.tile <= sp.MAX_TILE
    n_ct = -(-W // plan.tile)
    cover = np.zeros(W, np.int64)
    for t in range(n_ct):
        cover[t * plan.tile : min(W, (t + 1) * plan.tile)] += 1
    np.testing.assert_array_equal(cover, 1)
    assert plan.tile // 4 * plan.groups <= sp.MAX_THREADS and plan.groups >= 1


# (rows_out, W, P): the probe's shape, rows past one window a block (the
# ring refills), fewer rows than SMs, one row, P = 1 and 33, W = 4 and
# 4096, and 42 column tiles of 96 floats taken by blocks of 24 threads
# (fewer than a warp issue the row copies)
K8_SHAPES = [(1024, 128, 11), (200_003, 128, 11), (100, 128, 11), (1, 4, 1), (1, 4, 11), (1024, 128, 1),
             (1024, 128, 33), (1024, 4, 11), (1024, 4096, 11), (1024, 4096, 33), (5, 8, 3), (2999, 60, 8),
             (1, 4000, 300)]


@pytest.mark.parametrize("rows_out,W,P", K8_SHAPES)
@pytest.mark.parametrize("sms", [132, 60, 7])
def test_shift_sum_plan_properties(rows_out, W, P, sms):
    rule = sp.shift_sum_plan(rows_out, W, P, sms)
    check_shift_sum_plan(rows_out, W, P, sms, rule)
    if -(-rule.runs * -(-W // rule.tile) // rule.blocks) > 1:
        assert rule.stages >= 2  # a block of two units or more overlaps the next window's copy
    for kw in ({"run_rows": 1}, {"run_rows": 3, "groups": 2}, {"run_rows": 64}, {"groups": 1},
               {"run_rows": 10**6, "groups": 300}):
        check_shift_sum_plan(rows_out, W, P, sms, sp.shift_sum_plan(rows_out, W, P, sms, **kw))


def test_shift_sum_plan_rule():
    """At the probe's shape 132 runs of 7-8 rows, one a block, each staging
    17-18 rows (9 KB); past one window a block, a ring of two; wide rows in
    column tiles of up to 1024 floats; one row a thread, up to 256
    threads."""
    assert sp.shift_sum_plan(1024, 128, 11) == (132, 132, 128, 1, 8)
    assert sp.shift_sum_staged(1024, 128, 11, sp.shift_sum_plan(1024, 128, 11)) == (1_200_128, 9216)
    assert sp.shift_sum_plan(1024, 128, 33) == (132, 132, 128, 1, 8)
    assert sp.shift_sum_plan(200_003, 128, 11) == (132, 1056, 128, 2, 8)  # runs of 189-190 rows
    assert sp.shift_sum_plan(100, 128, 11) == (100, 100, 128, 1, 1)
    assert sp.shift_sum_plan(1024, 4096, 11) == (132, 33, 1024, 1, 1)  # 4 tiles: 132 units
    assert sp.shift_sum_plan(1024, 4096, 33).tile == 820  # five tiles: 33 rows of 1024 floats fit no two stages
    assert sp.shift_sum_plan(1024, 128, 11, run_rows=2) == (132, 512, 128, 4, 2)
    with pytest.raises(ValueError, match="fit"):
        sp.shift_sum_plan(10, 4, 8000)


@pytest.mark.parametrize("rows_out,W,P", [s for s in K8_SHAPES if s[0] * s[1] <= 1 << 20] + [(2003, 36, 11)])
@pytest.mark.parametrize("kw", [{}, {"run_rows": 5}, {"run_rows": 2, "groups": 3}, {"groups": 1}])
def test_shift_sum_model_is_the_plain_version(rows_out, W, P, kw):
    """``k8_model`` over the rule's plan and over forced ones (short runs,
    so that the ring refills; three groups; one group) writes every output
    element once, exactly as ``staged_shift_sum_plain``."""
    x = np.random.default_rng(rows_out + W + P).standard_normal((rows_out + P - 1, W)).astype(np.float32)
    plan = sp.shift_sum_plan(rows_out, W, P, 7, **kw)
    out, written = k8_model(x, P, plan)
    np.testing.assert_array_equal(written, 1)
    np.testing.assert_array_equal(out, sp.staged_shift_sum_plain(torch.from_numpy(x), P).numpy())


def test_shift_sum_model_divides_as_the_host_does():
    """The multiply-shift the host works out for the tile count gives u //
    n_ct for every unit index up to 2^32 - 1."""
    u = np.array([0, 1, 2, 3, 1000, 65535, 65536, 10**6, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint64)
    for d in (2, 3, 4, 5, 7, 33, 196, 1000, 4096):
        magic, shift = div_magic(d)
        hi = (u * np.uint64(magic)) >> np.uint64(32)
        q = (hi + ((u - hi) >> np.uint64(1))) >> np.uint64(shift - 1)
        np.testing.assert_array_equal(q, u // np.uint64(d))


def test_staging_probes_refuse_x_of_4_gb():
    """The kernels' byte offsets are 32-bit: x, or the windows it stages,
    of 2^32 bytes is refused (broadcast views, so nothing is allocated)."""
    x = torch.zeros(1, 1).expand(1 << 16, 1 << 14)
    small = torch.zeros(1, 1).expand(1 << 16, 1 << 10)  # 256 MB, staging 4.6 GB as windows of one row and 16
    for call in (lambda: sp.staged_add_one(x), lambda: sp.staged_window_double(x, 1024, 11),
                 lambda: sp.staged_window_double(small, 1, 17), lambda: sp.staged_shift_sum(x, 11)):
        with pytest.raises(ValueError, match="offsets"):
            call()


@pytest.mark.parametrize(
    "call,match",
    [
        (lambda x: sp.staged_add_one(x[:, :6].contiguous()), "multiple of 4"),
        (lambda x: sp.staged_add_one(x.to(torch.float64)), "float32"),
        (lambda x: sp.staged_window_double(x[:5], 8, 11), "halo of 10"),
        (lambda x: sp.staged_shift_sum(x[:5], 11), "halo of 10"),
        (lambda x: sp.staged_add_one(x, 0), "block_rows"),
    ],
)
def test_staging_probes_refuse_bad_shapes(call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.zeros(16, 8))


# -- the entry points -----------------------------------------------------------------


@pytest.mark.parametrize("which,v,rows", [("W4", 2.0, 4096), ("X1", 2.0, 4106), ("X2", 11.0, 1034)])
def test_staging_probe_entry_point(which, v, rows, capsys):
    """The printed ``v`` is the TPU probe's: output [0, 0] for ones in."""
    assert probes.main([which, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["which"] == which and line["v"] == v and line["rows"] == rows and line["ok"]


@pytest.mark.parametrize("main", [probes.main, floor.main])
def test_probe_entry_points_refuse_the_cpu_unless_asked(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code == 2


@pytest.mark.parametrize(
    "argv",
    [
        ["W4", "--time", "--device", "cpu"],
        ["X1", "--time"],
        ["X2", "--time", "--device", "cpu"],
        ["W4", "--device", "cpu", "--plan", "4096x4"],
        ["X1", "--device", "cpu", "--input", "rotate"],
        ["X1", "--device", "cpu", "--wrapper"],
        ["X1", "--device", "cpu", "--time", "--wrapper", "--plan", "4096"],
    ],
)
def test_staging_probe_time_needs_a_card(argv, monkeypatch):
    """``--time`` measures the kernels: without a card, or with ``--device
    cpu``, it exits with an error, as do its options without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        probes.main(argv)
    assert e.value.code == 2


def test_staging_probe_plan_spec():
    assert probes.parse_plan("8192") == {"piece": 8192}
    assert probes.parse_plan("2048x8") == {"piece": 2048, "groups": 8}
    for bad in ("", "x4", "8192xregs", "-1", "2048x3", "2048x1x1"):
        with pytest.raises(ValueError, match="PIECE"):
            probes.parse_plan(bad)
    assert probes.parse_plan("8", "X2") == {"run_rows": 8}
    assert probes.parse_plan("8x2", "X2") == {"run_rows": 8, "groups": 2}
    assert probes.parse_plan("x8", "X2") == {"groups": 8}
    for bad in ("", "0", "8x", "8x2x2", "8,2", "x", "8x0"):
        with pytest.raises(ValueError, match="RUN"):
            probes.parse_plan(bad, "X2")


@pytest.mark.parametrize(
    "only,metrics",
    [
        ("dma", ["dma_floor_split1_msps", "dma_floor_split2_msps", "dma_floor_split5_msps", "dma_floor_split10_msps"]),
        ("prelude", ["kernel_prelude_msps"]),
        ("legacy", ["kernel_hist1copy_msps", "kernel_nohist_msps", "kernel_concat2copy_msps"]),
        ("noslice", ["kernel_prelude_noslice_msps"]),
    ],
)
def test_floor_probe_entry_point_keeps_the_arms_and_metric_names(only, metrics, capsys):
    """benchmarks/kernel_floor_probe.py: metric names at :132, :201, :236-238
    and :374; the WBFM shape of :71-75 at the smallest tick the prelude form
    takes."""
    assert floor.main(["--device", "cpu", "--only", only, "--tick", "102400", "--reps", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["metric"] for ln in lines if "metric" in ln] == metrics
    for ln in lines:
        assert ln["tick"] == 102400 and ln["card"] == "cpu" and ln["clock"] == "host" and ln.get("ok", True)
        if "metric" in ln:
            assert ln["per_tick_ms"] > 0 and ln["value"] > 0
            np.testing.assert_allclose(ln["implied_min_traffic_gbps"], ln["value"] * 8 * (1 + 1 / 50) / 1e3)
    if only == "prelude":
        assert lines[0]["check"] == "prelude_vs_plain_mxu" and lines[0]["rel_err"] < 5e-5
    if only == "dma":
        assert all(ln["values_exact"] and ln["plan"]["blocks"] > 0 for ln in lines if "metric" in ln)
        assert lines[-1]["yardstick"] == "read_sum_f32" and lines[-1]["per_tick_ms"] > 0


@pytest.mark.parametrize(
    "spec,want",
    [
        ("1x4096", {"per_sm": 1, "piece": 4096, "stages": 2, "blocks": 100, "unit": 128}),
        ("2x16384", {"per_sm": 2, "piece": 4096, "stages": 1, "blocks": 200, "unit": 128}),
        ("1x98304", {"per_sm": 1, "piece": 8192, "stages": 1, "blocks": 100, "unit": 128}),
    ],
)
def test_floor_probe_times_other_k5_plans(spec, want, capsys, monkeypatch):
    """``--plan`` adds one line a plan to the dma arm (at 100 SMs here, so
    that the blocks differ from the rule's on any card)."""
    monkeypatch.setattr(cf, "SM_COUNT", 100)
    assert floor.main(["--device", "cpu", "--only", "dma", "--tick", "102400", "--reps", "1", "--plan", spec]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    (line,) = [ln for ln in lines if ln.get("metric") == f"dma_plan_{spec}_msps"]
    assert line["plan"] == want and line["values_exact"] and line["ok"]
    assert line["is_rule_plan"] == (spec == "1x98304")
    with pytest.raises(SystemExit):
        floor.main(["--device", "cpu", "--only", "dma", "--plan", "2x16384a16"])


PLAN_ARGS = ["--kernel", "fm_fused", "--T", "728", "--D", "66", "--M", "20000"]


@pytest.mark.parametrize("argv", [PLAN_ARGS + ["--device", "cpu"], PLAN_ARGS])
def test_plan_probe_refuses_to_run_without_a_card(argv, monkeypatch):
    """A plan means nothing on the CPU: no CPU mode, and no card is an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        plan_probe.main(argv)
    assert e.value.code == 2
    with pytest.raises(ValueError, match="CUDA"):
        plan_probe.probe("fm_fused", 728, 66, 20000, False, [("phase", 160)], device="cpu")


@pytest.mark.parametrize(
    "kernel,T,D,M,cplx,form,tile,want",
    [
        ("fm_fused", 728, 66, 20_000, False, "phase", 160, {"blocks": 126, "smem": 105_064, "blocks_per_sm": 2, "is_rule_plan": True}),
        ("fm_fused", 728, 66, 20_000, False, "phase", 224, {"blocks": 90, "smem": 143_464, "blocks_per_sm": 1, "is_rule_plan": False}),
        ("fm_fused", 728, 66, 20_000, False, "taps", 64, {"blocks": 318, "smem": 42_512, "blocks_per_sm": 5, "is_rule_plan": False}),
        ("fm_fused", 728, 66, 20_000, False, "taps", 32, {"blocks": 646, "smem": 25_360, "blocks_per_sm": 8, "is_rule_plan": False}),
        ("fm_fused", 9660, 666, 625, False, "taps", 16, {"blocks": 42, "smem": 195_968, "blocks_per_sm": 1, "is_rule_plan": False}),
        ("fm_fused", 9660, 666, 625, False, "taps", 8, {"blocks": 90, "smem": 153_280, "blocks_per_sm": 1, "is_rule_plan": True}),
        ("decim_fir", 546, 50, 25_600, True, "phase", 224, {"blocks": 115, "smem": 114_208, "is_rule_plan": True}),
        ("decim_fir", 868, 250, 5_120, True, "taps", 16, {"blocks": 320, "is_rule_plan": True}),
        ("fir_decim", 546, 50, 25_600, False, "phase", 224, {"blocks": 115, "smem": 112_008, "is_rule_plan": True}),
        ("fir_decim", 546, 50, 25_600, False, "phase", 160, {"blocks": 160, "smem": 81_800, "is_rule_plan": False}),
        ("fir_decim", 868, 250, 5_120, False, "taps", 40, {"blocks": 128, "smem": 88_416, "is_rule_plan": True}),
        ("fir_decim", 46, 2, 2_560, False, "outputs", 32, {"blocks": 80, "smem": 3_096, "is_rule_plan": True}),
        ("fir_decim", 6665, 500, 2_560, False, "taps", 24, {"blocks": 107, "smem": 171_980, "is_rule_plan": True}),
    ],
)
def test_plan_probe_describes_a_plan_from_its_shape(kernel, T, D, M, cplx, form, tile, want):
    plan = plan_probe.make_plan(kernel, T, D, cplx, form, tile, None)
    got = plan_probe.describe(kernel, T, D, M, cplx, plan)
    assert (got["form"], got["tile"], got["chunk"]) == (form, tile, T)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("kernel,cplx", [("decim_fir", True), ("decim_fir", False), ("fm_fused", False), ("fir_decim", False)])
def test_plan_probe_inputs_sit_in_the_passband(kernel, cplx):
    """The probe's value check is relative to the plain version's output:
    its tone must pass the filter (a filtered-out tone would leave a peak
    of the noise's size and the check would mean nothing)."""
    from tpusdr_torch.kernels import fir_banded as tfb
    from tpusdr_torch.kernels import fm_fused as tfm
    from tpusdr_torch.ops import osc

    T, D, M = 91, 10, 400
    signal, taps = plan_probe.probe_inputs(kernel, T, D, (T - 1) + (M + 1) * D, cplx)
    assert signal.dtype == np.complex64 and taps.dtype == (np.complex64 if cplx else np.float32)
    z, h = torch.from_numpy(signal), torch.from_numpy(taps)
    if kernel == "fm_fused":
        inc = osc.freq_to_inc_u32(-plan_probe.F_OFF, plan_probe.FS)
        y = tfm.fused_fm_demod_plain(z, h, D, inc, 0, plan_probe.GAIN, M).numpy()
        assert 0.5 * plan_probe.GAIN * 2 * np.pi * 1e3 * D / plan_probe.FS < np.abs(y[50:]).max() < 0.1
    else:
        y = tfb.decim_fir_plain(None, z, h, D, 0, M).numpy()
        assert 0.8 < np.abs(y[20:]).max() < 1.0


@pytest.mark.parametrize("tile,C,want", [
    (160, 57, {"blocks": 264, "smem": 111_400, "blocks_per_sm": 2, "is_rule_plan": True}),
    (160, 1, {"blocks": 122, "smem": 111_400, "is_rule_plan": False}),
])
def test_plan_probe_describes_the_shared_form(tile, C, want):
    """FM-fused's shared form at the nbfm.capture shape: its blocks are the
    persistent grid (two an SM on 132 SMs, or one a work item where there
    are fewer), the rule's plan only from ``SHARED_MIN_CHANNELS`` on."""
    plan = plan_probe.make_plan("fm_fused", 728, 66, False, "shared", tile, None)
    got = plan_probe.describe("fm_fused", 728, 66, 19_375, False, plan, C)
    assert (got["form"], got["tile"], got["chunk"], got["C"]) == ("shared", tile, 728, C)
    assert {k: got[k] for k in want} == want


def test_plan_probe_channel_signal_holds_a_station_a_channel():
    """With --C the probe's signal holds a station in every channel, so
    that each row of the value check means something: at (728, /66) each
    channel decodes its station's 1 kHz tone at the amplitude of the
    single-station signal, the neighbours 25 kHz away filtered out."""
    from tpusdr_torch.kernels import fm_fused as tfm
    from tpusdr_torch.ops import osc

    T, D, M, C = 728, 66, 300, 3
    _, taps = plan_probe.probe_inputs("fm_fused", T, D, 8, False)
    z = torch.from_numpy(plan_probe.channel_signal((T - 1) + (M + 1) * D, C))
    incs = torch.tensor([osc.freq_to_inc_u32(-(plan_probe.F_OFF + c * plan_probe.CHANNEL_STEP), plan_probe.FS)
                         for c in range(C)])
    y = tfm.fused_fm_demod_plain(z, torch.from_numpy(taps), D, incs, osc.as_phases([1, 2, 3]), plan_probe.GAIN, M)
    assert y.shape == (C, M)
    t = np.arange(50, M) * D / plan_probe.FS
    basis = np.stack([np.sin(2 * np.pi * 1e3 * t), np.cos(2 * np.pi * 1e3 * t)], 1)
    amp = plan_probe.GAIN * 2 * np.pi * 1e3 * D / plan_probe.FS  # modulation index 1: peak deviation 1 kHz
    for row in y.numpy():
        fit, *_ = np.linalg.lstsq(basis, row[50:], rcond=None)
        rest = row[50:] - basis @ fit
        assert abs(np.hypot(*fit) - amp) < 0.1 * amp and np.sqrt((rest**2).mean()) < 0.1 * amp


def test_plan_probe_takes_channels_for_fm_fused_alone():
    with pytest.raises(ValueError, match="FM-fused"):
        plan_probe.probe("decim_fir", 546, 50, 1000, False, [("phase", 224)], C=2)
    with pytest.raises(ValueError, match="--part"):
        plan_probe.probe("fm_fused", 728, 66, 1000, False, [("shared", 160)], part="fill+sums")


def test_plan_probe_names_what_the_kernels_are_not_built_for():
    assert "built for tiles" in plan_probe.make_plan("fm_fused", 728, 66, False, "taps", 48, None)
    assert "built for tiles" in plan_probe.make_plan("decim_fir", 546, 50, True, "phase", 160, None)
    assert "built for tiles" in plan_probe.make_plan("fm_fused", 728, 66, False, "phase", 128, None)
    assert "built for tiles" in plan_probe.make_plan("fir_decim", 868, 250, False, "taps", 12, None)
    assert "built for tiles" in plan_probe.make_plan("fir_decim", 46, 2, False, "outputs", 16, None)
    assert "has no outputs form" in plan_probe.make_plan("fm_fused", 728, 66, False, "outputs", 32, None)
    assert "built for tiles" in plan_probe.make_plan("fm_fused", 728, 66, False, "shared", 64, None)
    assert "has no shared form" in plan_probe.make_plan("fir_decim", 546, 50, False, "shared", 160, None)
    assert "shared memory" in plan_probe.make_plan("fm_fused", 9660, 666, False, "shared", 160, None)
    assert "taps a phase" in plan_probe.make_plan("fm_fused", 1100, 66, False, "shared", 160, None)
    assert "taps a phase" in plan_probe.make_plan("fm_fused", 66, 66, False, "shared", 160, None)
    assert "shared memory" in plan_probe.make_plan("fir_decim", 868, 250, False, "phase", 160, None)
    assert "shared memory" in plan_probe.make_plan("fm_fused", 9660, 666, False, "phase", 224, None)
    assert "shared memory" in plan_probe.make_plan("fm_fused", 9660, 666, False, "taps", 32, 9660)
    assert "--chunk" in plan_probe.make_plan("fm_fused", 60000, 666, False, "taps", 8, None)
    rule = plan_probe.rule_plan("fm_fused", 60000, 666, 300, False)
    assert plan_probe.make_plan("fm_fused", 60000, 666, False, "taps", 8, rule.chunk) == rule and rule.chunk < 60000


def test_floor_probe_taps_are_the_jax_probes():
    """kernel_floor_probe.py:73-75."""
    taps = sps.firwin(546, 2 * 100e3 / 20e6).astype(np.float32)
    shift = np.exp(-2j * np.pi * 2.5e6 / 20e6 * np.arange(546)).astype(np.complex64)
    np.testing.assert_array_equal(floor.wbfm_taps(), (taps * shift).astype(np.complex64))
    assert floor.launches_expected(20) == {"copy_floor": 96, "banded_fir_prelude": 47, "banded_fir": 69}
    with pytest.raises(ValueError, match="8G"):
        floor.floor_probe("cpu", tick=100_000)


def _pair(z):
    return jcplx.Complex(jnp.asarray(z.real.copy()), jnp.asarray(z.imag.copy()))


@pytest.mark.parametrize(
    "arm", ["kernel_prelude", "kernel_hist1copy", "kernel_nohist", "kernel_concat2copy", "kernel_prelude_noslice"]
)
def test_floor_probe_arms_match_the_pallas_kernels(rng, arm):
    """Two steps of each K1/K2 arm at a small shape (T=89, D=8, tick 24G)
    against the TPU kernels in interpret mode, fed the ticks and carries
    the arm is documented to use."""
    T, D = 89, 8
    G, _ = jfb.prelude_plan(T, D)
    tick = 24 * G
    t = (sps.firwin(T, 0.05) * np.exp(-2j * np.pi * 0.15 * np.arange(T))).astype(np.complex64)
    xs = crandn(rng, 3, tick)
    step = floor.arm_steps(torch.from_numpy(xs), torch.from_numpy(t), D)[arm]
    pre, tail = np.zeros((8, G), np.complex64), np.zeros(T - 1, np.complex64)
    for i in (1, 2):  # the first call takes xs[1]
        z = xs[0] if arm == "kernel_prelude_noslice" else xs[i]
        if arm.startswith("kernel_prelude"):
            ref = jfb.banded_fir_prelude(jcplx.from_numpy(z), _pair(pre), t, D, interpret=True)
            if arm == "kernel_prelude":
                pre = z[-8 * G :].reshape(8, G)
        elif arm == "kernel_hist1copy":
            ref = jfb.banded_fir_pallas(jcplx.from_numpy(z), t, D, interpret=True, history=jcplx.from_numpy(tail))
            tail = z[-(T - 1) :]
        elif arm == "kernel_nohist":
            ref = jfb.banded_fir_pallas(jcplx.from_numpy(z), t, D, interpret=True)
        else:
            ext = np.concatenate([tail, z])
            ref = jfb.banded_fir_pallas(jcplx.from_numpy(ext), t, D, interpret=True)
            tail = ext[-(T - 1) :]
        close_to_peak(step().numpy(), jcplx.to_numpy(ref))


# -- utils/profiling ------------------------------------------------------------------


def test_format_profile_equals_jax():
    rows = [{"stage": "<whole chain>", "seconds_per_tick": 1.25e-3, "msps": 104.9, "tick": 131072},
            {"stage": "shiftfir", "seconds_per_tick": 3.1e-4, "msps": 422.8, "tick": 131072}]
    assert tprof.format_profile(rows) == jprof.format_profile(rows)


def test_profile_chain_and_trace_on_the_cpu(rng, tmp_path):
    chain, _ = TR.fm_receiver(2e6, 300e3, TR.WBFM)
    x = torch.from_numpy(crandn(rng, 20000))
    rows = tprof.profile_chain(chain, x, "cpu", iters=1)
    assert [r["stage"] for r in rows] == ["<whole chain>"] + [n for n, _ in chain.blocks]
    assert rows[0]["tick"] == 20000 and rows[-1]["tick"] == 4000  # the resampler sees the quad rate
    assert all(set(r) == {"stage", "seconds_per_tick", "msps", "tick"} and r["msps"] > 0 for r in rows)
    with tprof.trace(str(tmp_path / "trace")) as prof:
        chain.apply(chain.init_state(), x)
    assert prof.key_averages() and (tmp_path / "trace" / "trace.json").stat().st_size > 0
