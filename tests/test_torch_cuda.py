"""tpusdr_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc; without them each skips (the
decision is taken in the ``cuda`` fixture, not at import).  This file
imports neither JAX nor tpusdr, so it runs where only PyTorch is
installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: FIR outputs within 1e-5 of the output's peak and FM
discriminator outputs within 1e-5 * gain (float32 on both sides, only the
summation order and the libm calls differ); chain audio at <= -60 dB
error energy against the port's CPU path.

The receivers at 20 Msps with one long RF stage design 6,665 or 9,660
Remez taps on the host first, which takes a minute or two.
"""

import copy
from typing import NamedTuple

import numpy as np
import pytest
import torch

from tpusdr_torch import kernels
from tpusdr_torch.graph import queues
from tpusdr_torch.graph.checkpoint import load_state, save_state
from tpusdr_torch.graph.runner import CapturedStep, StreamRunner
from tpusdr_torch.io.sinks import CollectSink
from tpusdr_torch.io.sources import SyntheticIqSource
from tpusdr_torch.kernels import copy_floor as tcf
from tpusdr_torch.kernels import fir_banded as tfb
from tpusdr_torch.kernels import fir_poly as tfp
from tpusdr_torch.kernels import fm_fused as tfm
from tpusdr_torch.kernels import resample_poly as trp
from tpusdr_torch.kernels import staging_probes as tsp
from tpusdr_torch.models import multichannel, receiver
from tpusdr_torch.ops import channelizer as tchan
from tpusdr_torch.ops import osc
from tpusdr_torch.ops import resample as tres

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(31)


def crandn(rng, dev, *shape):
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy(z.astype(np.complex64)).to(dev)


def taps(T, complex_taps, dev):
    n = np.arange(T) - (T - 1) / 2
    t = (0.1 * np.sinc(0.1 * n) * np.hamming(T)).astype(np.float32)
    if complex_taps:
        t = (t * np.exp(1j * 0.37 * np.arange(T))).astype(np.complex64)
    return torch.from_numpy(t).to(dev)


def close_to_peak(got, ref, rel=1e-5):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def fm_tone(rng, n, fs, offset, deviation):
    t = np.arange(n) / fs
    ph = 2 * np.pi * offset * t + 2 * np.pi * deviation * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / fs
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (0.9 * np.exp(1j * ph) + 0.01 * noise).astype(np.complex64)


def err_db(ref, got):
    return 10 * np.log10(np.sum((ref - got) ** 2) / np.sum(ref**2))


@pytest.mark.parametrize(
    "T,D,complex_taps,M,form,tile",
    [
        (546, 50, True, 25_637, "phase", 224),  # WBFM 20 Msps tick, ragged last tile
        (546, 50, False, 20_011, "phase", 224),
        (546, 50, True, 2_560, "taps", 8),
        (728, 12, True, 87_380, "phase", 224),  # the digital app's stage
        (728, 12, False, 21_841, "phase", 224),
        (2500, 8, True, 20_000, "phase", 224),  # Q = 313: 44 whole groups and 5 taps
        (2500, 8, True, 6_144, "taps", 16),
        (101, 9, True, 30_001, "phase", 224),  # odd D: the pitch is D itself
        (101, 7, True, 30_001, "taps", 64),  # D < 8 stays lanes-across-taps
        (868, 250, True, 5_120, "taps", 16),  # AM stage 1
        (868, 250, True, 30_000, "taps", 32),
        (46, 2, True, 2_560, "taps", 8),  # AM stage 2
        (46, 2, False, 50_001, "taps", 64),
        (33, 4, False, 2_560, "taps", 8),
        (6665, 500, True, 2_560, "taps", 32),  # F1: single-stage AM at 20 Msps
        (9660, 666, False, 2_560, "taps", 16),  # F1: single-stage NBFM at 20 Msps
        (9660, 666, True, 2_560, "taps", 8),
    ],
)
def test_decim_fir_history_form(cuda, rng, T, D, complex_taps, M, form, tile):
    """Both inner loops of the kernel at the shapes the rule gives them,
    ragged M included.  x ends in D // 2 samples past the last one a tap
    reads, all NaN: they must not reach an output."""
    assert tfb.decim_fir_plan(T, D, complex_taps, M) == (form, tile, T)
    h = taps(T, complex_taps, cuda)
    hist, x = crandn(rng, cuda, T - 1), crandn(rng, cuda, M * D + D // 2)
    x[M * D :] = float("nan")
    before = tfb.banded_fir.launches
    got = tfb.banded_fir(x, h, D, history=hist)
    assert tfb.banded_fir.launches == before + 1
    assert got.shape == (M,) and bool(torch.isfinite(torch.view_as_real(got)).all())
    close_to_peak(got, tfb.decim_fir_plain(hist, x, h, D, 0, M))


@pytest.mark.parametrize(
    "T,D,rows,complex_taps",
    [
        (546, 50, 200, True),  # phase-major, s0 = 8G - 545
        (546, 50, 200, False),
        (546, 50, 48, True),  # lanes across taps
        (89, 8, 48, True),
        (2500, 8, 48, True),
        (2500, 8, 160, True),  # phase-major with history three rows deep
        (728, 12, 688, True),
        (46, 2, 64, False),
    ],
)
def test_decim_fir_prelude_form_streaming(cuda, rng, T, D, rows, complex_taps):
    G, _ = tfb.prelude_plan(T, D)
    h = taps(T, complex_taps, cuda)
    pre = torch.zeros(8, G, dtype=torch.complex64, device=cuda)
    for _ in range(2):
        x = crandn(rng, cuda, rows * G)
        got = tfb.banded_fir_prelude(x, pre, h, D)
        ref = tfb.decim_fir_plain(pre.reshape(-1), x, h, D, 8 * G - (T - 1), rows * G // D)
        close_to_peak(got, ref)
        pre = x[-8 * G :].reshape(8, G)


@pytest.mark.parametrize("hist", ["tail", "none"])
@pytest.mark.parametrize(
    "T,D,M,form,tile",
    [
        (728, 66, 20_000, "phase", 160),  # NBFM 2 Msps, a 1,320,000-sample tick: 126 blocks, the last ragged
        (728, 66, 20_001, "phase", 160),
        (728, 66, 159 * 88, "phase", 160),  # whole blocks only
        (728, 66, 223, "taps", 8),
        (728, 66, 1, "taps", 8),
        (728, 66, 13_000, "taps", 32),
        (546, 50, 25_600, "phase", 160),  # Q = 11: every phase but 46 has the eleventh tap
        (132, 66, 20_000, "phase", 160),  # T = Q * D: every phase has Q taps
        (101, 9, 30_001, "phase", 160),  # odd D: the pitch is D itself
        (91, 10, 800, "taps", 8),
        (9660, 666, 625, "taps", 8),  # single-stage NBFM at 20 Msps, a 416,250-sample tick
        (9660, 666, 1_250, "taps", 16),
        (9660, 666, 2_560, "taps", 16),
    ],
)
def test_fm_fused(cuda, rng, T, D, M, form, tile, hist):
    """Both inner loops at the shapes the rule gives them, M ragged against
    the block, [history, x] through the two pointers (the streaming carry
    of (T-1) + D samples, or none), several NCO phases (one that wraps
    inside the first block) and increments either side of 2^31, each given
    by value and as the carried phase through the pointer (bit for bit the
    same, and bit for bit the same tensor handed over whole).  x ends in
    D // 2 NaN samples past the last one a tap reads: they must reach no
    output."""
    assert tfm.fm_fused_plan(T, D, M) == (form, tile, T)
    h = taps(T, False, cuda)
    n = (T - 1) + (M + 1) * D
    tone = fm_tone(rng, n + D // 2, 2e6, 100e3, 5e3)
    H = (T - 1) + D if hist == "tail" else 0
    down, up = osc.freq_to_inc_u32(-100e3, 2e6), osc.freq_to_inc_u32(100e3, 2e6)
    assert up < 2**31 < down
    for signal, inc, ph in ((tone, down, osc.radians_to_u32(0.3)), (tone, down, 2**32 - 200), (tone.conj(), up, 2**31 - 5)):
        z = torch.from_numpy(signal).to(cuda)
        z[n:] = float("nan")
        before = tfm.fused_fm_demod.launches
        got = tfm.fused_fm_demod(z[H:], h, D, inc, osc.as_phase(ph, cuda), 0.32, history=z[:H] if H else None)
        by_value = tfm.fused_fm_demod(z[H:], h, D, inc, ph, 0.32, history=z[:H] if H else None)
        assert tfm.fused_fm_demod.launches == before + 2
        assert torch.equal(got, by_value)
        if H:
            assert torch.equal(got, tfm.fused_fm_demod(z, h, D, inc, ph, 0.32))
        ref = tfm.fused_fm_demod_plain(z[:n], h, D, inc, ph, 0.32, M)
        assert got.shape == (M,) and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5 * 0.32)


@pytest.mark.parametrize(
    "args,kw,tick,wrapper",
    [
        ((2e6, 300e3, receiver.WBFM), {}, 40000, "banded_fir"),
        ((2e6, 300e3, receiver.WBFM), {"use_fused": True}, 128000, "banded_fir_prelude"),
        ((2e6, 100e3, receiver.NBFM), {"use_fused": True}, 33000, "fused_fm_demod"),
        ((20e6, 2.5e6, receiver.WBFM), {}, 131_250, "banded_fir"),  # wbfm.live's block: 3/25 over 2,625
    ],
)
def test_receiver_on_the_card_matches_cpu(cuda, rng, args, kw, tick, wrapper):
    """Three ticks through a CapturedStep (eager, captured, replayed)
    against the CPU chain: the audio within -60 dB, the RF kernel and the
    resampler's kernel (one row) once a tick."""
    counter = {w.__name__: w for w in kernels.WRAPPERS}[wrapper]
    gpu_chain, _ = receiver.fm_receiver(*args, **kw)
    cpu_chain, _ = receiver.fm_receiver(*args, **kw)
    gpu_chain.to(cuda)
    step = CapturedStep(gpu_chain)
    z = fm_tone(rng, 3 * tick, args[0], args[1], 75e3 if args[2] == receiver.WBFM else 5e3)
    gs, cs = gpu_chain.init_state(device=cuda), cpu_chain.init_state()
    before = counter.launches
    rs_before = (trp.resample_poly.launches, trp.resample_poly.rows)
    for i in range(3):
        blk = torch.from_numpy(z[i * tick : (i + 1) * tick])
        gs, gy = step(gs, blk.to(cuda))
        cs, cy = cpu_chain.apply(cs, blk)
        assert err_db(cy.numpy(), gy.cpu().numpy()) <= -60.0
    assert step.eager_ticks == 1 and step.captures == 1
    assert counter.launches == before + 3
    assert (trp.resample_poly.launches, trp.resample_poly.rows) == (rs_before[0] + 3, rs_before[1] + 3)


def test_shared_memory_rules_match_the_kernels(cuda):
    """The plans' byte counts (pure Python, used on the CPU) equal what the
    kernels' C side allocates, and FM-fused's grids the ones it launches."""
    from tpusdr_torch.kernels.build import library

    lib = library()
    for D in (2, 7, 12, 50, 250, 500, 666):
        for T in (46, 546, 868, 6665):
            for c in (0, 1):
                phase = tfb.DecimFirPlan("phase", tfb.PHASE_TILE, T)
                assert lib.tpusdr_decim_fir_smem(T, D, c, 1, phase.tile, T) == tfb.decim_fir_smem(T, D, bool(c), phase)
            for tile in tfb.TILES:
                for chunk in {46, T}:
                    for c in (0, 1):
                        plan = tfb.DecimFirPlan("taps", tile, chunk)
                        assert lib.tpusdr_decim_fir_smem(T, D, c, 0, tile, chunk) == tfb.decim_fir_smem(T, D, bool(c), plan)
                    fm = tfm.FmFusedPlan("taps", tile, chunk)
                    assert lib.tpusdr_fm_fused_smem(T, D, 0, tile, chunk) == tfm.fm_fused_smem(T, D, fm)
            for tile in tfm.PROBE_PHASE_TILES:
                fm = tfm.FmFusedPlan("phase", tile, T)
                assert lib.tpusdr_fm_fused_smem(T, D, 1, tile, T) == tfm.fm_fused_smem(T, D, fm)
            for tile in tfm.SHARED_TILES:
                fm = tfm.FmFusedPlan("shared", tile, T)
                assert lib.tpusdr_fm_fused_smem(T, D, 2, tile, T) == tfm.fm_fused_smem(T, D, fm)
            for form, tiles in (("taps", tfp.TAP_TILES), ("phase", tfp.PHASE_TILES), ("outputs", tfp.OUTPUT_TILES)):
                for tile in tiles:
                    for chunk in {46, T} if form != "phase" else {T}:
                        plan = tfp.FirDecimPlan(form, tile, chunk)
                        assert lib.tpusdr_fir_poly_smem(T, D, tfp.FORMS.index(form), tile, chunk) == tfp.fir_decim_smem(T, D, plan)
    # the shared form's persistent grid is the card's resident blocks, two an SM at the nbfm.capture
    # shape, as the rule counts them
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert tfm.fm_fused_grid(728, 66, 19_375, 57, tfm.fm_fused_plan(728, 66, 19_375, 57)) == 2 * sms


def test_long_taps_run_in_chunks(cuda, rng):
    """F1: taps too long for even an 8-output window run in chunks."""
    T, D = 30000, 2
    x = crandn(rng, cuda, 1 << 16)
    plan = tfb.decim_fir_plan(T, D, True, ((1 << 16) - (T - 1)) // D)
    assert plan.form == "taps" and plan.tile == 8 and plan.chunk < T
    h = taps(T, True, cuda)
    close_to_peak(tfb.banded_fir(x, h, D), tfb.decim_fir_plain(None, x, h, D, 0, ((1 << 16) - (T - 1)) // D))
    fm = tfm.fm_fused_plan(60000, 666, 300)
    assert fm.form == "taps" and fm.tile == 8 and fm.chunk < 60000
    hf = taps(60000, False, cuda)
    z = torch.from_numpy(fm_tone(rng, 59999 + 301 * 666, 20e6, 1e6, 5e3)).to(cuda)
    inc, ph = osc.freq_to_inc_u32(-1e6, 20e6), osc.init_phase(0.1, cuda)  # read through the pointer
    got = tfm.fused_fm_demod(z, hf, 666, inc, ph, 0.5)
    ref = tfm.fused_fm_demod_plain(z, hf, 666, inc, ph, 0.5, 300)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5 * 0.5)


@pytest.mark.parametrize("T,D,L", [(868, 250, 867 + 1_280_000), (46, 2, 45 + 5120), (6665, 500, 6664 + 1_280_000),
                                   (546, 50, 545 + 1_280_000)])
def test_fir_decim_k4(cuda, rng, T, D, L):
    """K4 through its wrapper at the paths' shapes: (868, /250) on a 20 Msps
    tick, (46, /2) on its 5,120-sample input, the single long stage and the
    JSON graph's (546, /50); the carried T-1 samples through the second
    pointer and the whole input as one tensor give the same outputs."""
    h = taps(T, False, cuda)
    x = crandn(rng, cuda, L)
    before = tfp.fir_decim.launches
    got = tfp.fir_decim(x[T - 1 :], h, D, history=x[: T - 1])
    assert tfp.fir_decim.launches == before + 1
    close_to_peak(got, tfp.fir_decim_plain(x, h, D, (L - (T - 1)) // D))
    assert torch.equal(got, tfp.fir_decim(x, h, D))


@pytest.mark.parametrize("hist", ["tail", "none"])
@pytest.mark.parametrize(
    "T,D,M,form,tile,chunk",
    [
        (546, 50, 25_601, "phase", 224, None),  # the JSON graph's tick and one, R = 7
        (546, 50, 25_601, "phase", 160, None),  # R = 5
        (132, 66, 20_000, "phase", 160, None),  # T = Q * D: every phase has Q taps
        (9, 12, 5_000, "phase", 224, None),  # T < D: Q = 1, three phases have no tap
        (101, 9, 30_001, "phase", 160, None),  # odd D: the pitch is D itself
        (868, 250, 5_120, "taps", 40, None),  # AM stage 1
        (868, 250, 5_123, "taps", 64, None),
        (868, 250, 5_123, "taps", 56, None),
        (868, 250, 5_123, "taps", 48, None),
        (6665, 500, 2_560, "taps", 24, None),  # single-stage AM
        (6665, 500, 2_560, "taps", 32, None),
        (6665, 500, 2_561, "taps", 16, None),
        (5_000, 9, 3_001, "taps", 8, 1_024),  # taps in chunks, the last one short
        (46, 2, 2_560, "outputs", 32, None),  # AM stage 2
        (46, 2, 2_561, "outputs", 64, None),
        (46, 2, 2_560, "outputs", 128, None),
        (46, 2, 50_001, "outputs", 256, None),
        (5, 7, 3_000, "outputs", 32, None),  # T < D
        (300, 3, 4_001, "outputs", 128, 96),  # taps in chunks, the last one short
    ],
)
def test_fir_decim_every_form(cuda, rng, T, D, M, form, tile, chunk, hist):
    """Every form and tile of K4 through its C entry point against the plain
    version, with and without the history through the second pointer, M
    ragged against the tile; x ends in D // 2 NaN samples past the last one
    a tap reads: they must reach no output."""
    from tpusdr_torch.kernels.build import library

    lib = library()
    h = taps(T, False, cuda)
    H = T - 1 if hist == "tail" else 0
    z = crandn(rng, cuda, (T - 1) + M * D + D // 2)
    n = (T - 1) + M * D
    z[n:] = float("nan")
    plan = tfp.FirDecimPlan(form, tile, T if chunk is None else chunk)
    y = torch.full((M,), float("nan"), dtype=torch.complex64, device=cuda)
    head, tail = tfp.launch_args(lib, z[:H] if H else None, z[H:], h, D, M, plan, y)
    assert lib.tpusdr_fir_poly(*head, *tail) == 0
    torch.cuda.synchronize()
    assert bool(torch.isfinite(torch.view_as_real(y)).all())
    close_to_peak(y, tfp.fir_decim_plain(z[:n], h, D, M))


def am_ticks(n, fs, offset, n_ticks, fmt="int8"):
    return list(SyntheticIqSource.am(n, fs, offset, fmt, num_blocks=n_ticks))


@pytest.mark.parametrize(
    "build,tick,counter,per_tick",
    [
        # F1: both raised in launch_target before the tile rule
        (lambda: receiver.fm_receiver(20e6, 1e6, receiver.NBFM, use_fused=True), 416250, "fused_fm_demod", 1),
        (lambda: receiver.am_receiver(20e6, 1.2e6, multistage=False), 500000, "banded_fir", 1),
        # the AM path through K4
        (lambda: receiver.am_receiver(20e6, 1.2e6, input_format="int8", fir_mode="pallas", fold_shift=False),
         1_280_000, "fir_decim", 2),
    ],
)
def test_long_receivers_on_the_card_match_cpu(cuda, rng, build, tick, counter, per_tick):
    counter = {w.__name__: w for w in kernels.WRAPPERS}[counter]
    cpu_chain, _ = build()
    gpu_chain = copy.deepcopy(cpu_chain).to(cuda)
    if counter is tfm.fused_fm_demod:
        ticks = np.split(fm_tone(rng, 2 * tick, 20e6, 1e6, 5e3), 2)
    else:
        ticks = am_ticks(tick, 20e6, 1.2e6, 2, "int8" if cpu_chain.blocks[0][0] == "iq" else "cf32")
    gs, cs = gpu_chain.init_state(device=cuda), cpu_chain.init_state()
    before = counter.launches
    for blk in ticks:
        gs, gy = gpu_chain.apply(gs, torch.from_numpy(blk).to(cuda))
        cs, cy = cpu_chain.apply(cs, torch.from_numpy(blk))
        assert err_db(cy.numpy(), gy.cpu().numpy()) <= -60.0
    assert counter.launches == before + per_tick * len(ticks)


def test_runner_on_the_card_matches_cpu(cuda):
    """StreamRunner's pinned uploads and fetches on the card give the CPU
    runner's audio."""
    ticks = am_ticks(500000, 20e6, 1.2e6, 3)
    outs = []
    for dev in ("cuda", "cpu"):
        chain, _ = receiver.am_receiver(20e6, 1.2e6, input_format="int8")
        sink = CollectSink()
        _, stats = StreamRunner(chain.to(dev), device=dev).run(iter(ticks), sink)
        assert stats.blocks == 3
        outs.append(sink.result())
    assert err_db(outs[1], outs[0]) <= -60.0


def test_mixed_devices_raise(cuda):
    x = torch.zeros(4096, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.banded_fir(x, torch.ones(33), 4)


# -- K5-K8: the copy floor and the staging probes ----------------------------------------


def head_cuts(n_rows, G, n_split, plan):
    """(span, piece) boundaries of a K5 launch that fall inside a row head,
    [r*G*8, r*G*8 + 1024), from the kernel's span and piece arithmetic."""
    unit, row = plan.unit, G * 8
    q, extra = divmod(n_rows * row // unit, plan.blocks)
    spans = [(b * q + min(b, extra)) * unit for b in range(plan.blocks)] + [n_rows * row]
    pieces = [a for b, e in zip(spans, spans[1:]) for a in range(b + plan.piece, e, plan.piece)]
    inside = lambda cuts: sum(0 < a % row < 1024 for a in cuts)  # noqa: E731
    return inside(spans), inside(pieces)


@pytest.mark.parametrize(
    "n_rows,G,n_split,cuts",
    [
        (200, 6400, 1, None),  # the probe shape at a 1,280,000-sample tick
        (320, 6400, 10, None),  # the JAX probe's tick
        (200, 6400, 5, None),
        (50, 512, 4, None),  # a row is 4 KB: many rows a piece
        (1, 128, 1, None),  # 64 units of 16 B: 64 blocks of one unit, fewer than the SMs take
        (133, 128, 2, None),  # every byte is a row head
        (30, 12800, 10, None),  # a 102,400-byte row
        (320, 6400, 1, "span+piece"),  # row heads cut by a span and by a piece boundary
        (7, 6400, 1, "span"),  # spans of about 1,360 B: heads cut by span boundaries
        (4, 20000, 1, None),  # a 160,000-byte row: refused while a stage held whole rows
        (50, 20000, 10, None),
        (2000, 6400, 1, None),  # a 12,800,000-sample tick: each span longer than its ring
        (2000, 6400, 10, None),
        (1, 128, 2, None),
        (133, 128, 1, None),
    ],
)
def test_copy_floor_k5(cuda, rng, n_rows, G, n_split, cuts):
    """Random data: a block that read its stage before the copy landed
    would pass on ones and fail here.  Every case has spans whose last
    piece is short; in (320, 6400, 1) and (7, 6400, 1) the tick's bytes are
    not a multiple of the piece either."""
    plan =tcf.copy_floor_plan(n_rows, G, n_split, tcf.sm_count(0))
    spans, pieces = head_cuts(n_rows, G, n_split, plan)
    if cuts is not None:
        assert spans > 0 and (pieces > 0) == ("piece" in cuts)
    x = crandn(rng, cuda, n_rows, G)
    before = tcf.copy_floor.launches
    got = tcf.copy_floor(x, n_split)
    torch.cuda.synchronize()
    assert tcf.copy_floor.launches == before + 1
    assert torch.equal(got, tcf.copy_floor_plain(x))


def test_copy_floor_refuses_a_split_that_does_not_divide(cuda, rng):
    x = crandn(rng, cuda, 8, 6400)
    before = tcf.copy_floor.launches
    with pytest.raises(ValueError, match="n_split=3"):
        tcf.copy_floor(x, 3)
    with pytest.raises(ValueError, match="does not fit"):
        tcf.copy_floor(crandn(rng, cuda, 2, 40000), 20000)  # a piece of 20,000 copies of 16 B
    assert tcf.copy_floor.launches == before
    lib = __import__("tpusdr_torch.kernels.build", fromlist=["library"]).library()
    plan = tcf.copy_floor_plan(200, 6400, 1, tcf.sm_count(0))
    smem = tcf.copy_floor_smem(plan)
    assert lib.tpusdr_copy_floor_smem(plan.piece, plan.stages) == smem == 77696 + 8
    assert plan.unit == 128
    assert lib.tpusdr_copy_floor_resident(smem, 0) >= plan.per_sm == 1
    plan = tcf.copy_floor_plan(2000, 6400, 1, tcf.sm_count(0))  # a ring of two 97,024-byte pieces
    assert lib.tpusdr_copy_floor_resident(tcf.copy_floor_smem(plan), 0) >= plan.per_sm and plan.stages == 2


@pytest.mark.parametrize(
    "rows,W,B,P,offset",
    [
        (4096, 128, 1024, 11, 0),  # the probes' shapes
        (777, 36, 100, 11, 0),
        (33, 4, 32, 3, 0),
        (5, 8, 1, 1, 0),
        (4096, 128, 1000, 11, 0),  # spans that cross a probe-block boundary
        (2000, 64, 33, 40, 0),  # halos past the next probe block, in the next block's span
        (100, 128, 16, 5, 0),  # fewer rows than SMs
        (20, 4, 3, 2, 0),  # two blocks
        (1000, 4, 64, 7, 1),  # x 16 bytes past a 128-byte line: a slice of a larger tensor
        (4099, 128, 1024, 11, 0),  # a row count that no piece divides
        (4096, 128, 1024, 1, 0),  # P = 1
    ],
)
def test_staging_probes_k6_k7_k8(cuda, rng, rows, W, B, P, offset):
    """The probes' shapes and odd ones, exact on random data, with NaN rows
    just past the input in the same allocation; K6 and K7 by the rule's
    plan through the wrappers, then by plans whose rings are refilled
    (uncounted launches)."""
    full = rng.standard_normal((offset + rows + P - 1 + 8, W)).astype(np.float32)
    full[offset + rows + P - 1 :] = np.nan
    x = torch.from_numpy(full).to(cuda)[offset : offset + rows + P - 1]
    assert x.data_ptr() % 128 == 16 * offset % 128
    counts = [w.launches for w in (tsp.staged_add_one, tsp.staged_window_double, tsp.staged_shift_sum)]
    assert torch.equal(tsp.staged_add_one(x[:rows], B), tsp.staged_add_one_plain(x[:rows]))
    assert torch.equal(tsp.staged_window_double(x, B, P), tsp.staged_window_double_plain(x, P))
    small = x[: min(rows, 1024) + P - 1]
    assert torch.equal(tsp.staged_shift_sum(small, P), tsp.staged_shift_sum_plain(small, P))
    torch.cuda.synchronize()
    assert [w.launches for w in (tsp.staged_add_one, tsp.staged_window_double, tsp.staged_shift_sum)] == [
        c + 1 for c in counts]
    for op, xin, plain in ((0, x[:rows], tsp.staged_add_one_plain(x[:rows])),
                           (1, x, tsp.staged_window_double_plain(x, P))):
        rule = tsp.staging_plan(rows, W, *tsp.windows(op, rows, B, P), tcf.sm_count(0))
        for plan in (rule, rule._replace(stages=rule.groups), rule._replace(piece=256, stages=4, groups=2),
                     rule._replace(piece=256, stages=8, groups=8), rule._replace(piece=128, stages=1, groups=1)):
            assert torch.equal(tsp.launch(op, xin, B, P, plan), plain), (op, plan)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="multiple of 4"):
        tsp.staged_add_one(torch.zeros(8, 6, device=cuda))


@pytest.mark.parametrize(
    "rows,W,P,offset",
    [
        (1024, 128, 11, 0),  # the probe's shape
        (200_003, 128, 11, 0),  # past one window a block: the ring refills
        (100, 128, 11, 0),  # fewer rows than SMs
        (1, 4, 1, 0),  # one row
        (1024, 4096, 11, 0),  # wide rows: four column tiles, a copy a row
        (1024, 4, 11, 0),
        (1024, 128, 1, 0),  # P = 1, 33: the run-time P loop
        (1024, 128, 33, 0),
        (1000, 36, 11, 1),  # x 16 bytes past a 128-byte line: a slice of a larger tensor
        (777, 4100, 33, 1),  # tiles of 820 floats, the last narrower
        (1, 4000, 300, 0),  # 42 tiles of 96 floats: 24 threads issue a window's row copies
    ],
)
def test_shift_sum_k8(cuda, rng, rows, W, P, offset):
    """K8 exact against its plain version, with NaN rows just past the input
    in the same allocation: the wrapper by the rule's plan, then forced
    plans (uncounted launches): runs of one, three and 40 rows, so that
    the ring refills, one, three and seven groups."""
    full = rng.standard_normal((offset + rows + P - 1 + 8, W)).astype(np.float32)
    full[offset + rows + P - 1 :] = np.nan
    x = torch.from_numpy(full).to(cuda)[offset : offset + rows + P - 1]
    assert x.data_ptr() % 128 == 16 * offset % 128
    plain = tsp.staged_shift_sum_plain(x, P)
    before = tsp.staged_shift_sum.launches
    assert torch.equal(tsp.staged_shift_sum(x, P), plain)
    torch.cuda.synchronize()
    assert tsp.staged_shift_sum.launches == before + 1
    sms = tcf.sm_count(0)
    forced = [{"run_rows": 1}, {"run_rows": 3, "groups": 3}, {"groups": 1}, {"run_rows": 40, "groups": 7}]
    for kw in forced:
        plan = tsp.shift_sum_plan(rows, W, P, sms, **kw)
        assert torch.equal(tsp.launch_shift_sum(x, P, plan), plain), plan
    torch.cuda.synchronize()
    assert tsp.staged_shift_sum.launches == before + 1


def test_staging_wrappers_make_no_size_query_after_the_first_call(cuda, rng, monkeypatch):
    """K6's, K7's and K8's plans and shared memory are worked out once a
    shape and card: after the first call no size, shared-memory or SM query
    is made (counting stand-ins over the library's size functions and the
    device properties).  The C side's shared memory is the plan's."""
    from tpusdr_torch.kernels import build

    lib = build.library()
    plan = tsp.staging_plan(4096, 128, 1024, 10, tcf.sm_count(0))
    assert lib.tpusdr_staging_smem(plan.piece, plan.stages) == tsp.staging_smem(plan)
    for rows, W, P, kw in ((1024, 128, 11, {}), (200_003, 128, 11, {}), (777, 4100, 33, {}),
                           (50, 8, 3, {"run_rows": 7})):
        k8 = tsp.shift_sum_plan(rows, W, P, tcf.sm_count(0), **kw)
        assert lib.tpusdr_shift_sum_smem(rows, P, k8.runs, k8.tile, k8.stages) == tsp.shift_sum_smem(rows, P, k8)
    queries = []
    for name in ("tpusdr_staging_smem", "tpusdr_shift_sum_smem", "tpusdr_max_smem_optin",
                 "tpusdr_copy_floor_resident"):
        real = getattr(lib, name)
        monkeypatch.setattr(lib, name, lambda *a, real=real, name=name: queries.append(name) or real(*a))
    props = torch.cuda.get_device_properties
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda *a, **k: queries.append("props") or props(*a, **k))
    x = torch.from_numpy(rng.standard_normal((3006, 60)).astype(np.float32)).to(cuda)  # a shape no other test takes
    tsp.staged_add_one(x[:2999], 100), tsp.staged_window_double(x, 100, 8), tsp.staged_shift_sum(x, 8)
    first = len(queries)
    for _ in range(3):
        assert torch.equal(tsp.staged_add_one(x[:2999], 100), x[:2999] + 1.0)
        assert torch.equal(tsp.staged_window_double(x, 100, 8), 2.0 * x[:2999])
        assert torch.equal(tsp.staged_shift_sum(x, 8), tsp.staged_shift_sum_plain(x, 8))
    torch.cuda.synchronize()
    assert len(queries) == first, queries[first:]


# -- queues and checkpoints on the card ---------------------------------------------------


def test_runner_on_a_queue_stream_equals_the_default_stream(cuda):
    """``StreamRunner(queue=...)`` issues steps, fetches and events on the
    queue's own stream; the audio equals the default stream's bit for bit."""
    ticks = am_ticks(500000, 20e6, 1.2e6, 4)
    q = queues.get_queue_registry().create("test-queue", {"queueType": "cuda", "cudaDevice": 0})
    assert q.stream is not None and q.stream != torch.cuda.default_stream(cuda)
    outs = []
    for queue in (None, "test-queue"):
        chain, _ = receiver.am_receiver(20e6, 1.2e6, input_format="int8", fir_mode="pallas", fold_shift=False)
        sink = CollectSink()
        runner = StreamRunner(chain.to(cuda), queue=queue)
        assert runner.device == cuda
        _, stats = runner.run(iter(ticks), sink)
        assert stats.blocks == 4
        outs.append(sink.result())
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="out of range"):
        queues.QueueRegistry().create("x", {"queueType": "cuda", "cudaDevice": torch.cuda.device_count()})


def test_checkpoint_round_trip_on_the_card(cuda, rng, tmp_path):
    chain, _ = receiver.fm_receiver(2e6, 300e3, receiver.WBFM)
    chain.to(cuda)
    z = fm_tone(rng, 4 * 40000, 2e6, 300e3, 75e3)
    ticks = [torch.from_numpy(z[i * 40000 : (i + 1) * 40000]).to(cuda) for i in range(4)]
    state, want = chain.init_state(device=cuda), []
    for i, x in enumerate(ticks):
        if i == 2:
            save_state(str(tmp_path / "s.npz"), state)
        state, y = chain.apply(state, x)
        want.append(y)
    resumed = load_state(str(tmp_path / "s.npz"), chain.init_state(device=cuda))
    phase = resumed["shiftfir"]["phase"]
    assert resumed["shiftfir"]["tail"].device == cuda and phase.device == cuda and osc.is_phase(phase)
    for x, ref in zip(ticks[2:], want[2:]):
        resumed, y = chain.apply(resumed, x)
        assert torch.equal(y, ref)


@pytest.mark.parametrize("m", [8, 16, 64])
def test_channelizer_on_the_card_matches_cpu(cuda, rng, m):
    """The channelizer op over two ticks: outputs within 1e-5 of peak of
    the CPU's, carries equal."""
    plan = tchan.make_plan(tchan.design_prototype(m), m, m * 4096)
    gs, cs = tchan.channelize_init(plan, device=cuda), tchan.channelize_init(plan)
    for _ in range(2):
        z = crandn(rng, "cpu", m * 4096)
        gs, gy = tchan.channelize_apply(gs, z.to(cuda), plan, channel_major=True)
        cs, cy = tchan.channelize_apply(cs, z, plan, channel_major=True)
        assert gy.shape == (m, 4096)
        close_to_peak(gy, cy)
        assert torch.equal(gs.cpu(), cs)


@pytest.mark.parametrize("fs,m,audio,tick,n_out", [(20.48e6, 64, 16000.0, 2_096_640, 1_638),
                                                     (20e6, 100, 48000.0, 1_280_000, 3_072)])
def test_channel_bank_on_the_card_matches_cpu(cuda, fs, m, audio, tick, n_out):
    """fm_channel_bank over 3 ticks of two FM stations (channels 2 and 61)
    through a CapturedStep (eager, captured, replayed): the stations' audio
    within -60 dB of the CPU path.  A batch must not reach a single-stream
    kernel: at (20.48 Msps, 64 channels, 16 kHz) the resampler is 1/20, a
    decimating FIR, and nothing launches; at the bank100.capture cell's
    (20 Msps, 100 channels, 48 kHz) the 6/25 resampler runs its kernel
    once a tick over the 100 rows, and nothing else launches.  Channels with
    no station hold only the prototype's leakage, whose phase is rounding,
    so their audio is not compared."""
    cpu_chain, info = multichannel.fm_channel_bank(fs, m, audio)
    gpu_chain = copy.deepcopy(cpu_chain).to(cuda)
    step = CapturedStep(gpu_chain)
    assert tick == cpu_chain.granule * (tick // cpu_chain.granule)
    ticks = bank_ticks(3, tick, fs=fs, m=m)
    gs, cs = gpu_chain.init_state(device=cuda), cpu_chain.init_state()
    kernels.reset_launch_counts()
    for blk in ticks:
        gs, gy = step(gs, torch.from_numpy(blk).to(cuda))
        cs, cy = cpu_chain.apply(cs, torch.from_numpy(blk))
        assert gy.shape == cy.shape == (m, n_out)
        assert err_db(cy.numpy()[[2, 61]], gy.cpu().numpy()[[2, 61]]) <= -60.0
    torch.cuda.synchronize()
    assert step.eager_ticks == 1 and step.captures == 1
    resampled = 3 if info["resampler"][0] > 1 else 0
    assert {w.__name__: w.launches for w in kernels.WRAPPERS if w.launches} == (
        {"resample_poly": resampled} if resampled else {})
    assert trp.resample_poly.rows == resampled * m


# -- the captured step: one CUDA graph a tick ---------------------------------------------


def wbfm_graph_spec(fs, offset):
    """The WBFM receiver as a reference-schema JSON graph: Cosine x
    Multiply -> Fir (K4, the receiver's own taps) -> QuadDemod -> Deemphasis
    -> Resampler, the tick in through an exposed port."""
    chain, _ = receiver.fm_receiver(fs, offset, receiver.WBFM)
    fir = chain.get_block("shiftfir")
    rate = fs / fir.decimation
    return {
        "nodes": {
            "osc": {"type": "Cosine", "sampleRate": fs, "frequency": -offset, "sampleType": "FloatComplex"},
            "mix": {"type": "Multiply"},
            "rf.fir": {"type": "Fir", "taps": fir.taps.tolist(), "decimation": fir.decimation, "mode": "pallas"},
            "dem": {"type": "QuadDemod", "modulation": "Fm", "sampleRate": rate, "fskDeviation": 200e3},
            "de": {"type": "Deemphasis", "sampleRate": rate, "tau": 75e-6},
            "rs": {"type": "Resampler", "up": 3, "down": 25},
        },
        "connections": [
            {"source": "osc", "sink": "mix", "sinkPort": 1},
            {"source": "mix", "sink": "rf.fir"},
            {"source": "rf.fir", "sink": "dem"},
            {"source": "dem", "sink": "de"},
            {"source": "de", "sink": "rs"},
        ],
        "inputPorts": [{"exposedPort": 0, "mapped": {"node": "mix", "port": 0}}],
        "outputPort": "rs",
    }


def wbfm_graph(fs, offset):
    from tpusdr_torch.graph.graph import build_graph

    return build_graph(wbfm_graph_spec(fs, offset))


def wbfm_app_spec(wav, n_ticks, queue):
    """The WBFM 20 Msps JSON graph as an app: a Synth source of the 1 kHz
    tone at +2.5 MHz into the mixer, the oscillator on a named queue, the
    audio into a WavWriter."""
    spec = wbfm_graph_spec(20e6, 2.5e6)
    del spec["inputPorts"], spec["outputPort"]
    spec["nodes"]["src"] = {"type": "Synth", "kind": "fm", "sampleRate": 20e6, "audioHz": 1000.0,
                            "deviation": 75e3, "carrierOffset": 2.5e6, "numBlocks": n_ticks}
    spec["nodes"]["osc"]["commandQueueId"] = queue
    spec["nodes"]["wav"] = {"type": "WavWriter", "path": str(wav), "sampleRate": 48000}
    spec["connections"] += [{"source": "src", "sink": "mix"}, {"source": "rs", "sink": "wav"}]
    return spec


def bank_ticks(n_ticks, tick, fs=20.48e6, m=64):
    t = np.arange(n_ticks * tick) / fs
    z = sum(0.5 * np.exp(1j * (2 * np.pi * k * fs / m * t + 2 * np.pi * 75e3 * np.cumsum(np.sin(2 * np.pi * fa * t)) / fs))
            for k, fa in ((2, 700.0), (61, 1200.0)))
    return list(z.astype(np.complex64).reshape(n_ticks, tick))


class Path(NamedTuple):
    """A main path on the card: its block, host ticks and audio rate, the
    kernels it launches a tick, the tones its audio carries as (row or
    None, Hz, amplitude or None, least SNR dB, a tone of another row that
    must stay under a tenth of this one's amplitude, or None), and a
    function making another path that computes the same audio, or None."""

    block: object
    ticks: list
    rate: float
    per_tick: dict
    tones: list
    twin: object = None


WBFM_TONE = (None, 1000.0, 0.375 * 0.905, 60.0, None)  # deviation/channel width x de-emphasis gain at 1 kHz


def wbfm_20msps():
    return receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)[0]


def wbfm_ticks(rng, n_ticks=8):
    return np.split(fm_tone(rng, n_ticks * 1_280_000, 20e6, 2.5e6, 75e3), n_ticks)


#: label -> rng -> Path: the main paths the runner captures, 8 ticks each
#: (AM 16: over 8 the DC block's settling is still in the last two thirds,
#: 59.4 dB on the CPU against 60.7 over 16)
CAPTURED = {
    "wbfm default": lambda rng: Path(wbfm_20msps(), wbfm_ticks(rng), 48000.0,
                                     {"banded_fir": 1, "resample_poly": 1}, [WBFM_TONE]),
    "wbfm fused": lambda rng: Path(receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM, use_fused=True)[0],
                                   wbfm_ticks(rng), 48000.0, {"banded_fir_prelude": 1, "resample_poly": 1},
                                   [WBFM_TONE], wbfm_20msps),
    # NBFM's 5 kHz deviation against this noise: about 50 dB on the CPU
    "nbfm fused": lambda rng: Path(receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)[0],
                                   np.split(fm_tone(rng, 8 * 1_320_000, 2e6, 100e3, 5e3), 8), 48000.0,
                                   {"fused_fm_demod": 1, "resample_poly": 1}, [(None, 1000.0, None, 45.0, None)]),
    "am k4": lambda rng: Path(receiver.am_receiver(20e6, 1.2e6, input_format="int8", fir_mode="pallas",
                                                   fold_shift=False)[0],
                              am_ticks(1_280_000, 20e6, 1.2e6, 16), 48000.0, {"fir_decim": 2, "resample_poly": 1},
                              [(None, 700.0, 0.25, 60.0, None)],  # carrier 0.5 x depth 0.5
                              lambda: receiver.am_receiver(20e6, 1.2e6, input_format="int8")[0]),
    "json graph": lambda rng: Path(wbfm_graph(20e6, 2.5e6), wbfm_ticks(rng), 48000.0,
                                   {"fir_decim": 1, "resample_poly": 1}, [WBFM_TONE], wbfm_20msps),
    "bank": lambda rng: Path(multichannel.fm_channel_bank(20.48e6, 64, 16000.0)[0], bank_ticks(8, 2_096_640), 16000.0,
                             {}, [(2, 700.0, None, 30.0, None), (61, 1200.0, None, 30.0, 700.0)]),
}


def runner_audio(block, ticks, capture, **kw):
    """Audio, launch counts and the runner of one StreamRunner pass."""
    sink = CollectSink()
    runner = StreamRunner(block, capture=capture, **kw)
    kernels.reset_launch_counts()
    state, stats = runner.run(iter(ticks), sink)
    torch.cuda.synchronize()
    return sink.result(), {w.__name__: w.launches for w in kernels.WRAPPERS}, runner, state


@pytest.mark.parametrize("label", list(CAPTURED))
def test_captured_step_equals_eager(cuda, rng, label):
    """Eight ticks and a short last one through the runner, captured (one
    graph replay a tick from the second tick on; the short block runs
    eager) against eager: the audio bit for bit, the same kernel launches
    counted, each kernel of the path as often a tick as the path launches
    it and no other, every sample owed.  The eight ticks' audio carries its
    tones (after the first third; a bank's station after the first half,
    another station's tone under a tenth of it), its first two ticks lie
    within -60 dB of the CPU's, and within -60 dB of another path that
    computes the same audio on the card."""
    path = CAPTURED[label](rng)
    block = path.block
    cpu_block = copy.deepcopy(block)
    block.to(cuda)
    ticks = path.ticks + [path.ticks[0][: len(path.ticks[0]) // 2]]
    eager, eager_counts, _, _ = runner_audio(block, ticks, False, device=cuda)
    captured, counts, runner, state = runner_audio(block, ticks, None, device=cuda)
    assert isinstance(runner._step, CapturedStep) and len(runner._step._graphs) == 1
    assert counts == eager_counts == {w.__name__: path.per_tick.get(w.__name__, 0) * len(ticks) for w in kernels.WRAPPERS}
    assert tfm.fused_fm_demod.shared_rows == 0  # a single channel never takes K3's shared form
    assert captured.shape == eager.shape and np.array_equal(captured, eager)
    assert captured.shape[-1] == sum(len(t) for t in ticks) * block.up // block.down
    assert all(leaf.device == cuda for leaf in torch.utils._pytree.tree_flatten(state)[0])
    audio = captured[..., : sum(len(t) for t in path.ticks) * block.up // block.down]
    for row, hz, amp, snr_db, other_hz in path.tones:
        x = audio[len(audio) // 3 :] if row is None else audio[row][audio.shape[-1] // 2 :]
        got_amp, got_snr = tone_amp_snr(x, path.rate, hz)
        assert got_snr > snr_db and (amp is None or abs(got_amp - amp) < 0.02), (row, got_amp, got_snr)
        if other_hz is not None:
            assert tone_amp_snr(x, path.rate, other_hz)[0] < 0.1 * got_amp
    state, ref = cpu_block.init_state(), []
    for t in path.ticks[:2]:
        state, y = cpu_block.apply(state, torch.from_numpy(t))
        ref.append(y.numpy())
    ref = np.concatenate(ref, axis=-1)
    rows = [row for row, *_ in path.tones if row is not None]  # a bank: its stations' channels
    pick = (lambda a: a[rows]) if rows else (lambda a: a)
    assert err_db(pick(ref), pick(audio[..., : ref.shape[-1]])) <= -60.0
    if path.twin is not None:
        twin = path.twin().to(cuda)
        state, outs = twin.init_state(device=cuda), []
        for t in path.ticks:
            state, y = twin.apply(state, torch.from_numpy(t).to(cuda))
            outs.append(y)
        assert err_db(torch.cat(outs, dim=-1).cpu().numpy(), audio) <= -60.0


#: label -> (the chain, one tick of its input, the shortest operand of a
#: concatenation in front of its kernel): K3 in the NBFM 2 Msps front end,
#: the AM chain's two K4 stages (the second's input is the tick over 250)
#: and the JSON graph's Fir (K4)
UNJOINED = {
    "nbfm fused": (lambda: receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)[0],
                   lambda rng: fm_tone(rng, 1_320_000, 2e6, 100e3, 5e3), 1_320_000),
    "am k4": (lambda: receiver.am_receiver(20e6, 1.2e6, input_format="int8", fir_mode="pallas", fold_shift=False)[0],
              lambda rng: am_ticks(1_280_000, 20e6, 1.2e6, 1)[0], 1_280_000 // 250),
    "json graph": (lambda: wbfm_graph(20e6, 2.5e6), lambda rng: fm_tone(rng, 1_280_000, 20e6, 2.5e6, 75e3), 1_280_000),
}


@pytest.mark.parametrize("label", list(UNJOINED))
def test_kernels_read_the_tick_where_it_lies(cuda, rng, monkeypatch, label):
    """A warm tick of the path on the card joins no operand as long as its
    kernel's input: K3 and K4 read [carry, tick] through two pointers.  The
    JSON graph's Fir as it was before the second pointer (the tick joined
    behind its carry, then the kernel) shows the one such concatenation."""
    import types

    build, draw, min_len = UNJOINED[label]
    chain = build().to(cuda)
    x = torch.from_numpy(draw(rng)).to(cuda)
    state = chain.init_state(device=cuda)
    for _ in range(2):
        state, _ = chain.apply(state, x)
    cats, real_cat = [], torch.cat

    def spy(tensors, *args, **kw):
        lengths = [t.shape[-1] for t in tensors if t.dim()]
        if max(lengths, default=0) >= min_len:
            cats.append(lengths)
        return real_cat(tensors, *args, **kw)

    monkeypatch.setattr(torch, "cat", spy)
    chain.apply(state, x)
    assert cats == []
    if label == "json graph":
        fir = chain.get_block("rf.fir")
        T = fir.taps.shape[-1]

        def cat_then_kernel(self, carry, x):
            ext = torch.cat([carry, x])
            return ext[ext.shape[-1] - (T - 1) :].clone(), tfp.fir_decim(ext, self.taps, self.decimation)

        monkeypatch.setattr(fir, "_apply_pallas", types.MethodType(cat_then_kernel, fir))
        chain.apply(state, x)
        assert len(cats) == 1, cats


def test_update_parameters_recaptures(cuda, rng):
    """A new offset halfway through (WBFM): the runner drops its graphs,
    the next tick runs eager and the one after is captured anew, one graph;
    the audio equals an eager run with the same update, bit for bit."""
    ticks = np.split(fm_tone(rng, 8 * 40000, 2e6, 300e3, 75e3), 8)
    outs = []
    for capture in (False, None):
        chain, _ = receiver.fm_receiver(2e6, 300e3, receiver.WBFM)
        sink = CollectSink()
        runner = StreamRunner(chain.to(cuda), capture=capture)
        state, _ = runner.run(iter(ticks[:4]), sink)
        first = runner._step
        runner.update_parameters("shiftfir", frequency=-310e3)
        assert runner._step is not first
        runner.run(iter(ticks[4:]), sink, state=state)
        outs.append(sink.result())
        assert capture is False or len(runner._step._graphs) == 1
    assert np.array_equal(outs[0], outs[1])


def test_merged_runner_captures_on_two_queues(cuda, rng):
    """Two JSON graphs on two queues, captured on each queue's stream,
    against eager steps, against both captured on one queue and against
    each graph alone on its queue: the outputs bit for bit, K4 and the
    resampler's kernel counted once a tick each.  Each output is cloned on
    its queue's stream: it is the graph's static buffer, which the next
    replay there overwrites."""
    reg = queues.get_queue_registry()
    qs = {"a": reg.create("capture-a", {"queueType": "cuda"}), "b": reg.create("capture-b", {"queueType": "cuda"})}
    ticks = {n: [torch.from_numpy(t).to(cuda) for t in np.split(fm_tone(rng, 6 * 40000, 2e6, 300e3, 75e3), 6)]
             for n in qs}

    def drive(queue, names, capture=None):
        runner = queues.MergedRunner({n: wbfm_graph(2e6, 300e3).to(cuda) for n in names}, queue=queue, capture=capture)
        states, got = runner.init_state(), {n: [] for n in names}
        kernels.reset_launch_counts()
        for i in range(6):
            states, ys = runner.step(states, {n: ticks[n][i] for n in names})
            for n in names:
                with runner.queues[n].activate():
                    got[n].append(ys[n].clone())
        runner.synchronize()
        assert (kernels.fir_decim.launches, trp.resample_poly.launches) == (6 * len(names), 6 * len(names))
        return {n: torch.cat(got[n]) for n in names}

    two, eager, one = drive(qs, list(qs)), drive(qs, list(qs), capture=False), drive(qs["a"], list(qs))
    for n in qs:
        alone = drive(qs[n], [n])[n]
        assert torch.equal(two[n], eager[n]) and torch.equal(two[n], one[n]) and torch.equal(two[n], alone)


def test_json_app_runs_on_a_named_queue(cuda, tmp_path):
    """``compile_app(...).run()`` of the WBFM 20 Msps JSON app (its Synth
    source and WavWriter), the oscillator on a named queue, 8 ticks of
    1,280,000: the tick and granule, every block and sample of the source,
    K4 and the resampler's kernel once a tick and no other, the tone at
    0.34 and SNR > 60 dB, the same app on the CPU within -60 dB over two
    ticks, the fm_receiver on the same blocks within -60 dB; stopped after
    4 ticks, checkpointed and resumed by a fresh app: the audio bit for
    bit."""
    import itertools

    from tpusdr_torch.graph.app import compile_app

    queues.get_queue_registry().create("app-q", {"queueType": "cuda", "cudaDevice": 0})
    tick, n = 1_280_000, 8

    def app(name, blocks=n, **kw):
        return compile_app(wbfm_app_spec(tmp_path / f"{name}.wav", blocks, "app-q"), tick=tick, **kw)

    whole = app("whole", queue="app-q")
    assert whole.tick == tick and whole.graph.granule == 1250
    kernels.reset_launch_counts()
    stats = whole.run()
    torch.cuda.synchronize()
    assert {w.__name__: w.launches for w in kernels.WRAPPERS if w.launches} == {"fir_decim": n, "resample_poly": n}
    assert stats.blocks == n and sum(len(b) for b in whole.source_factory(tick)) == n * tick
    audio, fs = read_wav(tmp_path / "whole.wav")
    amp, snr = tone_amp_snr(audio[len(audio) // 3 :], fs)
    assert abs(amp - 0.375 * 0.905) < 0.02 and snr > 60.0, (amp, snr)
    app("cpu", 2, device="cpu").run()
    ref, _ = read_wav(tmp_path / "cpu.wav")
    assert err_db(ref, audio[: len(ref)]) <= -60.0
    chain = wbfm_20msps().to(cuda)
    state, outs = chain.init_state(device=cuda), []
    for b in whole.source_factory(tick):
        state, y = chain.apply(state, torch.from_numpy(b).to(cuda))
        outs.append(y)
    want = torch.cat(outs).cpu().numpy()
    assert len(audio) == len(want) and err_db(want, audio) <= -60.0
    first = app("first", queue="app-q")
    first.run(max_blocks=n // 2)
    save_state(str(tmp_path / "state.npz"), first.state)
    second = app("second", queue="app-q")
    source = second.source_factory
    second.source_factory = lambda t: itertools.islice(iter(source(t)), n // 2, None)
    second.run(state=load_state(str(tmp_path / "state.npz"), second.runner.init_state()))
    joined = np.concatenate([read_wav(tmp_path / "first.wav")[0], read_wav(tmp_path / "second.wav")[0]])
    assert np.array_equal(joined, audio)


def test_k3_pointer_form_near_the_wrap(cuda, rng):
    """K3 reads the carried phase through its pointer, at phases within
    1,000 increments of 2^32 (and one a few counts short of it), with and
    without a by-value offset: within 1e-5 * gain of its plain version and
    bit for bit its by-value form."""
    T, D, M = 728, 66, 20_000
    h = taps(T, False, cuda)
    n = (T - 1) + (M + 1) * D
    z = torch.from_numpy(fm_tone(rng, n, 2e6, 100e3, 5e3)).to(cuda)
    inc = osc.freq_to_inc_u32(-100e3, 2e6)
    for ph in ((-999 * inc) % 2**32, (-1 * inc) % 2**32, 2**32 - 3):
        for off in (0, 5 * inc % 2**32):
            got = tfm.fused_fm_demod(z, h, D, inc, osc.as_phase((ph - off) % 2**32, cuda), 0.32, phase_offset=off)
            by_value = tfm.fused_fm_demod(z, h, D, inc, ph, 0.32)
            ref = tfm.fused_fm_demod_plain(z, h, D, inc, ph, 0.32, M)
            assert torch.equal(got, by_value)
            np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5 * 0.32)


# -- the sharded streams (tpusdr_torch.parallel) on the card ---------------------------------

#: label -> (rng -> (block, three host ticks), shards, stagewise, the kernel the
#: path launches): the sharded paths at three ticks
SHARDED = {
    "wbfm stagewise": (lambda rng: (wbfm_20msps(), wbfm_ticks(rng, 3)), 8, True, "banded_fir"),
    "wbfm chain-wide": (lambda rng: (wbfm_20msps(), wbfm_ticks(rng, 3)), 8, False, "banded_fir"),
    # K2's granule: ticks of 2,560,000 over two shards
    "wbfm fused": (lambda rng: (receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM, use_fused=True)[0],
                                np.split(fm_tone(rng, 3 * 2_560_000, 20e6, 2.5e6, 75e3), 3)), 2, True,
                   "banded_fir_prelude"),
    "nbfm fused": (lambda rng: (receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)[0],
                                np.split(fm_tone(rng, 3 * 1_320_000, 2e6, 100e3, 5e3), 3)), 8, True, "fused_fm_demod"),
    "json graph": (lambda rng: (wbfm_graph(20e6, 2.5e6), wbfm_ticks(rng, 3)), 8, False, "fir_decim"),
}


def sharded_audio(obj, ticks, device):
    """Three ticks through ``obj.step``, each output cloned before the next
    step, and the launch counts of the run."""
    kernels.reset_launch_counts()
    carry, outs = obj.init_carry(), []
    for blk in ticks:
        carry, y = obj.step(carry, torch.from_numpy(blk).to(device))
        outs.append(y.clone())
    out = torch.cat(outs, dim=-1).cpu().numpy()
    return out, {w.__name__: w.launches for w in kernels.WRAPPERS}


@pytest.mark.parametrize("label", list(SHARDED))
def test_sharded_stream_on_the_card(cuda, rng, label):
    """A TimeShardedStream over LocalMesh(8) (K2: 2) on the card, captured
    (one graph a tick from the second tick on) and eager: bit for bit the same,
    the path's kernel and the resampler's launched once a shard a tick;
    the audio within -60 dB of the same stream on the CPU and within -100
    dB of the unsharded chain on the card, its tone (after the first third)
    at the unsharded chain's amplitude (WBFM 0.34) and SNR > 60 dB (NBFM
    45)."""
    from tpusdr_torch.parallel import TimeShardedStream, make_mesh

    build, shards, stagewise, wrapper = SHARDED[label]
    block, ticks = build(rng)
    cpu_block = copy.deepcopy(block)
    captured_obj = TimeShardedStream(block, make_mesh(shards), stagewise=stagewise)
    assert captured_obj.capture and captured_obj.mesh.device.type == "cuda"
    captured, counts = sharded_audio(captured_obj, ticks, cuda)
    eager, eager_counts = sharded_audio(TimeShardedStream(block, make_mesh(shards), stagewise=stagewise,
                                                          capture=False), ticks, cuda)
    assert np.array_equal(captured, eager) and counts == eager_counts
    assert counts[wrapper] == shards * len(ticks)
    assert sum(v for k, v in counts.items() if k != "resample_poly") == counts[wrapper]
    assert counts["resample_poly"] == shards * len(ticks)  # the audio stage, sharded as the rest
    assert len(next(iter(captured_obj._step_cache.values()))._graphs) == 1
    on_cpu, _ = sharded_audio(TimeShardedStream(cpu_block, make_mesh(shards, device="cpu"), stagewise=stagewise),
                              ticks, "cpu")
    assert err_db(on_cpu, captured) <= -60.0
    state, outs = block.init_state(device=cuda), []
    for blk in ticks:
        state, y = block.apply(state, torch.from_numpy(blk).to(cuda))
        outs.append(y)
    unsharded = torch.cat(outs).cpu().numpy()
    assert np.array_equal(unsharded, captured) or err_db(unsharded, captured) <= -100.0
    amp, snr = tone_amp_snr(captured[len(captured) // 3 :], 48000.0)
    assert abs(amp - tone_amp_snr(unsharded[len(unsharded) // 3 :], 48000.0)[0]) < 0.02
    nbfm = label == "nbfm fused"  # its 5 kHz deviation against this noise: about 50 dB on the CPU
    assert snr > (45.0 if nbfm else 60.0) and (nbfm or abs(amp - WBFM_TONE[2]) < 0.02), (amp, snr)


@pytest.mark.parametrize("shards", [4, 5])
def test_sharded_bank_on_the_card(cuda, shards):
    """The 64-channel bank over LocalMesh(4) and (5) (65 channels, one
    dead) on the card, captured (one graph) and eager bit for bit, no
    kernel launched; the stations' audio within -60 dB of the same bank on
    the CPU, each at SNR > 30 dB over the second half, the other station's
    tone under a tenth of it."""
    from tpusdr_torch.graph.chain import Chain
    from tpusdr_torch.parallel import ChannelShardedBank, make_mesh

    chain, _ = multichannel.fm_channel_bank(20.48e6, 64, 16000.0)
    cpu_chain = copy.deepcopy(chain)
    ticks = bank_ticks(3, 2_096_640)

    def make(blocks, device, capture=None):
        return ChannelShardedBank(blocks[0][1], Chain(blocks[1:]), make_mesh(shards, device=device), capture=capture)

    bank = make(chain.blocks, None)
    captured, counts = sharded_audio(bank, ticks, cuda)
    eager, _ = sharded_audio(make(chain.blocks, None, capture=False), ticks, cuda)
    assert np.array_equal(captured, eager) and not any(counts.values())
    assert bank.capture and len(next(iter(bank._step_cache.values()))._graphs) == 1
    on_cpu, _ = sharded_audio(make(cpu_chain.blocks, "cpu"), ticks, "cpu")
    assert captured.shape == on_cpu.shape == (64, 3 * 2_096_640 // 1280)
    assert err_db(on_cpu[[2, 61]], captured[[2, 61]]) <= -60.0
    for k, hz, other in ((2, 700.0, 1200.0), (61, 1200.0, 700.0)):
        x = captured[k][captured.shape[-1] // 2 :]
        amp, snr = tone_amp_snr(x, 16000.0, hz)
        assert snr > 30.0 and tone_amp_snr(x, 16000.0, other)[0] < 0.1 * amp, (k, amp, snr)


@pytest.mark.parametrize(
    "kernel,T,D,M,plan",
    [
        ("decim_fir", 546, 50, 3_211, ("taps", 8)),  # WBFM 20 Msps, a shard of 8, stagewise halo 550
        ("decim_fir", 546, 50, 4_000, ("taps", 8)),  # chain-wide halo 40,000
        ("fm_fused", 728, 66, 2_513, ("taps", 8)),  # NBFM 2 Msps, a shard of 8, stagewise halo 858
        ("fir_decim", 546, 50, 4_000, ("taps", 32)),  # the WBFM JSON graph, a shard of 8, chain-wide
    ],
)
def test_kernels_at_the_shard_shapes(cuda, rng, kernel, T, D, M, plan):
    """K1, K3 and K4 at the shapes a shard of 8 gives them, through their
    wrappers with the plan their rule picks (the other inner loop than the
    whole tick's), against the plain versions; K3 with a shard's phase
    just short of the 2^32 wrap, through the pointer."""
    H = (T - 1) + (D if kernel == "fm_fused" else 0)
    if kernel == "fm_fused":
        assert tuple(tfm.fm_fused_plan(T, D, M))[:2] == plan
        h = taps(T, False, cuda)
        z = torch.from_numpy(fm_tone(rng, (T - 1) + (M + 1) * D, 2e6, 100e3, 5e3)).to(cuda)
        inc = osc.freq_to_inc_u32(-100e3, 2e6)
        got = tfm.fused_fm_demod(z[H:], h, D, inc, osc.as_phase(2**32 - 256, cuda), 0.32, history=z[:H])
        ref = tfm.fused_fm_demod_plain(z, h, D, inc, 2**32 - 256, 0.32, M)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5 * 0.32)
        return
    hist, x = crandn(rng, cuda, H), crandn(rng, cuda, M * D)
    if kernel == "decim_fir":
        assert tuple(tfb.decim_fir_plan(T, D, True, M))[:2] == plan
        h = taps(T, True, cuda)
        close_to_peak(tfb.banded_fir(x, h, D, history=hist), tfb.decim_fir_plain(hist, x, h, D, 0, M))
    else:
        assert tuple(tfp.fir_decim_plan(T, D, M))[:2] == plan
        h = taps(T, False, cuda)
        close_to_peak(tfp.fir_decim(x, h, D, history=hist), tfp.fir_decim_plain(x, h, D, M, hist))


# -- host IO into the WBFM 20 Msps receiver: --native and the shim loop --------


def int8_words(z):
    """Complex samples -> int8 IQ (full scale 127) as packed int16 words."""
    inter = np.empty(2 * len(z), np.float32)
    inter[0::2], inter[1::2] = z.real, z.imag
    return np.clip(np.round(inter * 127.0), -128, 127).astype(np.int8).view(np.int16)


def tone_amp_snr(x, fs, f=1000.0):
    t = np.arange(len(x)) / fs
    b = np.stack([np.sin(2 * np.pi * f * t), np.cos(2 * np.pi * f * t)], 1)
    c, *_ = np.linalg.lstsq(b, x.astype(np.float64), rcond=None)
    fit = b @ c
    r = x - fit - (x - fit).mean()
    return float(np.hypot(*c)), float(10 * np.log10((fit**2).mean() / (r**2).mean()))


def read_wav(path):
    import wave

    with wave.open(str(path)) as w:
        fs = w.getframerate()
        x = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.float32) / 32767
    return x, fs


#: mod -> (offset, whole ticks of the capture, its int8 words, the tone in
#: Hz and its amplitude, the RF kernel's launches a block): AM's two RF
#: stages are K1 too; over 16 ticks its DC block has settled in the first
#: third
CLI_CAPTURES = {
    "wbfm": (2.5e6, 3, lambda rng, n: int8_words(fm_tone(rng, n, 20e6, 2.5e6, 75e3)), 1000.0, 0.375 * 0.905, 1),
    "am": (1.2e6, 16, lambda rng, n: np.concatenate(am_ticks(1_280_000, 20e6, 1.2e6, 17))[:n], 700.0, 0.25, 2),
}


@pytest.mark.parametrize("mod", list(CLI_CAPTURES))
def test_native_equals_the_file_path_on_the_card(cuda, rng, tmp_path, mod):
    """The receive CLI at 20 Msps on an int8 capture of whole ticks and a
    300,000-sample tail, with --native (the host library's ring) and
    without: the WAVs equal byte for byte, tail included, the tone at its
    amplitude and SNR > 60 dB after the first third; the RF kernel and the
    resampler's once a block; the first two ticks within -60 dB of the CLI
    on the CPU; the host library's stream alone reads every sample."""
    from tpusdr_torch.apps import receive
    from tpusdr_torch.io.native import NativeFileStream

    offset, n_ticks, words, hz, amp, per_block = CLI_CAPTURES[mod]
    tick, fs = 1_280_000, 20e6
    n_in = n_ticks * tick + 300_000
    capture = tmp_path / f"{mod}.iq"
    words(rng, n_in).tofile(capture)
    wavs = {}
    for label, extra in (("native", ["--native"]), ("plain", []), ("cpu", [])):
        wavs[label] = tmp_path / f"{label}.wav"
        device, duration = ("cpu", 2 * tick / fs) if label == "cpu" else ("cuda", (n_ticks + 1.5) * tick / fs)
        kernels.reset_launch_counts()
        assert receive.main(["--device", device, "--mod", mod, "--format", "int8", "--input", str(capture),
                             "--rf-rate", "20e6", "--offset", str(offset), "--tick", str(tick),
                             "--duration", str(duration), "--audio", str(wavs[label]), *extra]) == 0
        if device == "cuda":
            torch.cuda.synchronize()
            assert {w.__name__: w.launches for w in kernels.WRAPPERS if w.launches} == {
                "banded_fir": per_block * (n_ticks + 1), "resample_poly": n_ticks + 1}
    assert wavs["native"].read_bytes() == wavs["plain"].read_bytes()
    audio, wav_fs = read_wav(wavs["native"])
    assert len(audio) == n_in * 3 // 1250  # 48 kHz: the tail's audio included
    got_amp, snr = tone_amp_snr(audio[len(audio) // 3 :], wav_fs, hz)
    assert abs(got_amp - amp) < 0.02 and snr > 60.0, (got_amp, snr)
    ref, _ = read_wav(wavs["cpu"])
    assert len(ref) == 2 * tick * 3 // 1250 and err_db(ref, audio[: len(ref)]) <= -60.0
    with NativeFileStream(str(capture), tick, "int8") as stream:
        assert sum(len(words) for words in stream) == n_in


def test_digital_app_on_the_card_matches_cpu(cuda, tmp_path):
    """The digital-voice app on its synthetic source, 8 ticks of 1,048,560
    at 1 Msps: K1 once a tick, every audio sample of the whole ticks, the
    500 Hz line the spectrum's peak with over half the energy after the
    first third, the first two ticks within -60 dB of the app on the
    CPU."""
    from tpusdr_torch.apps import digital

    n_blocks, tick = 8, (1 << 20) // 120 * 120
    kernels.reset_launch_counts()
    assert digital.main(["--device", "cuda", "--duration", str((n_blocks + 0.4) * tick / 1e6),
                         "--audio", str(tmp_path / "card.wav")]) == 0
    torch.cuda.synchronize()
    assert kernels.banded_fir.launches == n_blocks
    assert digital.main(["--device", "cpu", "--duration", str(2.4 * tick / 1e6), "--audio", str(tmp_path / "cpu.wav")]) == 0
    audio, _ = read_wav(tmp_path / "card.wav")
    ref, _ = read_wav(tmp_path / "cpu.wav")
    assert len(audio) == n_blocks * tick // 120
    x = audio[len(audio) // 3 :].astype(np.float64)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    k = int(spec.argmax())
    assert abs(np.fft.rfftfreq(len(x), 120 / 1e6)[k] - 500.0) < 2.0  # the audio rate is 1e6 / 120
    assert spec[max(0, k - 3) : k + 4].sum() > 0.5 * spec.sum()
    assert err_db(ref, audio[: len(ref)]) <= -60.0


def test_channels_app_on_the_card(cuda, tmp_path):
    """The channels app at its defaults (16 channels, 5.12 Msps, 2 s) on the
    card, writing channels 2 and 13: no kernel launched (the bank's stages
    are plain ops), each station's tone at SNR > 30 dB over the second
    half, the other station's under a tenth of it."""
    from tpusdr_torch.apps import channels

    kernels.reset_launch_counts()
    assert channels.main(["--device", "cuda", "--write", "2,13", "--out-dir", str(tmp_path)]) == 0
    torch.cuda.synchronize()
    assert not any(w.launches for w in kernels.WRAPPERS)
    for k, hz, other in ((2, 700.0, 1200.0), (13, 1200.0, 700.0)):
        x, fs = read_wav(tmp_path / f"ch{k:03d}.wav")
        x = x[len(x) // 2 :]
        amp, snr = tone_amp_snr(x, fs, hz)
        assert snr > 30.0 and tone_amp_snr(x, fs, other)[0] < 0.1 * amp, (k, amp, snr)


def test_shim_loop_recaptures_after_a_retune(cuda):
    """Fake radio -> RfShim -> SocketIqSource -> the WBFM 20 Msps receiver
    on a captured runner, retuned by SdrReceiverControl.tune_radio after 4
    ticks: old-centre blocks flushed, none dropped, one recapture, the NCO
    at the station's new offset, K1 and the resampler's kernel once a tick,
    the 1 kHz tone on both sides (the first tick after the retune skipped)
    at 0.34 and SNR > 60 dB."""
    import time

    from tpusdr_torch.io.control import SdrControlClient, SdrReceiverControl
    from tpusdr_torch.io.shim import FakeSdrDriver, RfShim, Station
    from tpusdr_torch.io.sources import SocketIqSource

    tick, fs, half = 1_280_000, 20e6, 4
    chain, spec = receiver.fm_receiver(fs, 2.5e6, receiver.WBFM, input_format="int8")
    runner = StreamRunner(chain.to(cuda))
    driver = FakeSdrDriver([Station(100.1e6, "fm", audio_hz=1000.0)], block_samples=tick)
    sinks = (CollectSink(), CollectSink())
    with RfShim(driver) as shim, SdrControlClient("127.0.0.1", shim.control_port, timeout_s=60.0) as client:
        client.select_device(index=0)
        client.set_sample_rate(fs)
        client.set_frequency(97.6e6)
        src = SocketIqSource("127.0.0.1", shim.data_port, tick, "int8", pool_blocks=32, timeout_s=60.0)
        ctl = SdrReceiverControl(client, runner, 97.6e6, 100.1e6, source=src)
        client.start()
        try:
            blocks = iter(src)
            kernels.reset_launch_counts()
            state, _ = runner.run(blocks, sinks[0], max_blocks=half)
            first = runner._step
            deadline = time.time() + 60.0
            while shim.bytes_sent < (half + 2) * 2 * tick and time.time() < deadline:
                time.sleep(0.01)  # old-centre blocks in flight at the retune
            ctl.tune_radio(98.6e6)
            runner.run(blocks, sinks[1], state=state, max_blocks=half)
            torch.cuda.synchronize()
            assert src.flushed_blocks > 0 and src.dropped_blocks == 0
        finally:
            src.close()
            client.stop()
    assert runner._step is not first and len(runner._step._graphs) == 1
    assert abs(chain.get_block("shiftfir").frequency + 1.5e6) < 1.0
    assert kernels.banded_fir.launches == trp.resample_poly.launches == 2 * half
    per_tick = tick * 3 // 1250
    for audio in (sinks[0].result()[per_tick:], sinks[1].result()[per_tick:]):
        amp, snr = tone_amp_snr(audio, spec.audio_rate)
        assert abs(amp - 0.375 * 0.905) < 0.02 and snr > 60.0, (amp, snr)


def test_dist_mesh_over_nccl_in_one_process(cuda, rng, tmp_path):
    """A DistMesh over NCCL at world size 1 in this process (meeting through
    a FileStore): one WBFM 20 Msps tick through a TimeShardedStream equals a
    LocalMesh(1)'s bit for bit, K1 once."""
    import torch.distributed as dist

    from tpusdr_torch.parallel import TimeShardedStream, make_mesh
    from tpusdr_torch.parallel.mesh import DistMesh, LocalMesh

    chain = wbfm_20msps()
    x = torch.from_numpy(fm_tone(rng, 1_280_000, 20e6, 2.5e6, 75e3)).to(cuda)
    local = TimeShardedStream(chain, LocalMesh({"dev": 1}, cuda), capture=False)
    want = local.step(local.init_carry(), x)[1]
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        stream = TimeShardedStream(chain, mesh)
        kernels.reset_launch_counts()
        got = stream.step(stream.init_carry(), x)[1]
        torch.cuda.synchronize()
        assert isinstance(mesh, DistMesh) and dist.get_backend() == "nccl" and kernels.banded_fir.launches == 1
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


def test_nccl_processes_match_a_local_mesh(cuda, tmp_path):
    """Four processes, one a card, over NCCL: each reads its byte ranges (or
    its segment) of a capture and runs the time-sharded chain in both halo
    forms and the channel bank over DistMesh(4) (the ring shift, the
    all-to-all and the gather on the wire), and every rank's output equals
    a LocalMesh(4) on one card bit for bit.  Needs four cards; it checks
    the collectives, it does not time them."""
    import importlib.util
    from pathlib import Path

    from tpusdr_torch.parallel.mesh import LocalMesh

    # by its path: the card's machine may have another package named ``tests``
    spec = importlib.util.spec_from_file_location("torch_ingest_workers", Path(__file__).with_name("test_torch_ingest.py"))
    ti = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ti)

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    rng = np.random.default_rng(7)
    path = str(tmp_path / "cap.cf32")
    z = ti.capture(rng, ti.N_TICKS * ti.TICK)
    z.tofile(path)
    ti.write_segments(z, path, 4, ti.TICK)
    ticks = [torch.from_numpy(z[i * ti.TICK : (i + 1) * ti.TICK]).to(cuda) for i in range(ti.N_TICKS)]
    local = LocalMesh({"dev": 4}, cuda)
    want, want_moves = ti.run_all(local, ticks, ticks), ti.mesh_moves(local)
    ti.run_ranks(tmp_path, 4, path, "nccl")
    ti.check_ranks(tmp_path, 4, want, want_moves)


# -- the measurement layer and F8 on the card --------------------------------------------


def test_bench_scaling_on_the_card(cuda, capsys):
    """``apps/bench_scaling`` at the 20 Msps design point: WBFM over 1, 2, 4
    and 8 shards of a 1,280,000-sample tick, chain-wide and stagewise,
    captured, K1 and the resampler's kernel once a shard a step and no
    other, the output within -100 dB of the unsharded chain on the same
    tick; the 64-channel bank over 8 (ticks of 2,096,640) within -60 dB, no
    kernel launched; ``main`` prints its lines and the JSON line."""
    import itertools
    import json

    from tpusdr_torch.apps import bench_scaling
    from tpusdr_torch.graph.chain import Chain

    rng = np.random.default_rng(0)
    for shards, stagewise in itertools.product((1, 2, 4, 8), (False, True)):
        kernels.reset_launch_counts()
        r = bench_scaling.run_mesh("time", shards, 20e6, 1_280_000, 2, stagewise, "cuda", rng)
        torch.cuda.synchronize()
        assert r.tick == 1_280_000 and r.sharded.capture and r.steps == 4
        assert {w.__name__: w.launches for w in kernels.WRAPPERS if w.launches} == {
            "banded_fir": shards * r.steps, "resample_poly": shards * r.steps}
        chain = r.sharded.full_chain
        state = chain.init_state(device=cuda)
        for _ in range(r.steps):
            state, y = chain.apply(state, r.x)
        assert err_db(y.cpu().numpy(), r.y.cpu().numpy()) <= -100.0
    kernels.reset_launch_counts()
    r = bench_scaling.run_mesh("channels", 8, 20.48e6, 2_096_640, 2, False, "cuda", rng)
    torch.cuda.synchronize()
    assert not any(w.launches for w in kernels.WRAPPERS)
    bank = r.sharded
    chain = Chain([("channelizer", bank.channelizer), *bank.demod_chain.blocks])
    state = chain.init_state(device=cuda)
    for _ in range(r.steps):
        state, y = chain.apply(state, r.x)
    assert r.tick == 2_096_640 and y.shape == r.y.shape == (64, 2_096_640 // 64 // 2)
    assert err_db(y.cpu().numpy(), r.y.cpu().numpy()) <= -60.0
    capsys.readouterr()
    assert bench_scaling.main(["--devices", "1,2", "--rf-rate", "20e6", "--tick", "1280000", "--iters", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("card: ") and [ln.split(":")[0] for ln in lines[1:3]] == ["1 devices", "2 devices"]
    assert [res["devices"] for res in json.loads(lines[-1])["results"]] == [1, 2]


def test_scan_marginal_on_a_captured_tick(cuda):
    """``scan_marginal`` over ``captured_run`` of the WBFM 20 Msps tick:
    every arm's run is k replays (K1 and the resampler's kernel k times,
    no other), and the slope lands within 25% of the captured tick's ms on
    CUDA events."""
    from tpusdr_torch.utils import profiling as tprof

    chain = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)[0].to(cuda)
    rng = np.random.default_rng(1)
    ticks = np.stack(np.split(fm_tone(rng, 4 * 1_280_000, 20e6, 2.5e6, 75e3), 4))
    xs = tprof.tile_ticks(ticks, 48, cuda)
    run = tprof.captured_run(chain, cuda)
    state0 = chain.init_state(device=cuda)
    kernels.reset_launch_counts()
    run(state0, xs[:5])
    torch.cuda.synchronize()
    assert {w.__name__: w.launches for w in kernels.WRAPPERS if w.launches} == {"banded_fir": 5, "resample_poly": 5}
    res = tprof.scan_marginal(run, state0, xs, ks=(8, 24, 48), reps=3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(state0, xs)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / len(xs)
    assert res["n_points"] == 9 and abs(res["per_tick"] * 1e3 - ms) < 0.25 * ms, (res, ms)


def test_runner_without_buffers_is_on_the_card(cuda, rng):
    """F8: a chain with no buffers (``QuadFmDemod``) and no device named runs
    on the card and captures, equal to the CPU's ``apply`` within 1e-5 of
    gain; a MergedRunner places it there too, and a queue spec with no
    queueType names the card."""
    from tpusdr_torch.graph import blocks as B
    from tpusdr_torch.graph.chain import Chain
    from tpusdr_torch.graph.runner import _block_device

    chain = Chain([("d", B.QuadFmDemod(gain=1.0))])
    assert list(chain.buffers()) == [] and _block_device(chain) == cuda
    ticks = [crandn(rng, "cpu", 4096).numpy() for _ in range(4)]
    runner = StreamRunner(chain)
    sink = CollectSink()
    runner.run(iter(ticks), sink)
    assert runner.device == cuda and runner.capture and len(runner._step._graphs) == 1
    state, ref = chain.init_state(device="cpu"), []
    for x in ticks:
        state, y = chain.apply(state, torch.from_numpy(x))
        ref.append(y.numpy())
    np.testing.assert_allclose(sink.result(), np.concatenate(ref), rtol=0, atol=1e-5)
    assert queues.MergedRunner({"a": chain}).devices == {"a": cuda}
    assert queues._resolve_device({}) == cuda


#: the benchmark's two chains at their widths, on cf32 ticks of 1,280,000:
#: the WBFM receiver (K1 in ``shiftfir``) and the FM band's 100-channel bank
TRACED = {
    "wbfm": lambda: (receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM, 48000.0)[0],
                     lambda rng, n: np.split(fm_tone(rng, n * 1_280_000, 20e6, 2.5e6, 75e3), n)),
    "bank100": lambda: (multichannel.fm_channel_bank(20e6, 100, 48000.0)[0],
                        lambda rng, n: bank_ticks(n, 1_280_000, fs=20e6, m=100)),
}


DTOD = "Memcpy DtoD (Device -> Device)"


def device_records(fn):
    """The names of the card's records while ``fn()`` runs, in order."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    recs = [(e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")]
    return [name for _, name in sorted(recs)]


@pytest.mark.parametrize("label", list(TRACED))
def test_tracing_keeps_the_captured_audio_bit_for_bit(cuda, rng, label):
    """Eight ticks and a short one through the runner, untraced and with a
    tracer: the audio bit for bit, the same launches; the tracer holds a
    row a tick (two eager, one capture, six replays) and a span of each
    runner layer a block."""
    from tpusdr_torch.utils.tracing import Tracer

    block, make = TRACED[label]()
    block.to(cuda)
    ticks = make(rng, 8)
    ticks = ticks + [ticks[0][: len(ticks[0]) // 2]]
    plain, plain_counts, runner, _ = runner_audio(block, ticks, None, device=cuda)
    assert runner.tracer is None
    tr = Tracer()
    traced, counts, runner, _ = runner_audio(block, ticks, None, device=cuda, tracer=tr)
    assert counts == plain_counts
    assert traced.shape == plain.shape and np.array_equal(traced, plain)
    s = tr.summary()
    assert (s["ticks"]["eager"], s["ticks"]["capture"], s["ticks"]["replay"]) == (2, 1, 6)
    assert s["counters"]["captures"] == 1 and s["counters"]["eager_ticks"] == 2 and s["counters"]["blocks"] == 9
    for name in ("source", "upload", "queue", "step", "fetch", "drain_wait", "sink", "step.copy_in", "step.replay"):
        assert s["spans"][name]["count"] >= 7, name
    assert s["clock"]["device"] == str(cuda) and s["clock"]["uncertainty_ns"] < 1e5


#: the most a graph replay's own entry and exit (CUDA events around it, less
#: its first-to-last stamp) may take: about 5.7 us on an H100
GRAPH_ENTRY_EXIT_US = 10.0


@pytest.mark.parametrize("label", list(TRACED))
def test_stage_times_account_for_the_replay_on_cuda_events(cuda, rng, label):
    """Replays of a traced capture queued behind a spin kernel, each between
    two CUDA events: per replay, the stages' in-tick times (first stamp to
    last) against the events less the graph's own entry and exit (the same
    events around a capture of the chain's first block alone, less its
    stamped time, itself at most ``GRAPH_ENTRY_EXIT_US``), medians within
    5%."""
    from tpusdr_torch.graph.chain import Chain
    from tpusdr_torch.utils import tracing

    chain, make = TRACED[label]()
    chain.to(cuda)
    xs = [torch.from_numpy(x).to(cuda) for x in make(rng, 4)]

    def replays(block, n=24):
        tr = tracing.Tracer()
        step = CapturedStep(block, tracer=tr)
        state = block.init_state(device=cuda)
        for x in xs[:2]:
            state, _ = step(state, x)
        cap = next(iter(step._graphs.values()))
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        for j, (e0, e1) in enumerate(events):
            cap.x.copy_(xs[j % len(xs)])
            tr.claim(cap.layout, tracing.REPLAY)
            e0.record()
            cap.graph.replay()
            e1.record()
        torch.cuda.synchronize()
        rows = tr.rows()
        st = rows["stamps"][-n:]
        width = len(rows["names"][rows["layout"][-1]])
        stamped_us = (st[:, width - 1] - st[:, 0]) * 1e-3
        event_us = np.array([e0.elapsed_time(e1) * 1e3 for e0, e1 in events])
        return tr, rows, stamped_us, event_us

    tr, rows, stamped_us, event_us = replays(chain)
    assert rows["names"][rows["layout"][-1]] == ["start", *[k for k, _ in chain.blocks], "state"]
    _, _, first_stamped, first_events = replays(Chain(chain.blocks[:1]))
    entry_exit = np.median(first_events - first_stamped)
    assert 0 <= entry_exit <= GRAPH_ENTRY_EXIT_US, entry_exit
    assert abs(np.median(stamped_us) - (np.median(event_us) - entry_exit)) < 0.05 * np.median(event_us), (
        np.median(stamped_us), np.median(event_us), entry_exit)
    stages = tr.summary()["stages"]
    assert sum(v["p50_us"] for v in stages.values()) == pytest.approx(np.median(stamped_us), rel=0.05)


def test_tracing_off_leaves_the_graph_node_for_node(cuda, rng):
    """One replay of the WBFM tick captured without a tracer, and with one:
    the untraced replay runs no stamp, the traced one the untraced records
    and one stamp a boundary; the kernel launches counted are the same."""
    from tpusdr_torch.utils import tracing

    chain, make = TRACED["wbfm"]()
    chain.to(cuda)
    x = torch.from_numpy(make(rng, 1)[0]).to(cuda)
    records, launches = [], []
    for tr in (None, tracing.Tracer()):
        step = CapturedStep(chain, tracer=tr)
        state = chain.init_state(device=cuda)
        for _ in range(2):
            state, _ = step(state, x)
        kernels.reset_launch_counts()
        records.append(device_records(lambda: step(state, x)))
        launches.append({w.__name__: w.launches for w in kernels.WRAPPERS})
    # CUDA may run a small device-to-device copy node of a graph as its own
    # kernel (memcpy32_post) in one graph and as a copy in another
    plain, traced = ([DTOD if r == "memcpy32_post" else r for r in rs] for rs in records)
    stamps = [r for r in traced if tracing.STAMP_KERNEL in r]
    assert not any(tracing.STAMP_KERNEL in r for r in plain)
    assert len(stamps) == len(chain.blocks) + 2
    assert sorted(r for r in traced if tracing.STAMP_KERNEL not in r) == sorted(plain)
    assert launches[0] == launches[1] and launches[0]["banded_fir"] == 1


def test_a_capture_holds_the_collector_off(cuda):
    """A collection inside a capture may free a dead reference cycle that
    holds another captured graph, and that invalidates the capture: the
    collector is off while ``CapturedStep`` captures, on for the eager tick
    and after it."""
    import gc

    from tpusdr_torch.graph import blocks

    seen = []

    class Probe(blocks.Resampler):
        def apply(self, state, x):
            seen.append(gc.isenabled())
            return super().apply(state, x)

    block = Probe(3, 25)
    block.to(cuda)
    step = CapturedStep(block)
    state, x = block.init_state(device=cuda), torch.ones(2_500, device=cuda)
    assert gc.isenabled()
    for _ in range(3):  # eager, captured, replayed
        state, y = step(state, x)
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled() and step.captures == 1
    assert y.shape == (300,) and bool(torch.isfinite(y).all())


def test_a_refresh_counts_a_second_capture(cuda, rng):
    """A traced runner retuned between two runs: each run captures once, and
    the tracer's counters, read from each run's ``RunStats``, hold both
    captures.  The step and the graph that the retune dropped are freed:
    the tracer keeps no reference to them."""
    import gc
    import weakref

    from tpusdr_torch.utils.tracing import Tracer

    ticks = np.split(fm_tone(rng, 8 * 40000, 2e6, 300e3, 75e3), 8)
    chain, _ = receiver.fm_receiver(2e6, 300e3, receiver.WBFM)
    with Tracer() as tr:
        runner = StreamRunner(chain.to(cuda))
    sink = CollectSink()
    state, first = runner.run(iter(ticks[:4]), sink)
    state = copy.deepcopy(state)  # the static state aliases the graph's buffers
    dropped = (weakref.ref(runner._step), weakref.ref(next(iter(runner._step._graphs.values()))))
    runner.update_parameters("shiftfir", frequency=-310e3)
    gc.collect()
    assert [ref() for ref in dropped] == [None, None]
    _, second = runner.run(iter(ticks[4:]), sink, state=state)
    assert (first.captures, first.eager_ticks, second.captures, second.eager_ticks) == (1, 1, 1, 1)
    s = tr.summary()
    assert s["counters"]["captures"] == 2 and s["counters"]["eager_ticks"] == 2
    assert (s["ticks"]["eager"], s["ticks"]["capture"], s["ticks"]["replay"]) == (2, 2, 4)


def test_a_tracer_refuses_a_second_stream(cuda, rng):
    """A tracer records the ticks of one stream: a ``MergedRunner`` whose
    two pipelines share one queue records both into it, a row a tick in
    the order issued; one on two queues raises ``ValueError`` at the
    second stream's first tick."""
    from tpusdr_torch.utils.tracing import Tracer

    reg = queues.get_queue_registry()
    q = {n: reg.create(f"trace-{n}", {"queueType": "cuda"}) for n in "ab"}
    ticks = [torch.from_numpy(t).to(cuda) for t in np.split(fm_tone(rng, 4 * 40000, 2e6, 300e3, 75e3), 4)]
    for queue in (q["a"], q):
        with Tracer() as tr:
            runner = queues.MergedRunner(
                {n: receiver.fm_receiver(2e6, 300e3, receiver.WBFM)[0].to(cuda) for n in "ab"}, queue=queue)
        states = runner.init_state()
        if queue is q:
            with pytest.raises(ValueError, match="one stream of one device"):
                runner.step(states, {n: ticks[0] for n in "ab"})
            continue
        for x in ticks:
            states, _ = runner.step(states, {n: x for n in "ab"})
        runner.synchronize()
        rows = tr.rows()
        assert rows["claimed"] == 8 and rows["mode"].tolist() == [0, 0, 1, 1, 2, 2, 2, 2]
        first = rows["stamps"][:, 0]
        assert (np.diff(first) > 0).all()


def test_live_runner_drains_each_block_as_its_tick_ends(cuda):
    """The WBFM receiver at 20 Msps fed as a HackRF feeds it: blocks of
    131,250 int8 samples handed over every 6.5625 ms for about a second.
    The median time from a tick's end on the card (its last stamp, on the
    host's clock; the audio's copy-out is queued right behind it) to the
    start of its sink write is under 1 ms, nearly every tick is drained
    early, and the audio is a backlogged run's bit for bit.  The backlogged
    run, the blocks read from host memory, runs well above the radio's rate
    and drains early only when it finds the upload queue empty: far fewer
    of its ticks than the paced run's."""
    import time

    from tpusdr_torch.utils.tracing import Tracer

    n, fs = 131_250, 20e6
    period = n / fs
    pool = list(SyntheticIqSource.fm(n, fs, carrier_offset=2.5e6, output_format="int8", num_blocks=16))
    blocks = [pool[i % len(pool)] for i in range(int(1.0 / period))]
    chain = receiver.fm_receiver(fs, 2.5e6, receiver.WBFM, 48000.0, input_format="int8")[0].to(cuda)

    def paced():
        t0 = time.perf_counter()
        for i, b in enumerate(blocks):
            wait = t0 + (i + 1) * period - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            yield b

    def warmed(tracer=None):
        runner = StreamRunner(chain, device=cuda, tracer=tracer)
        runner.run(iter(pool[:3]), CollectSink())  # eager, captured, replayed
        return runner

    tr = Tracer()
    live, sink = warmed(tr), CollectSink()
    _, stats = live.run(paced(), sink)
    ref = CollectSink()
    _, backlog = warmed().run(iter(blocks), ref)
    assert stats.blocks == backlog.blocks == len(blocks) and stats.early_drains >= len(blocks) - 2
    print(f"backlog: {backlog.blocks} blocks, {backlog.early_drains} drained early, {backlog.msps_in:.1f} Msps")
    assert backlog.early_drains < stats.early_drains and backlog.msps_in > 2 * fs / 1e6
    assert np.array_equal(sink.result(), ref.result())

    rows, sp = tr.rows(), tr.spans("sink")
    widths = np.array([len(x) for x in rows["names"]])[rows["layout"]]
    last = rows["host"][np.arange(len(widths)), widths - 1]
    run = rows["id"].max() >> 32  # the paced run's blocks (the warm run's ids sit below)
    done = {i: t for i, t in zip(rows["id"].tolist(), last.tolist()) if i >= 0 and i >> 32 == run}
    hold_ms = [(t0 - done[i]) * 1e-6 for i, t0 in zip(sp["id"].tolist(), sp["t0"].tolist()) if i in done]
    assert len(hold_ms) == len(blocks)
    assert np.median(hold_ms) < 1.0, np.percentile(hold_ms, [50, 95])


#: the marine VHF band's 57 channels (nbfm_marine57): every 25 kHz, -700 to +700 kHz
MARINE = [25e3 * k for k in range(-28, 29)]


def nbfm_channel_taps(dev):
    """The NBFM channel filter at 2 Msps: 728 taps, cut at 7.5 kHz."""
    from tpusdr_torch.ops import design

    h = torch.from_numpy(design.lowpass_taps(2e6, 7500.0, 7500.0, -60.0).astype(np.float32)).to(dev)
    assert h.shape[-1] == 728
    return h


@pytest.mark.parametrize("C", [57, 1])
def test_k3_channel_axis_matches_plain_and_single_channel_launches(cuda, rng, C):
    """K3's channel form at (728, /66), M = 19,375 (the nbfm.capture tick),
    [history, x] through the two pointers: one launch for C channels (57:
    the shared form, its rows counted in ``shared_rows``; 1: the
    phase-major form), within 1e-5 * gain of the plain version's channel
    form, and each row against the single-channel launch with that
    channel's increment and carried phase: within 1e-5 * gain in the shared
    form, which folds the mix into the taps, bit for bit where both launches
    take the same form (C = 1: the channel form against today's launch).
    The taps are the NBFM channel filter, so that each channel holds one
    station."""
    T, D, M, gain = 728, 66, 19_375, 0.32
    form = "shared" if C >= tfm.SHARED_MIN_CHANNELS else "phase"
    assert tfm.fm_fused_plan(T, D, M, C) == (form, tfm.PHASE_TILE, T)
    h = nbfm_channel_taps(cuda)
    n = (T - 1) + (M + 1) * D
    H = (T - 1) + D
    offsets = MARINE if C == 57 else [100e3]
    z = sum(fm_tone(rng, n, 2e6, f, 5e3) * (1.0 / len(offsets)) for f in offsets)
    z = torch.from_numpy(z.astype(np.complex64)).to(cuda)
    incs = [osc.freq_to_inc_u32(-f, 2e6) for f in offsets]
    phases = [int(p) for p in rng.integers(0, 2**32, C)]
    incs_t, phases_t = torch.tensor(incs, device=cuda), osc.as_phases(phases, cuda)
    counters = (tfm.fused_fm_demod.launches, tfm.fused_fm_demod.channel_rows, tfm.fused_fm_demod.shared_rows)
    got = tfm.fused_fm_demod(z[H:], h, D, incs_t, phases_t, gain, history=z[:H])
    shared = C if form == "shared" else 0
    assert (tfm.fused_fm_demod.launches, tfm.fused_fm_demod.channel_rows,
            tfm.fused_fm_demod.shared_rows) == (counters[0] + 1, counters[1] + C, counters[2] + shared)
    assert got.shape == (C, M) and bool(torch.isfinite(got).all())
    ref = tfm.fused_fm_demod_plain(z, h, D, incs_t, phases_t, gain, M)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5 * gain)
    for c in range(C):
        one = tfm.fused_fm_demod(z[H:], h, D, incs[c], osc.as_phase(phases[c], cuda), gain, history=z[:H])
        if form == "shared":
            np.testing.assert_allclose(got[c].cpu().numpy(), one.cpu().numpy(), rtol=0, atol=1e-5 * gain)
        else:
            assert torch.equal(got[c], one), c


def shared_launch(x, taps, D, incs, phases, gain, M, history=None):
    """One K3 launch in the shared form, whatever the rule would pick for
    C: (C, M) outputs, NaN where the launch wrote nothing."""
    from tpusdr_torch.kernels.build import library

    out = torch.full((incs.shape[0], M), float("nan"), dtype=torch.float32, device=x.device)
    plan = tfm.FmFusedPlan("shared", tfm.SHARED_TILE, taps.shape[-1])
    head, tail = tfm.launch_args(library(), history, x, taps, D, incs, phases, gain, M, plan, out)
    assert library().tpusdr_fm_fused(*head, *tail) == 0
    return out


@pytest.mark.parametrize("hist", ["tail", None])
@pytest.mark.parametrize("C,M", [(2, 5_037), (3, 5_037), (57, 19_375), (2, 100), (3, 159), (57, 1)])
def test_k3_shared_form_matches_plain(cuda, rng, C, M, hist):
    """K3's shared form at (728, /66) over C stations of the marine raster
    (2 and 3 below the rule's threshold, launched directly; 57, the
    nbfm.capture shape), against the plain version's channel form within
    1e-5 * gain: M ragged against the 159 outputs of a work item, one item
    a channel or less, [history, x] through the two pointers or x alone,
    each channel's carried phase at random (the kernel reads none).  x ends
    in D // 2 NaN samples past the last one a tap reads: they must reach no
    output."""
    T, D, gain = 728, 66, 0.32
    h = nbfm_channel_taps(cuda)
    n = (T - 1) + (M + 1) * D
    H = (T - 1) + D if hist == "tail" else 0
    offsets = MARINE[:: max(1, len(MARINE) // C)][:C]
    z = sum(fm_tone(rng, n + D // 2, 2e6, f, 5e3) * (1.0 / C) for f in offsets)
    z = torch.from_numpy(z.astype(np.complex64)).to(cuda)
    z[n:] = float("nan")
    incs = torch.tensor([osc.freq_to_inc_u32(-f, 2e6) for f in offsets], device=cuda)
    phases = osc.as_phases(rng.integers(0, 2**32, C).tolist(), cuda)
    got = shared_launch(z[H:], h, D, incs, phases, gain, M, history=z[:H] if H else None)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    ref = tfm.fused_fm_demod_plain(z[:n], h, D, incs, phases, gain, M)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5 * gain)


@pytest.mark.parametrize("Q,transition", [(2, 45e3), (9, 10e3), (16, 5.2e3)])
def test_k3_shared_form_takes_every_tap_count_it_is_built_for(cuda, rng, Q, transition):
    """The shared form at D = 66 with a channel filter of Q taps a phase (16
    the most it is built for), its transition set to give them, against the
    plain version within 1e-5 * gain over 6 stations 225 kHz apart."""
    from tpusdr_torch.ops import design

    D, M, C, gain = 66, 2_000, 6, 0.32
    h = torch.from_numpy(design.lowpass_taps(2e6, 7500.0, transition, -60.0).astype(np.float32)).to(cuda)
    T = h.shape[-1]
    assert -(-T // D) == Q and tfm.fm_fused_plan(T, D, M, C).form == "shared"
    n = (T - 1) + (M + 1) * D
    offsets = MARINE[:: len(MARINE) // C][:C]
    z = sum(fm_tone(rng, n, 2e6, f, 5e3) * (1.0 / C) for f in offsets)
    z = torch.from_numpy(z.astype(np.complex64)).to(cuda)
    incs = torch.tensor([osc.freq_to_inc_u32(-f, 2e6) for f in offsets], device=cuda)
    phases = osc.as_phases(rng.integers(0, 2**32, C).tolist(), cuda)
    got = shared_launch(z, h, D, incs, phases, gain, M)
    ref = tfm.fused_fm_demod_plain(z, h, D, incs, phases, gain, M)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5 * gain)


def test_k3_shared_form_retunes_in_a_captured_launch(cuda, rng):
    """A CUDA graph holding one K3 launch over the 57 marine channels (the
    shared form): a retune that writes the increments in place between two
    replays reaches the second replay's output, which matches the plain
    version at the new frequencies within 1e-5 * gain; nothing else is
    updated.  The new increments move each channel up 25 kHz, onto the next
    station, and the last onto the first (a channel without a station
    holds noise, whose arg no two orders of float arithmetic agree on).
    """
    T, D, M, gain = 728, 66, 19_375, 0.32
    h = nbfm_channel_taps(cuda)
    n = (T - 1) + (M + 1) * D
    z = sum(fm_tone(rng, n, 2e6, f, 5e3) * (1.0 / 57) for f in MARINE)
    z = torch.from_numpy(z.astype(np.complex64)).to(cuda)
    incs = torch.tensor([osc.freq_to_inc_u32(-f, 2e6) for f in MARINE], device=cuda)
    phases = osc.as_phases(rng.integers(0, 2**32, 57).tolist(), cuda)
    assert tfm.fm_fused_plan(T, D, M, 57).form == "shared"
    tfm.fused_fm_demod(z, h, D, incs, phases, gain)  # eager first: the kernel's shared-memory opt-in
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        y = tfm.fused_fm_demod(z, h, D, incs, phases, gain)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    first = y.clone()
    ref = tfm.fused_fm_demod_plain(z, h, D, incs, phases, gain, M)
    np.testing.assert_allclose(first.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-5 * gain)
    retuned = [osc.freq_to_inc_u32(-f, 2e6) for f in MARINE[1:] + MARINE[:1]]
    incs.copy_(torch.tensor(retuned, dtype=torch.int64))
    graph.replay()
    torch.cuda.synchronize()
    ref2 = tfm.fused_fm_demod_plain(z, h, D, incs, phases, gain, M)
    np.testing.assert_allclose(y.cpu().numpy(), ref2.cpu().numpy(), rtol=0, atol=1e-5 * gain)
    assert (y - first).abs().max().item() > 0.01


@pytest.mark.parametrize("every,tick,n_ticks", [(4, 8250 * 20, 4), (1, 8250 * 155, 2)])
def test_nbfm_channels_captured_on_the_card_matches_cpu(cuda, rng, every, tick, n_ticks):
    """The NBFM channels' chain (15 of the marine channels on ticks of
    165,000, and the nbfm.capture cell's 57 on ticks of 1,278,750) through a
    traced CapturedStep, tick by tick against the eager CPU chain: one K3
    launch and C channel rows a tick, all in K3's shared form, and one
    resampler launch over C rows, eager, captured or replayed; the traced
    summary holds the ``frontend`` and ``audio`` stages, channel rows over
    launches = C and as many shared rows as channel rows."""
    from tpusdr_torch.models import nbfm_channels
    from tpusdr_torch.utils.tracing import Tracer

    offsets = MARINE[::every]
    C = len(offsets)
    cpu_chain, _ = nbfm_channels(2e6, offsets)
    gpu_chain = copy.deepcopy(cpu_chain).to(cuda)
    z = sum(fm_tone(rng, n_ticks * tick, 2e6, f, 5e3) * 0.06 for f in offsets).astype(np.complex64)
    ticks = np.split(z, n_ticks)
    cs, ref = cpu_chain.init_state(), []
    for blk in ticks:
        cs, cy = cpu_chain.apply(cs, torch.from_numpy(blk))
        ref.append(cy.numpy())
    kernels.reset_launch_counts()
    with Tracer() as tr:
        step = CapturedStep(gpu_chain)
        gs = gpu_chain.init_state(device=cuda)
        for k, blk in enumerate(ticks):
            gs, gy = step(gs, torch.from_numpy(blk).to(cuda))
            assert gy.shape == ref[k].shape == (C, tick * 4 // 1000)
            assert err_db(ref[k], gy.cpu().numpy()) <= -60.0
            assert (tfm.fused_fm_demod.launches, tfm.fused_fm_demod.channel_rows,
                    tfm.fused_fm_demod.shared_rows) == (k + 1, C * (k + 1), C * (k + 1))
            assert (trp.resample_poly.launches, trp.resample_poly.rows) == (k + 1, C * (k + 1))
    assert step.eager_ticks == 1 and step.captures == 1
    s = tr.summary()
    assert {"frontend", "audio"} <= set(s["stages"])
    assert s["counters"]["launches"]["fused_fm_demod"] == s["counters"]["launches"]["resample_poly"] == n_ticks
    assert s["counters"]["channel_rows"]["fused_fm_demod"] == s["counters"]["rows"]["resample_poly"] == n_ticks * C
    assert s["counters"]["shared_rows"]["fused_fm_demod"] == s["counters"]["channel_rows"]["fused_fm_demod"]


# -- the batched resampler: resample_poly ------------------------------------------------

#: label -> (U, D, rows, N, complex): the capture cells' resamplers, the
#: live WBFM block, a complex batch, and a receiver's 1599/1000 (a 2.4 Msps
#: radio), whose 400 groups of classes take runs of groups a block
RESAMPLE_SHAPES = {
    "nbfm.capture": (33, 125, 57, 19_375, False),
    "bank100.capture": (6, 25, 100, 12_800, False),
    "wbfm.capture": (3, 25, 1, 25_600, False),
    "wbfm.live": (3, 25, 1, 2_625, False),
    "complex": (3, 25, 4, 25_600, True),
    "u1599": (1599, 1000, 2, 20_000, False),
}


def resample_inputs(rng, dev, U, D, rows, N, is_complex, ticks=1):
    """The plan, its taps on ``dev`` (the kernel's table), a random carry
    and ``ticks`` random ticks of (rows, N)."""
    plan = tres.make_plan(tres.design_resampler_taps(U, D), U, D, N)
    taps = tres.plan_taps(plan, dev)

    def draw(n):
        if is_complex:
            return crandn(rng, dev, rows, n)
        return torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dev)

    return plan, taps, draw(plan.history), [draw(N) for _ in range(ticks)]


@pytest.mark.parametrize("label", list(RESAMPLE_SHAPES))
def test_resample_poly_matches_plain(cuda, rng, label):
    """The kernel against its plain version on the card, at the capture
    cells' shapes, the live block, a complex batch and runs of groups: the
    audio within
    1e-6 of peak, the carry bit for bit equal to the last P-1 samples of
    [state, x] (the plain version's), one launch and ``rows`` rows counted
    for a real tick, two and 2 x rows for a complex one."""
    U, D, rows, N, is_complex = RESAMPLE_SHAPES[label]
    plan, taps, state, (x,) = resample_inputs(rng, cuda, U, D, rows, N, is_complex)
    kernels.reset_launch_counts()
    carry, y = trp.resample_poly(state, x, plan, taps)
    torch.cuda.synchronize()
    planes = 2 if is_complex else 1
    assert (trp.resample_poly.launches, trp.resample_poly.rows) == (planes, planes * rows)
    ref_carry, ref = trp.resample_poly_plain(state, x, plan, torch.from_numpy(plan.frame_taps).to(cuda))
    assert y.shape == ref.shape == (rows, N * U // D) and y.dtype == x.dtype
    err = (y - ref).abs().max().item() / ref.abs().max().item()
    assert err <= 1e-6, err
    assert carry.shape == state.shape and carry.dtype == state.dtype
    assert torch.equal(carry, ref_carry) and torch.equal(carry, torch.cat([state, x], -1)[:, -plan.history:])


@pytest.mark.parametrize("label", ["nbfm.capture", "wbfm.capture", "complex"])
def test_resample_poly_streams_as_one_long_call(cuda, rng, label):
    """Eight ticks with the carry handed on equal one call over the eight
    ticks joined (its own plan and launch), within 1e-6 of peak; the last
    carries bit for bit."""
    U, D, rows, N, is_complex = RESAMPLE_SHAPES[label]
    rows = min(rows, 8)
    plan, taps, state0, ticks = resample_inputs(rng, cuda, U, D, rows, N, is_complex, ticks=8)
    state, outs = state0, []
    for x in ticks:
        state, y = trp.resample_poly(state, x, plan, taps)
        outs.append(y)
    long_plan = tres.make_plan(tres.design_resampler_taps(U, D), U, D, 8 * N)
    long_state, whole = trp.resample_poly(state0, torch.cat(ticks, -1), long_plan, tres.plan_taps(long_plan, cuda))
    streamed = torch.cat(outs, -1)
    assert streamed.shape == whole.shape
    assert (streamed - whole).abs().max().item() <= 1e-6 * whole.abs().max().item()
    assert torch.equal(state, long_state)


def test_audio_stage_of_a_captured_step_runs_one_kernel(cuda, rng):
    """The NBFM channels' resampler (33/125 over 57 rows of 19,375) as a
    captured step under the profiler: one replay runs one resample_poly
    kernel and nothing else on the card but the static input's copy; no
    concatenation, no strided copy, no gemv."""
    chain, _ = multichannel.nbfm_channels(2e6, MARINE)
    block = chain.get_block("audio").to(cuda)
    x = torch.from_numpy(rng.standard_normal((57, 19_375)).astype(np.float32)).to(cuda)
    step = CapturedStep(block)
    state = block.init_state((57,), device=cuda)
    for _ in range(3):
        state, _ = step(state, x)
    for _ in range(3):  # a profiler session may see the replay's copy and not its kernels: look again
        records = device_records(lambda: step(state, x))
        kernels_run = [r for r in records if not r.startswith("Memcpy") and r != "memcpy32_post"]
        if kernels_run:
            break
    assert len(kernels_run) == 1 and "resample_poly" in kernels_run[0], records
    assert not any("Cat" in r or "gemv" in r for r in records), records
