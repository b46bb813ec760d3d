"""The plain versions of the port's kernels against the JAX package's Pallas
kernels (interpret mode on the CPU), and the card's shape rules (pure
Python).  The CUDA kernels against their plain versions on the card are in
test_torch_cuda.py.

Tolerances: FIR outputs within 1e-5 of the output's peak (float32 on both
sides, only the summation order differs; the JAX prelude kernel's bf16
hi/lo split adds ~3e-6); FM discriminator outputs within 1e-5 * gain (the
TPU kernel's polynomial atan against atan2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpusdr.kernels import fir_banded_pallas as jfb
from tpusdr.kernels.fir_pallas import fir_decim_pallas
from tpusdr.kernels.fm_pallas import fused_fm_demod_pallas
from tpusdr.ops import cplx as jcplx
from tpusdr.ops import osc as josc
from tpusdr_torch import kernels
from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.kernels import dispatch
from tpusdr_torch.kernels import fir_banded as tfb
from tpusdr_torch.kernels import fir_poly as tfp
from tpusdr_torch.kernels import fm_fused as tfm
from tpusdr_torch.kernels import resample_poly as trp
from tpusdr_torch.models import multichannel as TM
from tpusdr_torch.models import receiver as TR
from tpusdr_torch.ops import design as tdesign
from tpusdr_torch.ops import osc as tosc
from tpusdr_torch.ops import resample as tres

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(9)


def crandn(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def close_to_peak(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _taps(T, complex_taps):
    t = sps.firwin(T, 0.1).astype(np.float32)
    if complex_taps:
        t = (t * np.exp(1j * 0.37 * np.arange(T))).astype(np.complex64)
    return t


def _pair(z):
    return jcplx.Complex(jnp.asarray(z.real.copy()), jnp.asarray(z.imag.copy()))


def fm_tone(rng, n, fs, offset, deviation):
    t = np.arange(n) / fs
    ph = 2 * np.pi * offset * t + 2 * np.pi * deviation * np.cumsum(np.sin(2 * np.pi * 1e3 * t)) / fs
    return (0.9 * np.exp(1j * ph) + 0.01 * crandn(rng, n)).astype(np.complex64)


# -- K1: banded_fir_pallas ---------------------------------------------------------


@pytest.mark.parametrize("complex_taps", [False, True])
@pytest.mark.parametrize("T,D", [(546, 50), (33, 4), (46, 2)])
def test_banded_fir_plain_matches_pallas(rng, T, D, complex_taps):
    M = 300
    L = (T - 1) + M * D
    z = crandn(rng, L)
    t = _taps(T, complex_taps)
    ref = jcplx.to_numpy(jfb.banded_fir_pallas(jcplx.from_numpy(z), t, D, interpret=True))
    got = tfb.banded_fir(torch.from_numpy(z), torch.from_numpy(t), D).numpy()
    close_to_peak(got, ref)


def test_banded_fir_history_form(rng):
    """History passed separately (no concatenation in front of the block)."""
    T, D = 546, 50
    t = _taps(T, True)
    hist, z = crandn(rng, T - 1), crandn(rng, 200 * D)
    ref = jcplx.to_numpy(
        jfb.banded_fir_pallas(jcplx.from_numpy(z), t, D, interpret=True, history=jcplx.from_numpy(hist))
    )
    got = tfb.banded_fir(torch.from_numpy(z), t, D, history=torch.from_numpy(hist)).numpy()
    assert got.shape == (200,)
    close_to_peak(got, ref)


# -- K2: banded_fir_prelude -------------------------------------------------------


def test_prelude_plain_matches_pallas_streaming(rng):
    """Three ticks; each tick's prelude is the last 8 rows of the stream."""
    T, D = 89, 8
    G, _ = jfb.prelude_plan(T, D)
    N = 24 * G
    t = (sps.firwin(T, 0.05) * np.exp(-2j * np.pi * 0.15 * np.arange(T))).astype(np.complex64)
    pre = np.zeros((8, G), np.complex64)
    for _ in range(3):
        z = crandn(rng, N)
        ref = jcplx.to_numpy(jfb.banded_fir_prelude(jcplx.from_numpy(z), _pair(pre), t, D, interpret=True))
        got = tfb.banded_fir_prelude(torch.from_numpy(z), torch.from_numpy(pre), t, D).numpy()
        assert got.shape == (N // D,)
        close_to_peak(got, ref)
        pre = z[-8 * G :].reshape(8, G)


def test_prelude_multi_backward_parts(rng):
    """T-1 > 2G: B=3 backward parts (tests/test_kernels.py:401)."""
    T, D = 2500, 8
    G, B = jfb.prelude_plan(T, D)
    assert B == 3
    N = 48 * G
    t = (sps.firwin(T, 0.01) * np.exp(-2j * np.pi * 0.11 * np.arange(T))).astype(np.complex64)
    pre, z = crandn(rng, 8, G), crandn(rng, N)
    ref = jcplx.to_numpy(jfb.banded_fir_prelude(jcplx.from_numpy(z), _pair(pre), t, D, interpret=True))
    got = tfb.banded_fir_prelude(torch.from_numpy(z), torch.from_numpy(pre), t, D).numpy()
    close_to_peak(got, ref)


def test_prelude_rejects_non_row_ticks(rng):
    G, _ = tfb.prelude_plan(89, 8)
    with pytest.raises(ValueError, match="8G"):
        tfb.banded_fir_prelude(
            torch.zeros(8 * G + 64, dtype=torch.complex64),
            torch.zeros(8, G, dtype=torch.complex64), np.ones(89, np.float32), 8,
        )


def test_shape_rules_equal_jax():
    """The port keeps the JAX package's shape rules, so FusedFmDemod picks
    the same branch and granule.  Divergence recorded (fault 3.2): the JAX
    prelude kernel doubles its tap-matrix bytes for the bf16 hi/lo split
    (fir_banded_pallas.py:641-643) while its prelude_eligible does not
    (:431); the port has no split, so its rule and kernel agree."""
    for T in (33, 46, 55, 65, 89, 546, 728, 2500, 5000, 9000):
        for D in (1, 2, 4, 5, 8, 50, 66, 128):
            assert tfb._plan(T, D) == jfb._plan(T, D)
            assert tfb.prelude_plan(T, D) == jfb.prelude_plan(T, D)
            for c in (False, True):
                assert tfb.eligible(T, D, c) == jfb.eligible(T, D, c), (T, D, c)
                G = 128 * D
                for N in (8 * G, 16 * G, 200 * G, 16 * G + 8):
                    assert tfb.prelude_eligible(T, D, N, c) == jfb.prelude_eligible(T, D, N, c)


# -- K3: fused_fm_demod_pallas ------------------------------------------------------


@pytest.mark.parametrize("phase_rad", [1.1, 5.0])
def test_fused_fm_plain_matches_pallas(rng, phase_rad):
    T, D, M = 91, 10, 800
    fs, f_off, gain = 2e6, 250e3, 0.8
    taps = (rng.standard_normal(T) * 0.05).astype(np.float32)
    inc = josc.freq_to_inc_u32(-f_off, fs)
    phase0 = josc.init_phase(phase_rad)
    z = fm_tone(rng, (T - 1) + (M + 1) * D, fs, f_off, 75e3)
    ref = np.asarray(fused_fm_demod_pallas(jcplx.from_numpy(z), taps, D, inc, phase0, gain, interpret=True))
    got = tfm.fused_fm_demod(torch.from_numpy(z), taps, D, int(inc), tosc.as_phase(int(phase0)), gain).numpy()
    assert got.shape == (M,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * gain)
    # the host-int form, and the carried phase with a by-value offset,
    # give the same samples bit for bit
    by_value = tfm.fused_fm_demod(torch.from_numpy(z), taps, D, int(inc), int(phase0), gain).numpy()
    back = tosc.as_phase((int(phase0) - 12345) % (1 << 32))
    split = tfm.fused_fm_demod(torch.from_numpy(z), taps, D, int(inc), back, gain, phase_offset=12345).numpy()
    np.testing.assert_array_equal(by_value, got)
    np.testing.assert_array_equal(split, got)


# -- K4: fir_decim_pallas -----------------------------------------------------------


@pytest.mark.parametrize("T,D,M", [(546, 50, 1200), (64, 8, 700), (33, 4, 513), (868, 250, 64), (46, 2, 400)])
def test_fir_decim_plain_matches_pallas(rng, T, D, M):
    """K4's plain version (ops.fir._fir_poly on I and Q) against the Pallas
    kernel in interpret mode; x_ext holds a ragged tail past the last
    output that both ignore."""
    z = crandn(rng, (T - 1) + M * D + D // 2)
    h = (rng.standard_normal(T) / np.sqrt(T)).astype(np.float32)
    ref = jcplx.to_numpy(fir_decim_pallas(jcplx.from_numpy(z), h, D, interpret=True))
    got = tfp.fir_decim(torch.from_numpy(z), torch.from_numpy(h), D).numpy()
    assert got.shape == (M,)
    close_to_peak(got, ref)


def test_fir_decim_refuses_what_k4_does_not_take(rng):
    z = torch.from_numpy(crandn(rng, 500))
    for bad in (
        lambda: tfp.fir_decim(z, torch.ones(9), 1),  # D = 1
        lambda: tfp.fir_decim(z.reshape(2, 250), torch.ones(9), 2),  # batched
        lambda: tfp.fir_decim(z, torch.ones(9, dtype=torch.complex64), 2),  # complex taps
        lambda: tfp.fir_decim(z, torch.ones(9), 2, history=z.reshape(2, 250)),  # batched history
    ):
        with pytest.raises(ValueError, match="fir_decim"):
            bad()


# the four shapes that reach K4 on the receiver paths, scaled down to a few thousand samples:
# the JSON graph's (546, /50), the AM K4 runner's (868, /250) and (46, /2), the single-stage AM (6665, /500)
K4_SHAPES = [(546, 50, 60), (868, 250, 12), (46, 2, 1500), (6665, 500, 6)]
K4_PATH_SHAPES = [(546, 50, 25_600), (868, 250, 5_120), (46, 2, 2_560), (6665, 500, 2_560)]  # at their real M


@pytest.mark.parametrize("H", ["tail", "none", 7])
@pytest.mark.parametrize("T,D,M", K4_SHAPES)
def test_fir_decim_history_equals_pallas_of_the_concatenation(rng, T, D, M, H):
    """``fir_decim(x, taps, D, history=h)`` against ``fir_decim_pallas``
    (interpret mode) of concat(h, x), for the streaming carry of T-1
    samples, for none and for a short one; M counts both.  On the CPU the
    split call is the whole one bit for bit."""
    H = T - 1 if H == "tail" else 0 if H == "none" else H
    z = crandn(rng, (T - 1) + M * D + D // 2)
    h = (rng.standard_normal(T) / np.sqrt(T)).astype(np.float32)
    ref = jcplx.to_numpy(fir_decim_pallas(jcplx.from_numpy(z), h, D, interpret=True))
    zt, ht = torch.from_numpy(z), torch.from_numpy(h)
    got = tfp.fir_decim(zt[H:], ht, D, history=zt[:H] if H else None)
    assert got.shape == (M,)
    close_to_peak(got.numpy(), ref)
    assert torch.equal(got, tfp.fir_decim(zt, ht, D))


# -- K4: the plan -------------------------------------------------------------------


def _k4_smem_c_side(T, D, plan):
    """csrc/fir_poly.cu, smem_bytes, written out."""
    if plan.form == "phase":
        Q = -(-T // D)
        return ((plan.tile + Q - 1) * (D | 1) + 8 * plan.tile) * 8 + D * Q * 4
    red = 256 if plan.form == "outputs" else 0
    return ((plan.tile - 1) * D + plan.chunk + red) * 8 + plan.chunk * 4


def _k4_stage_launches(chain, tick=None):
    """((T, D, M), plan) of each RF stage of ``chain`` that reaches K4 (a
    complex ``Fir`` in mode 'pallas' with real taps and D >= 2) on a tick of
    ``tick`` RF samples."""
    out, n = [], tick or RULE_TICK
    for _, b in chain.blocks:
        if isinstance(b, (TB.FusedFmDemod, TB.FreqShiftFir, TB.Fir)) and b.decimation > 1:
            n //= b.decimation
            if isinstance(b, TB.Fir) and b.mode == "pallas" and b.in_dtype == torch.complex64:
                T, D = b.taps.shape[-1], b.decimation
                out.append(((T, D, n), tfp.fir_decim_plan(T, D, n)))
    return out


def test_fir_decim_plan_over_every_k4_stage(monkeypatch):
    """The rule over every RF stage that reaches K4: ``am_receiver`` and
    ``fm_receiver`` in mode 'pallas' with the shift unfolded at 1-20 Msps,
    multistage on and off, on ticks of 1,280,000 and 262,144 RF samples
    (with the longest tap counts the design can return), and the four
    shapes of the receiver paths at their own M.  Every plan fits one block's shared
    memory, the Python count equals the C side's arithmetic, and each form
    keeps its bounds: phase-major plans have D >= 8, R and the pitch odd so
    that the half-warps' 64-bit loads are conflict-free (checked bank by
    bank) and cover two thirds of the SMs; lanes across outputs only for
    D < 8; no tile of a window form that fits stages fewer samples on its
    busiest SM than the one picked."""
    monkeypatch.setattr(tdesign, "lowpass_taps", _longest_candidate_taps)
    seen = {((T, D, M), tfp.fir_decim_plan(T, D, M)) for T, D, M in K4_PATH_SHAPES}
    for fs in (1e6, 2e6, 2.4e6, 5e6, 8e6, 10e6, 16e6, 20e6):
        for multistage in (True, False):
            builds = [TR.am_receiver(fs, 0.2 * fs, fir_mode="pallas", fold_shift=False, multistage=multistage)]
            for variant in (TR.WBFM, TR.NBFM):
                builds.append(TR.fm_receiver(fs, 0.2 * fs, variant, fir_mode="pallas", fold_shift=False,
                                             use_fused=False, multistage=multistage))
            for chain, _ in builds:
                for tick in (RULE_TICK, 1 << 18):
                    seen.update(_k4_stage_launches(chain, tick))
    forms = set()
    for (T, D, M), plan in seen:
        smem = tfp.fir_decim_smem(T, D, plan)
        assert smem == _k4_smem_c_side(T, D, plan) <= tfb.SMEM_LIMIT, (T, D, M, plan)
        assert plan.chunk == T or plan.tile in (tfb.TILES[-1], tfp.OUTPUT_TILES[-1])
        blocks = tfp.fir_decim_blocks(M, plan)
        forms.add(plan.form)
        if plan.form == "phase":
            R, pitch = plan.tile // 32, tfb.phase_pitch(D)
            assert plan.tile in tfp.PHASE_TILES and R % 2 == 1 and pitch % 2 == 1 and pitch >= D
            assert len({(lane * R * pitch) % 16 for lane in range(16)}) == 16, (T, D, M, plan)
            assert D >= tfb.KERNEL_WARPS and blocks >= tfb.PHASE_MIN_BLOCKS, (T, D, M, plan)
        else:
            tiles = tfp.OUTPUT_TILES if plan.form == "outputs" else tfp.TAP_TILES
            assert plan.form == ("outputs" if D < tfb.KERNEL_WARPS else "taps") and plan.tile in tiles
            if plan.chunk == T:  # no tile that fits stages fewer samples on its busiest SM
                others = [plan._replace(tile=t) for t in tiles]
                assert all(tfp.busiest_sm_samples(D, M, o) >= tfp.busiest_sm_samples(D, M, plan)
                           for o in others if tfp.fir_decim_smem(T, D, o) <= tfb.SMEM_LIMIT), (T, D, M, plan)
    assert forms == {"phase", "taps", "outputs"}


@pytest.mark.parametrize(
    "T,D,M,want,blocks",
    [
        (546, 50, 25_600, ("phase", 224), 115),  # the JSON graph's tick: the longest SM filters 224, not 2 x 160
        (546, 50, 40_000, ("phase", 160), 250),  # two rounds of 224 against two blocks of 160 an SM
        (546, 50, 19_200, ("phase", 160), 120),  # 86 blocks of 224 would leave a third of the SMs idle
        (546, 50, 6_400, ("taps", 56), 115),
        (868, 250, 5_120, ("taps", 40), 128),  # AM K4 runner, stage 1: 10,618 samples an SM, where 8 gave 5 x 2,618
        (868, 250, 51_200, ("taps", 56), 915),
        (46, 2, 2_560, ("outputs", 32), 80),  # AM K4 runner, stage 2: 10 blocks of 256 before
        (46, 2, 640_000, ("outputs", 256), 2_500),
        (6665, 500, 2_560, ("taps", 24), 107),  # single-stage AM: one block an SM
        (728, 12, 87_380, ("phase", 224), 391),
        (33, 4, 100, ("outputs", 32), 4),
    ],
)
def test_fir_decim_plan_choices(T, D, M, want, blocks):
    plan = tfp.fir_decim_plan(T, D, M)
    assert (plan.form, plan.tile) == want and plan.chunk == T
    assert tfp.fir_decim_blocks(M, plan) == blocks
    assert tfp.fir_decim_smem(T, D, plan) == _k4_smem_c_side(T, D, plan) <= tfb.SMEM_LIMIT
    if (T, D) == (546, 50):
        five, seven = (plan._replace(form="phase", tile=t) for t in (160, 224))
        assert tfp.fir_decim_smem(T, D, five) == 81_800 and tfp.fir_decim_smem(T, D, seven) == 112_008
        assert tfb.blocks_per_sm(81_800) == tfb.blocks_per_sm(112_008) == 2


def test_fir_decim_plan_chunks_long_taps():
    """Where even the smallest tile does not fit with all the taps, the
    taps go in chunks of a multiple of 32 that fit."""
    for T, D, form in ((30000, 2, "outputs"), (60000, 9, "taps")):
        plan = tfp.fir_decim_plan(T, D, 17_000)
        assert plan.form == form and plan.chunk < T and plan.chunk % 32 == 0
        assert tfp.fir_decim_smem(T, D, plan) <= tfb.SMEM_LIMIT < tfp.fir_decim_smem(T, D, plan._replace(chunk=plan.chunk + 32))


# -- the card's shape rules (F1) ------------------------------------------------------


def _longest_candidate_taps(sample_rate, cutoff, transition_width, db_attenuation=-60.0, dtype=np.float32):
    """Stand-in for design.lowpass_taps: zeros of the longest tap count the
    design can return (its ladder's candidates and the Kaiser fallback), so
    the rule is checked on a superset of the shapes without running Remez."""
    n = max(
        tdesign.fred_harris_tap_count(db_attenuation, transition_width, sample_rate),
        tdesign.bellanger_tap_count(sample_rate, transition_width, 0.01, db_attenuation),
        tdesign.kaiser_tap_count(db_attenuation, transition_width, sample_rate),
    )
    return np.zeros(n, dtype)


RULE_TICK = 1_280_000  # RF samples a tick for the rules that count blocks


def _rf_stage_launches(chain, tick=RULE_TICK):
    """(kernel, (T, D), shared memory bytes, plan) of each RF stage's launch
    on a tick of ``tick`` RF samples; a D-FIR entry's shape is (T, D,
    complex taps, M)."""
    out = []
    n = tick
    for name, b in chain.blocks:
        if isinstance(b, TB.FusedFmDemod) and not b._rows_capable:
            T, D = b.taps.shape[-1], b.decimation
            n //= D  # a streaming tick of N samples behind (T-1) + D of history gives N // D outputs
            plan = tfm.fm_fused_plan(T, D, n)
            out.append(("fm_fused", (T, D, n), tfm.fm_fused_smem(T, D, plan), plan))
        elif isinstance(b, (TB.FusedFmDemod, TB.FreqShiftFir)) or (isinstance(b, TB.Fir) and name.startswith("rf_fir")):
            T, D = b.taps.shape[-1], b.decimation
            cplx_taps = isinstance(b, (TB.FusedFmDemod, TB.FreqShiftFir))
            n //= D
            plan = tfb.decim_fir_plan(T, D, cplx_taps, n)
            out.append(("decim_fir", (T, D, cplx_taps, n), tfb.decim_fir_smem(T, D, cplx_taps, plan), plan))
    return out


def test_tile_rules_fit_every_receiver_stage(monkeypatch):
    """F1: for every RF stage that fm_receiver and am_receiver build at 1-20
    Msps, multistage on and off, fused on and off, the D-FIR and FM-fused
    plans fit one block's shared memory (232,448 B on an H100).  Before the
    repair both kernels staged a fixed 64-output window: 63*D*8 B alone
    passes the limit for D >= 462 (NBFM fused and single-stage AM at
    20 Msps)."""
    monkeypatch.setattr(tdesign, "lowpass_taps", _longest_candidate_taps)
    seen = set()
    for fs in (1e6, 2e6, 2.4e6, 5e6, 8e6, 10e6, 16e6, 20e6):
        for multistage in (True, False):
            builds = [TR.am_receiver(fs, 0.2 * fs, multistage=multistage)]
            for variant in (TR.WBFM, TR.NBFM):
                for fused in (False, True):
                    builds.append(TR.fm_receiver(fs, 0.2 * fs, variant, use_fused=fused, multistage=multistage))
            for chain, _ in builds:
                for kernel, shape, smem, plan in _rf_stage_launches(chain):
                    assert smem <= tfb.SMEM_LIMIT, (fs, kernel, shape, plan, smem)
                    seen.add((kernel, shape, plan))
                    if kernel == "fm_fused":
                        T, D, M = shape
                        assert smem == _fm_fused_smem_c_side(T, D, plan), (shape, plan)
                        assert plan.chunk == T or (plan.form, plan.tile) == ("taps", tfb.TILES[-1])
                        if plan.form == "phase":
                            R, pitch = tfm.PHASE_R, tfb.phase_pitch(D)
                            assert plan.tile == tfm.PHASE_TILE == 32 * R and D >= tfb.KERNEL_WARPS
                            banks = {(lane * R * pitch) % 16 for lane in range(16)}  # 8-byte banks of a half-warp
                            assert len(banks) == 16, (shape, plan)
                            assert tfm.fm_fused_blocks(M, plan) >= tfb.PHASE_MIN_BLOCKS, (shape, plan)
                        else:
                            assert plan.tile in tfb.TILES
    assert any(k == "fm_fused" and s[1] >= 462 for k, s, _ in seen)  # the shapes F1 broke
    assert any(k == "decim_fir" and s[1] >= 462 for k, s, _ in seen)


def _fm_fused_smem_c_side(T, D, plan):
    """csrc/fm_fused.cu, taps_smem_bytes and phase_smem_bytes, written out."""
    if plan.form == "phase":
        Q = -(-T // D)
        return ((plan.tile + Q - 1) * (D | 1) + 8 * plan.tile) * 8 + D * Q * 4
    return ((plan.tile - 1) * D + plan.chunk + plan.tile) * 8 + plan.chunk * 4


@pytest.mark.parametrize(
    "T,D,M,want,blocks",
    [
        (728, 66, 20_000, ("phase", 160), 126),  # NBFM 2 Msps, a 1,320,000-sample tick
        (728, 66, 40_000, ("phase", 160), 252),
        (728, 66, 13_834, ("phase", 160), 88),
        (728, 66, 13_833, ("taps", 32), 447),  # 87 blocks of 159 outputs would leave a third of the SMs idle
        (728, 66, 5_000, ("taps", 16), 334),
        (9660, 666, 625, ("taps", 8), 90),  # one block an SM whatever the tile, one round either way: 16 would be 42 blocks
        (9660, 666, 1_250, ("taps", 16), 84),  # 8 would be 179 blocks: two rounds
        (9660, 666, 2_560, ("taps", 16), 171),  # two rounds against three
        (91, 10, 800, ("taps", 8), 115),
        (546, 50, 25_600, ("phase", 160), 162),
        (46, 2, 640_000, ("taps", 64), 10_159),  # D < 8: six of eight warps would have no phase
    ],
)
def test_fm_fused_plan_choices(T, D, M, want, blocks):
    plan = tfm.fm_fused_plan(T, D, M)
    assert (plan.form, plan.tile) == want and plan.chunk == T
    assert tfm.fm_fused_blocks(M, plan) == blocks
    smem = tfm.fm_fused_smem(T, D, plan)
    assert smem == _fm_fused_smem_c_side(T, D, plan) <= tfb.SMEM_LIMIT
    if (T, D, plan.form) == (728, 66, "phase"):
        assert smem == 171 * 67 * 8 + 8 * 160 * 8 + 66 * 12 * 4 == 105_064
        assert tfb.blocks_per_sm(smem) == 2
        seven = plan._replace(tile=224)  # D-FIR's R = 7, built for the timing probe
        assert tfm.fm_fused_smem(T, D, seven) == _fm_fused_smem_c_side(T, D, seven) == 143_464


def test_tile_rules_chunk_long_taps():
    """Where even 8 outputs do not fit with all the taps, the taps go in
    chunks of a multiple of 32 that fit."""
    assert tfm.fm_fused_plan(728, 66, 2_000) == ("taps", 8, 728)  # NBFM 2 Msps never chunks
    plan = tfb.decim_fir_plan(30000, 2, True, 17_000)
    assert plan.form == "taps" and plan.tile == 8 and plan.chunk < 30000 and plan.chunk % 32 == 0
    assert tfb.decim_fir_smem(30000, 2, True, plan) <= tfb.SMEM_LIMIT
    assert tfb.decim_fir_smem(30000, 2, True, plan._replace(chunk=plan.chunk + 32)) > tfb.SMEM_LIMIT
    for M in (300, 20_000):
        fm = tfm.fm_fused_plan(60000, 666, M)
        assert fm.form == "taps" and fm.tile == 8 and fm.chunk < 60000 and fm.chunk % 32 == 0
        assert tfm.fm_fused_smem(60000, 666, fm) <= tfb.SMEM_LIMIT
        assert tfm.fm_fused_smem(60000, 666, fm._replace(chunk=fm.chunk + 32)) > tfb.SMEM_LIMIT


# -- the card's D-FIR rule and the phase-major form -----------------------------------


def test_decim_fir_plan_over_every_receiver_stage(monkeypatch):
    """The rule over every RF stage the receivers build at 1-20 Msps on a
    tick of 1,280,000 RF samples.  Every plan fits one block's shared
    memory.  Phase-major plans: 224 outputs a block, R and the pitch odd so
    that the half-warps' 64-bit loads are conflict-free (checked bank by
    bank), every warp has a phase, the grid covers two thirds of the SMs.
    Lanes-across-taps plans: where two blocks can share an SM, at least 264
    blocks wherever M >= 264 x the smallest tile; where none can, the
    largest tile that fits.  The plan is a function of (T, D, taps, M)
    alone, so the history and prelude forms of one stage get the same."""
    monkeypatch.setattr(tdesign, "lowpass_taps", _longest_candidate_taps)
    forms = set()
    for fs in (1e6, 2e6, 2.4e6, 5e6, 8e6, 10e6, 16e6, 20e6):
        for multistage in (True, False):
            builds = [TR.am_receiver(fs, 0.2 * fs, multistage=multistage)]
            for variant in (TR.WBFM, TR.NBFM):
                for fused in (False, True):
                    builds.append(TR.fm_receiver(fs, 0.2 * fs, variant, use_fused=fused, multistage=multistage))
            for chain, _ in builds:
                for kernel, shape, smem, plan in _rf_stage_launches(chain):
                    if kernel != "decim_fir":
                        continue
                    T, D, cplx, M = shape
                    assert smem <= tfb.SMEM_LIMIT, (fs, shape, plan, smem)
                    assert plan.chunk == T or (plan.form, plan.tile) == ("taps", tfb.TILES[-1])
                    blocks = -(-M // plan.tile)
                    forms.add(plan.form)
                    if plan.form == "phase":
                        R, pitch = plan.tile // 32, tfb.phase_pitch(D)
                        assert plan.tile == tfb.PHASE_TILE and R % 2 == 1 and pitch % 2 == 1 and pitch >= D
                        banks = {(lane * R * pitch) % 16 for lane in range(16)}  # 8-byte banks of a half-warp
                        assert len(banks) == 16, (shape, plan)
                        assert D >= tfb.KERNEL_WARPS and blocks >= tfb.PHASE_MIN_BLOCKS, (shape, plan)
                    else:
                        assert plan.tile in tfb.TILES
                        if tfb.blocks_per_sm(smem) >= 2:
                            if M >= tfb.MIN_BLOCKS * tfb.TILES[-1]:
                                assert blocks >= tfb.MIN_BLOCKS, (shape, plan)
                        else:
                            bigger = [t for t in tfb.TILES if t > plan.tile]
                            assert all(tfb.decim_fir_smem(T, D, cplx, plan._replace(tile=t, chunk=T)) > tfb.SMEM_LIMIT
                                       for t in bigger), (shape, plan)
                    # history form: M = (H + N - (T-1)) // D with H = T-1; prelude form: M = N // D
                    n = M * D
                    assert tfb.decim_fir_plan(T, D, cplx, ((T - 1) + n - (T - 1)) // D) == plan
                    assert tfb.decim_fir_plan(T, D, cplx, n // D) == plan
    assert forms == {"phase", "taps"}


@pytest.mark.parametrize(
    "T,D,complex_taps,M,want",
    [
        (546, 50, True, 25_600, ("phase", 224)),  # WBFM 20 Msps, a 1,280,000-sample tick: 115 blocks
        (546, 50, True, 51_200, ("phase", 224)),
        (546, 50, True, 19_200, ("taps", 64)),  # 86 blocks of 224 would leave a third of the SMs idle
        (546, 50, True, 6_400, ("taps", 16)),
        (546, 50, False, 25_600, ("phase", 224)),
        (728, 12, True, 87_380, ("phase", 224)),  # the digital app
        (728, 66, True, 20_000, ("phase", 224)),
        (868, 250, True, 5_120, ("taps", 16)),  # AM stage 1: 320 blocks where the 64-output tile gave 80
        (46, 2, False, 2_560, ("taps", 8)),  # AM stage 2
        (46, 2, True, 640_000, ("taps", 64)),  # D < 8: six of eight warps would have no phase
        (2500, 8, True, 6_144, ("taps", 16)),
        (6665, 500, True, 2_560, ("taps", 32)),  # one block an SM whatever the tile: the largest
        (9660, 666, False, 2_560, ("taps", 16)),
        (9660, 666, True, 2_560, ("taps", 8)),
        (33, 4, False, 100, ("taps", 8)),
    ],
)
def test_decim_fir_plan_choices(T, D, complex_taps, M, want):
    plan = tfb.decim_fir_plan(T, D, complex_taps, M)
    assert (plan.form, plan.tile) == want and plan.chunk == T
    assert tfb.decim_fir_smem(T, D, complex_taps, plan) <= tfb.SMEM_LIMIT


def phase_major_form(hist, x, taps, D, s0, M, R=tfb.PHASE_R, warps=tfb.KERNEL_WARPS):
    """The phase-major form of the D-FIR sum with the kernel's own index
    arithmetic (csrc/decim_fir.cu, decim_fir_phase_kernel), in numpy.  Per
    block of 32*R outputs: a window of tile + Q - 1 rows of D samples at an
    odd pitch, zero outside [0, end), where end is one past the last sample
    a tap reads; the reversed taps by phase, hq[p][q] = h_rev[p + q*D],
    Q = ceil(T / D) a phase, zero past T.  Lane l owns outputs l*R ..
    l*R+R-1 and slides a register window of 2R-1 samples down each phase,
    R taps and R new rows a group, the last Q % R taps as a shorter group;
    warp w takes phases w, w+warps, ..; the warps' partial sums are added
    at the end."""
    T = len(taps)
    s = np.concatenate([hist, x])
    tile, Q, pitch = 32 * R, -(-T // D), tfb.phase_pitch(D)
    rows = tile + Q - 1
    end = min(len(s), s0 + (M - 1) * D + T)
    u = np.arange(D)[:, None] + np.arange(Q)[None, :] * D
    hq = np.where(u < T, taps[::-1][np.minimum(u, T - 1)], 0).astype(taps.dtype)
    y = np.zeros(M, np.complex64)
    lane = np.arange(32)
    for m0 in range(0, M, tile):
        win = np.full(rows * pitch, np.nan + 0j, np.complex64)  # a word never staged must never be read
        i = np.arange(rows * D)
        g = s0 + m0 * D + i
        inside = (g >= 0) & (g < end)
        win[i + (i // D) * (pitch - D)] = np.where(inside, s[np.clip(g, 0, len(s) - 1)], 0)
        red = np.zeros((warps, R, 32), np.complex64)
        for wp in range(warps):
            acc = np.zeros((R, 32), np.complex64)
            for p in range(wp, D, warps):
                at = lane * R * pitch + p
                w = [win[at + j * pitch] for j in range(R - 1)] + [None] * R
                at = at + (R - 1) * pitch
                for q0 in range(0, Q, R):
                    K = min(R, Q - q0)  # the last group is the shorter one
                    for j in range(K):
                        w[R - 1 + j] = win[at + j * pitch]
                    for j in range(K):
                        for r in range(R):
                            acc[r] += hq[p, q0 + j] * w[j + r]
                    at = at + R * pitch
                    w[: R - 1] = w[R : 2 * R - 1]
            red[wp] = acc
        out = red.sum(0)
        for j in range(min(tile, M - m0)):
            y[m0 + j] = out[j % R, j // R]
    return y


@pytest.mark.parametrize("s0", [0, 37])
@pytest.mark.parametrize("complex_taps", [False, True])
@pytest.mark.parametrize("T,D", [(546, 50), (868, 250), (46, 2), (728, 12), (2500, 8)])
def test_phase_major_form_matches_plain(rng, T, D, complex_taps, s0):
    """The kernel's phase-major index arithmetic, evaluated in numpy over
    [hist, x] with a ragged last tile and a ragged remainder of x that
    holds NaN (past the last sample a tap reads: it must not be staged),
    against ``decim_fir_plain`` within 1e-5 of peak."""
    M = tfb.PHASE_TILE + 41
    t = (rng.standard_normal(T) / np.sqrt(T)).astype(np.float32)
    if complex_taps:
        t = (t * np.exp(1j * 0.37 * np.arange(T))).astype(np.complex64)
    hist, x = crandn(rng, T - 1 + s0), crandn(rng, M * D + D // 2)
    x[M * D :] = np.nan
    got = phase_major_form(hist, x, t, D, s0, M)
    clean = x.copy()
    clean[M * D :] = 0
    ref = tfb.decim_fir_plain(torch.from_numpy(hist), torch.from_numpy(clean), torch.from_numpy(t), D, s0, M)
    assert np.isfinite(got).all()
    close_to_peak(got, ref.numpy())


# -- FM-fused: the phase-major form and the second pointer ------------------------------


def real_phase_sums(win, hq, T, D, R, warps=tfb.KERNEL_WARPS):
    """The 32*R sums of one block of the phase-major form with real taps and
    a phase's own tap count (csrc/fir_common.cuh, phase_sums and
    add_phase_sums), in numpy, from its staged window and taps by phase.  A
    phase p has Q taps if p < T - (Q-1)*D, else Q - 1; lane l slides its
    register window down the phase R taps a group, the rest as a shorter
    group; warp w takes phases w, w + warps, ..; the warps' partial sums are
    added at the end."""
    Q, pitch = hq.shape[1], tfb.phase_pitch(D)
    full = T - (Q - 1) * D
    lane = np.arange(32)
    red = np.zeros((warps, R, 32), np.complex64)
    for wp in range(warps):
        acc = np.zeros((R, 32), np.complex64)
        for p in range(wp, D, warps):
            Qp = Q if p < full else Q - 1
            at = lane * R * pitch + p
            w = [win[at + j * pitch] for j in range(R - 1)] + [None] * R
            at = at + (R - 1) * pitch
            for q0 in range(0, Qp, R):
                K = min(R, Qp - q0)
                for j in range(K):
                    w[R - 1 + j] = win[at + j * pitch]
                for j in range(K):
                    for r in range(R):
                        acc[r] += hq[p, q0 + j] * w[j + r]
                at = at + R * pitch
                w[: R - 1] = w[R : 2 * R - 1]
        red[wp] = acc
    out = red.sum(0)
    return np.array([out[j % R, j // R] for j in range(32 * R)])


def fm_phase_major_form(hist, x, taps, D, inc, phase0, gain, M, R=tfm.PHASE_R, warps=tfb.KERNEL_WARPS):
    """The phase-major form of FM-fused with the kernel's own index
    arithmetic (csrc/fm_fused.cu, fm_fused_phase_kernel), in numpy.  Block b
    filters the 32*R samples from m0 = b * (32*R - 1) on and owns the 32*R - 1
    outputs from m0 on, so neighbours recompute one overlap sample.  Its
    window is 32*R + Q - 1 rows of D samples at an odd pitch, zero outside
    [0, end), end one past the last sample a tap reads, mixed in place with
    the NCO phase of each sample's place in s = [hist, x]; its sums are
    ``real_phase_sums``."""
    T = len(taps)
    s = np.concatenate([hist, x])
    nv, Q, pitch = 32 * R, -(-T // D), tfb.phase_pitch(D)
    rows, n_out = nv + Q - 1, nv - 1
    end = min(len(s), (T - 1) + (M + 1) * D)
    u = np.arange(D)[:, None] + np.arange(Q)[None, :] * D
    hq = np.where(u < T, taps[::-1][np.minimum(u, T - 1)], 0).astype(np.float32)
    y = np.full(M, np.nan, np.float32)
    for m0 in range(0, M, n_out):
        win = np.full(rows * pitch, np.nan + 0j, np.complex64)  # a word never staged must never be read
        i = np.arange(rows * D)
        g = m0 * D + i
        inside = g < end
        raw = np.where(inside, s[np.minimum(g, len(s) - 1)], 0).astype(np.complex64)
        ph = (phase0 + g * inc) % (1 << 32)
        ang = ph.astype(np.float32) * np.float32(2 * np.pi / 2**32)
        lo = (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)
        win[i + (i // D) * (pitch - D)] = raw * lo
        v = real_phase_sums(win, hq, T, D, R, warps)
        for t in range(min(n_out, M - m0)):
            prod = v[t + 1] * np.conj(v[t])
            y[m0 + t] = gain * np.arctan2(prod.imag, prod.real)
    return y


@pytest.mark.parametrize("R", [5, 7, 3])
@pytest.mark.parametrize("H", ["tail", 0])
@pytest.mark.parametrize("T,D", [(728, 66), (546, 50), (91, 10), (132, 66)])
def test_fm_phase_major_form_matches_plain(rng, T, D, H, R):
    """Two whole blocks and a ragged third (m0 = block * (32R - 1)), the
    history through the second pointer or none, x ending in D // 2 NaN
    samples past the last one a tap reads (never staged), against
    ``fused_fm_demod_plain`` within 1e-5 * gain."""
    M = 2 * (32 * R - 1) + 41
    fs, f_off, gain = 2e6, 250e3, 0.8
    h = np.hamming(T).astype(np.float32)
    h /= h.sum()
    inc, phase0 = int(josc.freq_to_inc_u32(-f_off, fs)), (1 << 32) - 200  # the phase wraps inside the first row
    H = (T - 1) + D if H == "tail" else 0
    z = fm_tone(rng, (T - 1) + (M + 1) * D + D // 2, fs, f_off, 1e3)  # inside the longest filter's passband
    clean = z[: len(z) - D // 2]
    z[len(clean) :] = np.nan
    got = fm_phase_major_form(z[:H], z[H:], h, D, inc, phase0, gain, M, R=R)
    ref = tfm.fused_fm_demod_plain(torch.from_numpy(clean), torch.from_numpy(h), D, inc, phase0, gain, M).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * gain)


@pytest.mark.parametrize("H", ["tail", 0, 5])
@pytest.mark.parametrize("T,D,M", [(91, 10, 800), (728, 66, 300)])
def test_fused_fm_demod_history_is_a_second_pointer(rng, T, D, M, H):
    """``fused_fm_demod(x, ..., history=h)`` is ``fused_fm_demod(cat([h, x]),
    ...)`` bit for bit on the CPU, for the streaming carry of (T-1) + D
    samples, for none and for a short one; M counts both."""
    H = (T - 1) + D if H == "tail" else H
    z = torch.from_numpy(fm_tone(rng, (T - 1) + (M + 1) * D + 3, 2e6, 250e3, 75e3))
    h = torch.from_numpy((rng.standard_normal(T) * 0.05).astype(np.float32))
    inc, ph = int(josc.freq_to_inc_u32(-250e3, 2e6)), tosc.as_phase(int(josc.init_phase(0.3)))
    whole = tfm.fused_fm_demod(z, h, D, inc, ph, 0.8)
    split = tfm.fused_fm_demod(z[H:], h, D, inc, ph, 0.8, history=z[:H])
    assert whole.shape == split.shape == (M,)
    assert torch.equal(whole, split)
    assert tfm.fused_fm_demod(z[: T - 1 + D], h, D, inc, ph, 0.8, history=z[:0]).shape == (0,)


# -- K4: the forms of the new kernel -------------------------------------------------


def k4_phase_major_form(hist, x, taps, D, M, R):
    """K4's phase-major form with the kernel's own index arithmetic
    (csrc/fir_poly.cu, fir_poly_phase), in numpy.  Block b owns the 32*R
    outputs from m0 = b * 32R on; its window is 32*R + Q - 1 rows of D
    samples of s = [hist, x] at an odd pitch, zero from end on, end one past
    the last sample a tap reads; the reversed taps by phase, zero past T."""
    T = len(taps)
    s = np.concatenate([hist, x])
    tile, Q, pitch = 32 * R, -(-T // D), tfb.phase_pitch(D)
    rows = tile + Q - 1
    end = min(len(s), (M - 1) * D + T)
    u = np.arange(D)[:, None] + np.arange(Q)[None, :] * D
    hq = np.where(u < T, taps[::-1][np.minimum(u, T - 1)], 0).astype(np.float32)
    y = np.full(M, np.nan + 0j, np.complex64)
    for m0 in range(0, M, tile):
        win = np.full(rows * pitch, np.nan + 0j, np.complex64)  # a word never staged must never be read
        i = np.arange(rows * D)
        g = m0 * D + i
        win[i + (i // D) * (pitch - D)] = np.where(g < end, s[np.minimum(g, len(s) - 1)], 0)
        v = real_phase_sums(win, hq, T, D, R)
        n = min(tile, M - m0)
        y[m0 : m0 + n] = v[:n]
    return y


def k4_outputs_form(hist, x, taps, D, M, tile, chunk, threads=256):
    """K4's lanes-across-outputs form (csrc/fir_poly.cu, fir_poly_outputs),
    in numpy: block b owns the `tile` outputs from b * tile on; per chunk
    of taps its window of (tile-1)*D + tc samples of s = [hist, x], zero
    from end on; thread t owns output t % tile and takes the taps
    t // tile, t // tile + threads / tile, ..; the groups' partial sums are
    added in group order."""
    T = len(taps)
    s = np.concatenate([hist, x])
    groups = threads // tile
    end = min(len(s), (M - 1) * D + T)
    y = np.full(M, np.nan + 0j, np.complex64)
    o = np.arange(tile)
    for m0 in range(0, M, tile):
        acc = np.zeros((groups, tile), np.complex64)
        for u0 in range(0, T, chunk):
            tc = min(chunk, T - u0)
            g = m0 * D + u0 + np.arange((tile - 1) * D + tc)
            win = np.where(g < end, s[np.minimum(g, len(s) - 1)], 0).astype(np.complex64)
            hr = taps[T - 1 - (u0 + np.arange(tc))]
            for grp in range(groups):
                for u in range(grp, tc, groups):
                    acc[grp] += hr[u] * win[o * D + u]
        out = acc[0]
        for grp in range(1, groups):
            out = out + acc[grp]
        n = min(tile, M - m0)
        y[m0 : m0 + n] = out[:n]
    return y


@pytest.mark.parametrize("H", ["tail", 0])
@pytest.mark.parametrize("R", [5, 7])
@pytest.mark.parametrize("T,D", [(546, 50), (100, 10), (9, 12), (132, 66), (101, 9)])
def test_k4_phase_major_form_matches_plain(rng, T, D, R, H):
    """Two whole blocks and a ragged third, the history through the second
    pointer or none, x ending in D // 2 NaN samples past the last one a tap
    reads (never staged), against ``fir_decim_plain`` within 1e-5 of peak;
    T a multiple of D (every phase has Q taps), T < D (Q = 1: some phases
    have none) and an odd D."""
    M = 2 * 32 * R + 41
    h = (rng.standard_normal(T) / np.sqrt(T)).astype(np.float32)
    H = T - 1 if H == "tail" else 0
    z = crandn(rng, (T - 1) + M * D + D // 2)
    clean = z[: len(z) - D // 2]
    z[len(clean) :] = np.nan
    got = k4_phase_major_form(z[:H], z[H:], h, D, M, R)
    ref = tfp.fir_decim_plain(torch.from_numpy(clean), torch.from_numpy(h), D, M).numpy()
    assert np.isfinite(got).all()
    close_to_peak(got, ref)


@pytest.mark.parametrize("T,D,tile,chunk", [(46, 2, 32, 46), (46, 2, 256, 46), (33, 4, 64, 33), (300, 3, 128, 96),
                                            (5, 7, 32, 5), (46, 2, 32, 20)])
def test_k4_outputs_form_matches_plain(rng, T, D, tile, chunk):
    """Ragged M, the streaming history, taps in chunks (a last short one),
    T < D, and NaN past the last sample a tap reads."""
    M = 2 * tile + 13
    h = (rng.standard_normal(T) / np.sqrt(T)).astype(np.float32)
    z = crandn(rng, (T - 1) + M * D + D // 2)
    clean = z[: len(z) - D // 2]
    z[len(clean) :] = np.nan
    got = k4_outputs_form(z[: T - 1], z[T - 1 :], h, D, M, tile, chunk)
    ref = tfp.fir_decim_plain(torch.from_numpy(clean), torch.from_numpy(h), D, M).numpy()
    assert np.isfinite(got).all()
    close_to_peak(got, ref)


# -- the batched resampler: resample_poly's rule and index arithmetic -----------------


def _resampler_launches(chain, rows, tick=RULE_TICK):
    """(U, D, P, rows, M) of each Resampler with up > 1 in the chain, on the
    granule multiple nearest below ``tick``."""
    tick = chain.granule * max(1, tick // chain.granule)
    lengths = {name: n_in for name, n_in, _ in chain.plan(tick)}
    return [(b.up, b.down, -(-b.taps.shape[-1] // b.up), rows, lengths[name] * b.up // b.down)
            for name, b in chain.blocks if isinstance(b, TB.Resampler) and b.up > 1]


MARINE = [25e3 * k for k in range(-28, 29)]


def test_resample_plan_over_every_receiver_resampler(monkeypatch):
    """For every Resampler with up > 1 that fm_receiver (WBFM, NBFM) and
    am_receiver build at 1-20 Msps to 48, 16 and 8 kHz, and that
    fm_channel_bank and nbfm_channels build at the cells', the JAX config
    4's, the channels app's and the tests' shapes (at all their rows and at
    a shard's, a quarter and an eighth): one block's shared memory within
    232,448 B, a built K dividing the tile, and at least one block an SM
    wherever rows x t allows it."""
    monkeypatch.setattr(tdesign, "lowpass_taps", _longest_candidate_taps)
    launches = set()
    for fs in (1e6, 2e6, 2.4e6, 5e6, 8e6, 10e6, 16e6, 20e6):
        for audio in (48000.0, 16000.0, 8000.0):
            builds = [TR.am_receiver(fs, 0.2 * fs, audio)] + [
                TR.fm_receiver(fs, 0.2 * fs, variant, audio) for variant in (TR.WBFM, TR.NBFM)]
            for chain, _ in builds:
                launches.update(_resampler_launches(chain, 1))
    for chain, info in (TM.fm_channel_bank(20e6, 100, 48000.0), TM.fm_channel_bank(20.48e6, 64, 16000.0),
                        TM.fm_channel_bank(5.12e6, 16, 16000.0), TM.nbfm_channels(2e6, MARINE),
                        TM.nbfm_channels(2e6, MARINE[::4])):
        C = info["num_channels"]
        for rows in (C, -(-C // 4), -(-C // 8)):
            launches.update(_resampler_launches(chain, rows))
    assert {(33, 125, 138, 57), (6, 25, 152, 100), (3, 25, 303, 1)} <= {k[:4] for k in launches}
    for U, D, P, rows, M in sorted(launches):
        plan = trp.resample_plan(U, D, P, rows, M)
        L = trp.group_len(U, D, P)
        assert plan.split in trp.SPLITS and 1 <= plan.tile <= M // U and 1 <= plan.groups <= -(-U // 4)
        assert trp.resample_smem(U, D, L, plan.tile, plan.groups) <= tfb.SMEM_LIMIT, (U, D, P, rows, M, plan)
        assert trp.resample_threads(plan) <= trp.MAX_THREADS, (U, D, P, rows, M, plan)
        blocks = trp.resample_blocks(U, rows, M, plan)
        assert blocks >= min(tfb.SM_COUNT, rows * (M // U)), (U, D, P, rows, M, plan, blocks)
    assert any(trp.resample_plan(*k).groups < -(-k[0] // 4) for k in launches)  # U in the thousands


@pytest.mark.parametrize(
    "U,D,P,rows,M,want,blocks,threads",
    [
        (33, 125, 138, 57, 5_115, (26, 1, 9), 342, 256),  # nbfm.capture: 6 tiles of 26 t a row, 9 groups of classes
        (6, 25, 152, 100, 3_072, (128, 1, 2), 400, 256),  # bank100.capture
        (3, 25, 303, 1, 3_072, (7, 32, 1), 147, 224),  # wbfm.capture: a warp an item; 8 t a block would leave 4 SMs idle
        (3, 25, 303, 1, 315, (1, 32, 1), 105, 32),  # wbfm.live's 2,625-sample block: one t a block
        (198, 125, 37, 1, 52_272, (1, 4, 50), 264, 224),  # NBFM at 2 Msps to 48 kHz, 50 groups of classes
        (1599, 1000, 37, 1, 31_980, (1, 8, 128), 80, 1024),  # 400 groups: 250 KB of taps, so runs of 128
    ],
)
def test_resample_plan_choices(U, D, P, rows, M, want, blocks, threads):
    plan = trp.resample_plan(U, D, P, rows, M)
    assert tuple(plan) == want and trp.resample_blocks(U, rows, M, plan) == blocks
    assert trp.resample_threads(plan) == threads
    L, g = trp.group_len(U, D, P), plan.groups
    window = (plan.tile - 1) * D + 4 * (g - 1) * D // U + 1 + L
    assert trp.resample_smem(U, D, L, plan.tile, g) == g * L * 16 + (window + 4 * g * plan.tile) * 4 <= tfb.SMEM_LIMIT


def test_group_taps_band_each_class():
    """G holds class c's reversed taps at its offset n_c - n_{4g} in column
    c % 4 of group c // 4, and zeros around them and past U."""
    plan = tres.make_plan(tres.design_resampler_taps(6, 25), 6, 25, 250)
    G = trp.group_taps(plan)
    P, n = plan.taps_per_phase, trp.class_starts(6, 25)
    assert G.shape == (2, trp.group_len(6, 25, P), 4) and n.tolist() == [0, 4, 8, 12, 16, 20]
    assert G.shape[1] == P + 12
    hr = plan.frame_taps.reshape(6, -1)[:, :P]
    for c in range(6):
        g, r = divmod(c, 4)
        col = G[g, :, r]
        off = n[c] - n[4 * g]
        np.testing.assert_array_equal(col[off : off + P], hr[c])
        assert not col[:off].any() and not col[off + P :].any()
    assert not G[1, :, 2:].any()


def _kernel_in_numpy(hist, x, G, U, D, M, plan):
    """The kernel's index arithmetic (csrc/resample_poly.cu) in numpy,
    float64: each block's run of groups and window with its zero tail, each
    thread's item and taps, the butterfly over the S threads of an item,
    the interleaved place, the last block's carry.  Returns (y, carry,
    times each output was written)."""
    rows, H = hist.shape
    N = x.shape[1]
    t_count, tile, S, groups = M // U, plan.tile, plan.split, plan.groups
    Ng, L = G.shape[:2]
    tiles, runs = -(-t_count // tile), -(-Ng // groups)
    thr = np.arange(trp.resample_threads(plan))
    item, lane_s = thr // S, thr % S
    gl, tl = item // tile, item % tile
    y, carry, writes = np.full((rows, M), np.nan), np.full((rows, H), np.nan), np.zeros((rows, M), int)
    s_all = np.concatenate([hist, x], axis=1).astype(np.float64)
    for b in range(rows * tiles * runs):
        run, row, t0 = b % runs, b // runs // tiles, (b // runs % tiles) * tile
        tt = min(tile, t_count - t0)
        g0 = run * groups
        gn = min(groups, Ng - g0)
        c0 = 4 * g0
        cw = min(U, 4 * (g0 + gn)) - c0
        nb0 = c0 * D // U
        W = (tile - 1) * D + 4 * (g0 + gn - 1) * D // U - nb0 + L
        assert W <= trp.window_len(U, D, L, tile, groups)
        e = t0 * D + nb0 + np.arange(W)
        win = np.where(e < H + N, s_all[row, np.minimum(e, H + N - 1)], 0.0)
        acc = np.zeros((len(thr), 4))
        for th in thr[gl < gn]:
            ks = np.arange(lane_s[th], L, S)
            idx = tl[th] * D + 4 * (g0 + gl[th]) * D // U - nb0 + ks
            assert idx.max() < W
            acc[th] = win[idx] @ G[g0 + gl[th], ks].astype(np.float64)
        off = S // 2
        while off > 0:
            acc = acc + acc[thr ^ off]
            off //= 2
        out = np.full(tile * cw, np.nan)
        for th in thr[(lane_s == 0) & (gl < gn) & (tl < tt)]:
            for r in range(4):
                c = 4 * gl[th] + r
                if c < cw:
                    out[c + cw * tl[th]] = acc[th, r]
        for i in range(tt * cw):
            m = (t0 + i // cw) * U + c0 + i % cw
            y[row, m] = out[i]
            writes[row, m] += 1
        if t0 + tile >= t_count and run == 0:
            carry[row] = s_all[row, N : N + H]
    return y, carry, writes


@pytest.mark.parametrize(
    "U,D,rows,t,plan",
    [
        (33, 125, 2, 19, (7, 1, 9)),  # the NBFM channels' form: 9 groups, a last tile of 5
        (33, 125, 1, 9, (4, 1, 4)),  # runs of 4 groups: 3 runs a tile, the last of one group and one class
        (6, 25, 3, 40, (16, 1, 2)),  # the bank's: a last tile of 8, a half-empty group
        (6, 25, 1, 21, (32, 1, 2)),  # one tile, short of it
        (3, 25, 1, 30, (7, 32, 1)),  # WBFM's: a warp an item, a last tile of 2
        (3, 25, 2, 7, (1, 32, 1)),
        (12, 125, 2, 9, (4, 8, 2)),  # two runs of two groups
        (5, 2, 2, 12, (5, 2, 2)),  # an even D
    ],
)
def test_resample_kernel_index_arithmetic_matches_plain(rng, U, D, rows, t, plan):
    """The kernel's loop written out in numpy (``_kernel_in_numpy``) on the
    table ``plan_taps`` gives on the card, against the plain version on two
    streamed ticks: every output written once and within 1e-6 of peak, the
    carry bit for bit."""
    plan = trp.ResamplePlan(*plan)
    rp = tres.make_plan(tres.design_resampler_taps(U, D), U, D, t * D)
    P, M = rp.taps_per_phase, rp.block_out
    G, frame = trp.group_taps(rp), tres.plan_taps(rp)
    state = torch.zeros(rows, P - 1)
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((rows, t * D)).astype(np.float32))
        y, carry, writes = _kernel_in_numpy(state.numpy(), x.numpy(), G, U, D, M, plan)
        state, ref = trp.resample_poly_plain(state, x, rp, frame)
        assert (writes == 1).all()
        close_to_peak(y, ref.numpy(), rel=1e-6)
        np.testing.assert_array_equal(carry, state.numpy())


# -- dispatch -------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_without_launching(rng):
    kernels.reset_launch_counts()
    z = torch.from_numpy(crandn(rng, 64 * 4 + 32))
    tfb.banded_fir(z, torch.ones(33), 4)
    tfm.fused_fm_demod(z, torch.ones(33), 4, 123, 0, 1.0)
    tfp.fir_decim(z, torch.ones(33), 4)
    plan = tres.make_plan(tres.design_resampler_taps(3, 25), 3, 25, 250)
    trp.resample_poly(torch.zeros(2, plan.history), torch.ones(2, 250), plan, tres.plan_taps(plan))
    assert [w.launches for w in kernels.WRAPPERS] == [0] * len(kernels.WRAPPERS) == [0] * 9
    assert trp.resample_poly.rows == 0
    assert dispatch.on_cuda(z, None) is False


def test_dispatch_rejects_other_devices():
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.on_cuda(torch.zeros(4, device="meta"))
