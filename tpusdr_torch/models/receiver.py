"""Single-channel RF -> PCM receivers (port of
tpusdr/models/receiver.py:43-315, 421-441).

    [iq convert] -> freq shift -> RF lowpass FIR (decimate) ->
    FM discriminator | AM envelope -> de-emphasis | DC block ->
    [audio band-pass] -> rational audio resampler -> PCM

The resolution rules are the JAX package's: ``use_fused="auto"`` resolves
to the unfused chain and ``multistage=True`` designs the RF decimation
cascade, so the defaults build the same chain, granule and taps in both
packages.  Band constants mirror fm.h: NBFM 15 kHz / 5 kHz deviation,
WBFM 200 kHz / 75 kHz deviation.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

from tpusdr_torch.graph.blocks import (
    DcBlock,
    Deemphasis,
    Fir,
    FreqShift,
    FreqShiftFir,
    FusedFmDemod,
    IqToComplex,
    QuadAmDemod,
    QuadFmDemod,
    Resampler,
)
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.ops import demod, design
from tpusdr_torch.utils.logging import get_logger

log = get_logger("models")

TAU_EU = 50e-6
TAU_US = 75e-6
NBFM_CHANNEL_WIDTH = 15e3
WBFM_CHANNEL_WIDTH = 200e3
NBFM_DEVIATION = 5e3
WBFM_DEVIATION = 75e3
AM_BANDWIDTH = 10e3

NBFM = "nbfm"
WBFM = "wbfm"
AM = "am"


@dataclass(frozen=True)
class ReceiverSpec:
    """Resolved rates/design of a receiver chain."""

    rf_sample_rate: float
    channel_width: float
    rf_decimation: int
    quad_rate: float
    audio_rate: float
    rf_taps: int  # total taps across RF decimation stages
    resampler: tuple[int, int]
    quad_gain: float
    rf_stages: tuple[tuple[int, int], ...] = ()  # (taps, decim) per stage


def _rf_decimation(rf_rate: float, channel_width: float, min_oversample: float = 2.0):
    """Largest integer decimation keeping quad rate >= min_oversample * cw."""
    return max(1, int(rf_rate // (min_oversample * channel_width)))


def _rational(from_rate: float, to_rate: float, limit: int = 1000) -> tuple[int, int]:
    fr = Fraction(to_rate / from_rate).limit_denominator(limit)
    return fr.numerator, fr.denominator


def _shift_and_fir_stages(rf_sample_rate, freq_offset, rf_stages, fir_mode, fold_shift):
    """Front-end blocks: frequency shift + RF decimation cascade; with
    ``fold_shift`` the shift is folded into stage 1 (FreqShiftFir)."""
    blocks = []
    t1, d1 = rf_stages[0]
    single = len(rf_stages) == 1
    if freq_offset and fold_shift:
        name = "shiftfir" if single else "shiftfir1"
        blocks.append((name, FreqShiftFir(rf_sample_rate, -freq_offset, t1, d1, mode=fir_mode)))
        rest = rf_stages[1:]
        start = 2
    else:
        if freq_offset:
            blocks.append(("shift", FreqShift(rf_sample_rate, -freq_offset)))
        rest = rf_stages
        start = 1
        if single:
            blocks.append(("rf_fir", Fir(t1, d1, "FloatComplex", fir_mode)))
            return blocks
    for i, (t, d) in enumerate(rest, start):
        blocks.append((f"rf_fir{i}", Fir(t, d, "FloatComplex", fir_mode)))
    return blocks


def fm_receiver(
    rf_sample_rate: float,
    freq_offset: float = 0.0,
    variant: str = WBFM,
    audio_rate: float = 48000.0,
    channel_width: float | None = None,
    deviation: float | None = None,
    deemphasis_tau: float | None = TAU_US,
    input_format: str = "cf32",
    db_attenuation: float = -60.0,
    fir_mode: str = "auto",
    use_fused: bool | str = "auto",
    multistage: bool = True,
    fold_shift: bool = True,
) -> tuple[Chain, ReceiverSpec]:
    """Build a WBFM/NBFM receiver chain (on the CPU; ``.to(device)`` it).

    ``freq_offset`` is the channel centre relative to the capture centre.
    ``use_fused=True`` replaces shift -> FIR -> demod with ``FusedFmDemod``.
    ``input_format`` other than 'cf32' puts ``IqToComplex`` first."""
    if channel_width is None:
        channel_width = WBFM_CHANNEL_WIDTH if variant == WBFM else NBFM_CHANNEL_WIDTH
    if deviation is None:
        deviation = WBFM_DEVIATION if variant == WBFM else NBFM_DEVIATION

    d1 = _rf_decimation(rf_sample_rate, channel_width)
    quad_rate = rf_sample_rate / d1
    cutoff = channel_width / 2.0
    transition = channel_width / 2.0
    if multistage and use_fused is not True:
        rf_stages = design.decimation_stages(rf_sample_rate, cutoff, transition, db_attenuation, d1)
    else:
        rf_stages = [(design.lowpass_taps(rf_sample_rate, cutoff, transition, db_attenuation), d1)]
    if use_fused == "auto":
        use_fused = False  # the JAX package's resolution (receiver.py:176-187)
    rf_taps = rf_stages[0][0]
    gain = demod.quad_fm_demod_gain(quad_rate, channel_width)
    up, down = _rational(quad_rate, audio_rate)
    actual_audio = quad_rate * up / down

    blocks = []
    if input_format != "cf32":
        blocks.append(("iq", IqToComplex(input_format)))
    if use_fused:
        blocks.append(("frontend", FusedFmDemod(rf_sample_rate, -freq_offset, rf_taps, d1, gain)))
    else:
        blocks.extend(_shift_and_fir_stages(rf_sample_rate, freq_offset, rf_stages, fir_mode, fold_shift))
        blocks.append(("demod", QuadFmDemod(gain=gain)))
    if deemphasis_tau:
        blocks.append(("deemph", Deemphasis(quad_rate, deemphasis_tau)))
    if (up, down) != (1, 1):
        blocks.append(("audio", Resampler(up, down, db_attenuation=db_attenuation)))

    chain = Chain(blocks)
    spec = ReceiverSpec(
        rf_sample_rate=rf_sample_rate,
        channel_width=channel_width,
        rf_decimation=d1,
        quad_rate=quad_rate,
        audio_rate=actual_audio,
        rf_taps=sum(len(t) for t, _ in rf_stages),
        resampler=(up, down),
        quad_gain=gain,
        rf_stages=tuple((len(t), d) for t, d in rf_stages),
    )
    log.info(
        "%s receiver: fs=%.3g, RF stages %s -> quad %.3g, audio %d/%d -> %.5g Hz",
        variant, rf_sample_rate, spec.rf_stages, quad_rate, up, down, actual_audio,
    )
    return chain, spec


def am_receiver(
    rf_sample_rate: float,
    freq_offset: float = 0.0,
    audio_rate: float = 48000.0,
    bandwidth: float = AM_BANDWIDTH,
    input_format: str = "cf32",
    db_attenuation: float = -60.0,
    fir_mode: str = "auto",
    audio_band: tuple[float, float] | None = None,
    multistage: bool = True,
    fold_shift: bool = True,
) -> tuple[Chain, ReceiverSpec]:
    """AM envelope receiver (the am_test.cpp chain): shift -> lowpass
    decimation -> QuadAmDemod -> DC block (the carrier-bias removal) ->
    [audio band-pass] -> resampler.  ``fir_mode='pallas'`` needs
    ``fold_shift=False`` (FreqShiftFir has no K4 form)."""
    d1 = _rf_decimation(rf_sample_rate, bandwidth, min_oversample=4.0)
    quad_rate = rf_sample_rate / d1
    if multistage:
        rf_stages = design.decimation_stages(
            rf_sample_rate, bandwidth / 2.0, bandwidth / 2.0, db_attenuation, d1
        )
    else:
        rf_stages = [
            (design.lowpass_taps(rf_sample_rate, bandwidth / 2.0, bandwidth / 2.0, db_attenuation), d1)
        ]
    up, down = _rational(quad_rate, audio_rate)

    blocks = []
    if input_format != "cf32":
        blocks.append(("iq", IqToComplex(input_format)))
    blocks.extend(_shift_and_fir_stages(rf_sample_rate, freq_offset, rf_stages, fir_mode, fold_shift))
    blocks.append(("demod", QuadAmDemod()))
    blocks.append(("dc", DcBlock()))
    if audio_band is not None:
        lo, hi = audio_band
        bp = design.bandpass_taps(quad_rate, lo, hi, transition_width=lo, db_attenuation=db_attenuation)
        blocks.append(("audio_bp", Fir(bp, 1, "Float", fir_mode)))
    if (up, down) != (1, 1):
        blocks.append(("audio", Resampler(up, down, db_attenuation=db_attenuation)))

    chain = Chain(blocks)
    spec = ReceiverSpec(
        rf_sample_rate=rf_sample_rate,
        channel_width=bandwidth,
        rf_decimation=d1,
        quad_rate=quad_rate,
        audio_rate=quad_rate * up / down,
        rf_taps=sum(len(t) for t, _ in rf_stages),
        resampler=(up, down),
        quad_gain=1.0,
        rf_stages=tuple((len(t), d) for t, d in rf_stages),
    )
    log.info(
        "am receiver: fs=%.3g, RF stages %s -> quad %.3g, audio %d/%d -> %.5g Hz",
        rf_sample_rate, spec.rf_stages, quad_rate, up, down, spec.audio_rate,
    )
    return chain, spec


def rf_to_pcm(
    modulation: str,
    rf_sample_rate: float,
    tuned_frequency: float,
    channel_frequency: float,
    audio_rate: float = 48000.0,
    **kw,
) -> tuple[Chain, ReceiverSpec]:
    """IRfToPcmAudioFactory::createRfToPcm parity (FilterFactories.h:159-175):
    modulation plus tuned and channel frequencies."""
    offset = channel_frequency - tuned_frequency
    m = modulation.lower()
    if m in ("fm", "wbfm"):
        return fm_receiver(rf_sample_rate, offset, WBFM, audio_rate, **kw)
    if m == "nbfm":
        return fm_receiver(rf_sample_rate, offset, NBFM, audio_rate, deemphasis_tau=None, **kw)
    if m == "am":
        return am_receiver(rf_sample_rate, offset, audio_rate, **kw)
    raise ValueError(f"unknown modulation {modulation!r}")
