"""Multi-channel receivers.

``fm_channel_bank`` (port of tpusdr/models/multichannel.py): a polyphase
channelizer and one batched FM demod chain for every channel.  One
``Channelizer`` splits the band once; the stages after it see the channel
axis as a leading batch axis, so one ``QuadFmDemod``, one ``Deemphasis``
and one ``Resampler`` process all channels at once.  None of them reaches
a single-stream kernel: the resampler's decimating FIR takes the plain
banded matmul for a batch of real streams (``ops/fir.py``).

``nbfm_channels``: N narrowband FM pipelines fed from one radio, as
cuda-sdr's sdrtest.cpp:331-364 builds them, each channel its own
downconverter, lowpass and discriminator at any offset: one
``FusedFmChannels`` (kernel K3, one launch a tick for every channel), then
the batched ``Resampler``.
"""

from __future__ import annotations

from fractions import Fraction

from tpusdr_torch.graph.blocks import Channelizer, Deemphasis, FusedFmChannels, QuadFmDemod, Resampler
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.models.receiver import NBFM_CHANNEL_WIDTH, NBFM_DEVIATION, TAU_US, _rational, _rf_decimation
from tpusdr_torch.ops import demod, design
from tpusdr_torch.utils.logging import get_logger

log = get_logger("models")


def fm_channel_bank(
    rf_sample_rate: float,
    num_channels: int,
    audio_rate: float = 48000.0,
    deemphasis_tau: float | None = TAU_US,
    taps_per_channel: int = 12,
    db_attenuation: float = -60.0,
) -> tuple[Chain, dict]:
    """Channelize the band into ``num_channels`` and FM-demodulate each (on
    the CPU; ``.to(device)`` it).

    Input: complex64 IQ at ``rf_sample_rate``; output: (num_channels,
    n_audio) float32 PCM.  Channel k sits at +k*fs/M (mod M); the
    discriminator's gain is set by the channel width, fs/M."""
    m = num_channels
    chan_rate = rf_sample_rate / m
    gain = demod.quad_fm_demod_gain(chan_rate, chan_rate)  # maximally decimated: width = spacing
    fr = Fraction(audio_rate / chan_rate).limit_denominator(1000)
    up, down = fr.numerator, fr.denominator

    blocks = [
        ("channelizer", Channelizer(m, taps_per_channel=taps_per_channel, db_attenuation=db_attenuation)),
        ("demod", QuadFmDemod(gain=gain)),
    ]
    if deemphasis_tau:
        blocks.append(("deemph", Deemphasis(chan_rate, deemphasis_tau)))
    if (up, down) != (1, 1):
        blocks.append(("audio", Resampler(up, down, db_attenuation=db_attenuation)))

    chain = Chain(blocks)
    info = {
        "num_channels": m,
        "channel_rate": chan_rate,
        "audio_rate": chan_rate * up / down,
        "resampler": (up, down),
        "quad_gain": gain,
    }
    log.info("fm channel bank: %d channels @ %.3g Hz each, audio %d/%d -> %.5g Hz",
             m, chan_rate, up, down, info["audio_rate"])
    return chain, info


def nbfm_channels(
    rf_sample_rate: float,
    offsets,
    audio_rate: float = 8000.0,
    channel_width: float = NBFM_CHANNEL_WIDTH,
    deviation: float = NBFM_DEVIATION,
    db_attenuation: float = -60.0,
) -> tuple[Chain, dict]:
    """Demodulate an NBFM channel at each of ``offsets`` (Hz from the
    capture centre) to ``audio_rate`` (on the CPU; ``.to(device)`` it).

    Input: complex64 IQ at ``rf_sample_rate``; output: (len(offsets),
    n_audio) float32 PCM.  Every channel has ``fm_receiver``'s single-stage
    NBFM design: one lowpass of channel_width / 2 decimating to at least
    twice the channel width, designed once for all channels, the
    discriminator's gain set by the channel width, and no de-emphasis.
    ``deviation`` is the channels' peak deviation; it sets nothing of the
    chain (``fm_receiver``'s gain takes the width, not the deviation)."""
    offsets = [float(f) for f in offsets]
    d1 = _rf_decimation(rf_sample_rate, channel_width)
    quad_rate = rf_sample_rate / d1
    taps = design.lowpass_taps(rf_sample_rate, channel_width / 2.0, channel_width / 2.0, db_attenuation)
    gain = demod.quad_fm_demod_gain(quad_rate, channel_width)
    up, down = _rational(quad_rate, audio_rate)

    blocks = [("frontend", FusedFmChannels(rf_sample_rate, [-f for f in offsets], taps, d1, gain))]
    if (up, down) != (1, 1):
        blocks.append(("audio", Resampler(up, down, db_attenuation=db_attenuation)))

    chain = Chain(blocks)
    info = {
        "num_channels": len(offsets),
        "rf_decimation": d1,
        "rf_taps": len(taps),
        "quad_rate": quad_rate,
        "audio_rate": quad_rate * up / down,
        "resampler": (up, down),
        "quad_gain": gain,
        "deviation": float(deviation),
    }
    log.info("nbfm channels: %d channels @ %.3g Hz, %d taps /%d, audio %d/%d -> %.5g Hz",
             len(offsets), quad_rate, len(taps), d1, up, down, info["audio_rate"])
    return chain, info
