"""Multi-channel receiver: a polyphase channelizer and one batched FM demod
chain for every channel (port of tpusdr/models/multichannel.py).

One ``Channelizer`` splits the band once; the stages after it see the
channel axis as a leading batch axis, so one ``QuadFmDemod``, one
``Deemphasis`` and one ``Resampler`` process all channels at once.  None of
them reaches a single-stream kernel: the resampler's decimating FIR takes
the plain banded matmul for a batch of real streams (``ops/fir.py``).
"""

from __future__ import annotations

from fractions import Fraction

from tpusdr_torch.graph.blocks import Channelizer, Deemphasis, QuadFmDemod, Resampler
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.models.receiver import TAU_US
from tpusdr_torch.ops import demod
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
