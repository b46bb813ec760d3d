"""The work of the FM-fused stage (``FusedFmChannels``: NCO mix, decimating
real-tap FIR and FM discriminator over C channels, kernel K3), for its
shares of the roofline (``roofline.share_pct``).

Counted from the shapes, so that any implementation reads at most 100%,
and the same whether the channels share a load of the input or not:

  * bytes: the cf32 input read once, C x n_out float32 outputs written
    once, the T float32 taps read once;
  * operations, each of the C channels: the mix, a complex sample times a
    complex oscillator value (4 multiplies, 2 adds) on every input sample;
    the real-tap FIR, 4 operations a tap and output (``decim_fir_work``'s
    count); the discriminator's product v[m+1] conj(v[m]), 6 an output.
    The oscillator's sine and cosine and the atan2 are not counted.
"""

from __future__ import annotations

from sdrbench import roofline


def fm_fused_work(n_in: int, n_taps: int, n_out: int, channels: int) -> tuple[float, float]:
    """(bytes, operations) of C channels demodulated from n_in cf32 samples
    with n_taps real taps, n_out outputs a channel."""
    n_bytes = n_in * roofline.CF32 + channels * n_out * 4 + n_taps * 4
    n_ops = channels * (6.0 * n_in + 4.0 * n_taps * n_out + 6.0 * n_out)
    return float(n_bytes), n_ops


def stage_work(st: dict) -> tuple[float, float]:
    """The work of a ``FusedFmChannels`` stage as ``Readings.stage`` or
    ``spans.stage`` give it ({'block', 'n_in', 'n_out'})."""
    b = st["block"]
    return fm_fused_work(st["n_in"], b.taps.shape[-1], st["n_out"], b.num_channels)
