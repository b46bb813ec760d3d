"""Share of the roofline of the polyphase channelizer stage (branch filter
and FFT, ``ops/channelizer``), stepped alone on the card on the window's
ticks (``Readings.stage``).  Work: ``roofline.channelizer_work``."""

from sdrbench import roofline


def read(r):
    st = r.stage("Channelizer")
    if st is None:
        return None
    b = st["block"]
    n_bytes, n_ops = roofline.channelizer_work(st["n_in"], b.num_channels, b.taps.shape[-1])
    return roofline.share_pct(n_bytes, n_ops, st["seconds"])
