"""Share of the roofline of the polyphase channelizer stage inside the real
tick: the same work as ``channelizer_roofline_pct``
(``roofline.channelizer_work``) over the stage's median time in the traced
re-drive's replays, between the stamps around it (``spans``)."""

from sdrbench import roofline, spans


def read(r):
    if r.mode != "replay" or not spans.on_card(r):
        return None
    st = spans.stage(r, "Channelizer")
    t = spans.traced(r) if st is not None else None
    us = spans.stage_us(t, st["name"]) if t is not None else None
    if not us:
        return None
    b = st["block"]
    n_bytes, n_ops = roofline.channelizer_work(st["n_in"], b.num_channels, b.taps.shape[-1])
    return roofline.share_pct(n_bytes, n_ops, us * 1e-6)
