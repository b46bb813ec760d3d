"""Share of the roofline of the FM-fused stage (the first FusedFmChannels
stage: kernel K3 in the NBFM channels' ``frontend``) inside the real tick:
the same work as ``fm_fused_roofline_pct`` (``fm_fused_work``) over the
stage's median time in the traced re-drive's replays, from the stamp after
the stage before it to the stamp after it (``spans``)."""

from sdrbench import roofline, spans
from sdrbench.fm_fused_work import stage_work


def read(r):
    if r.mode != "replay" or not spans.on_card(r):
        return None
    st = spans.stage(r, "FusedFmChannels")
    t = spans.traced(r) if st is not None else None
    us = spans.stage_us(t, st["name"]) if t is not None else None
    if not us:
        return None
    return roofline.share_pct(*stage_work(st), us * 1e-6)
