"""Share of the roofline of the FM-fused stage (the first FusedFmChannels
stage: kernel K3, one launch for every channel in the NBFM channels'
``frontend``), stepped alone on the card on the ticks the stages before it
make (``Readings.stage``).  Work: ``fm_fused_work``."""

from sdrbench import roofline
from sdrbench.fm_fused_work import stage_work


def read(r):
    st = r.stage("FusedFmChannels")
    if st is None:
        return None
    return roofline.share_pct(*stage_work(st), st["seconds"])
