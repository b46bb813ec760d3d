"""Share of the roofline of the audio resampler stage (the first
``Resampler``: every row of a bank, or a receiver's one) inside the real
tick: its work (``resampler_work``, counted from the shapes over the
cell's channels) over the stage's median time in the traced re-drive's
replays, from the stamp after the stage before it to the stamp after it
(``spans``)."""

from sdrbench import roofline, spans
from sdrbench.resampler_work import rows_of, stage_work


def read(r):
    if r.mode != "replay" or not spans.on_card(r):
        return None
    st = spans.stage(r, "Resampler")
    t = spans.traced(r) if st is not None else None
    us = spans.stage_us(t, st["name"]) if t is not None else None
    if not us:
        return None
    return roofline.share_pct(*stage_work(st, rows_of(r.cell.info)), us * 1e-6)
