"""Median device time between ticks of a ``replay`` window, in us: from one
replay's last stamp to the next replay's first, in the traced re-drive
(``spans``).  It holds the static-input copy, the harness's copy of the
audio out, and any wait for the host."""

import numpy as np

from sdrbench import spans


def read(r):
    if r.mode != "replay" or not spans.on_card(r):
        return None
    t = spans.traced(r)
    gaps = spans.replay_gaps_us(t) if t is not None else []
    return float(np.median(gaps)) if len(gaps) else None
