"""95th percentile over the blocks of a ``paced`` window of how long a
block's finished audio waits for the drain, in ms: from its tick's last
stamp on the card (on the host's clock) to the start of its ``sink`` span,
in the traced re-drive (``spans``)."""

import numpy as np

from sdrbench import spans


def read(r):
    if r.mode != "paced" or not spans.on_card(r):
        return None
    t = spans.traced(r)
    hold = spans.drain_hold_ms(t) if t is not None else []
    return float(np.percentile(hold, 95)) if len(hold) else None
