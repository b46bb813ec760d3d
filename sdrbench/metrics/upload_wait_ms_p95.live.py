"""95th percentile over the blocks of a ``paced`` window of how long a
block waits between the radio and the step, in ms: from the end of its
``source`` span to the start of its ``step`` span, in the traced re-drive
(``spans``): the pinned copy, the upload and the queue."""

import numpy as np

from sdrbench import spans


def read(r):
    if r.mode != "paced" or not spans.on_card(r):
        return None
    t = spans.traced(r)
    wait = spans.upload_wait_ms(t) if t is not None else []
    return float(np.percentile(wait, 95)) if len(wait) else None
