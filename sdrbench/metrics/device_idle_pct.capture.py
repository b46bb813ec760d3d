"""Share of the traced slice of a ``replay`` window in which no operation
ran on the card: 100 x (1 - union of device records / slice)."""


def read(r):
    if r.mode != "replay" or r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
