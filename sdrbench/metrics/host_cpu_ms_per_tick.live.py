"""The process's CPU time (every thread, from the OS) over a ``paced``
window, outside the traced slice, a block delivered, in ms."""


def read(r):
    w = r.window
    if r.mode != "paced" or w.host_ticks <= 0:
        return None
    return w.host_cpu_s * 1e3 / w.host_ticks
