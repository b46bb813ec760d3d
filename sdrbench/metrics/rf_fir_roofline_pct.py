"""Share of the roofline of the RF decimating FIR (the first FreqShiftFir or
Fir stage; kernel K1 in the WBFM chain's ``shiftfir``), stepped alone on the
card on the ticks the stages before it make (``Readings.stage``).  Work:
``roofline.decim_fir_work``, the folded shift's taps complex."""

from sdrbench import roofline


def read(r):
    st = r.stage("FreqShiftFir", "Fir")
    if st is None:
        return None
    b = st["block"]
    complex_taps = type(b).__name__ == "FreqShiftFir" or b.taps.is_complex()
    n_bytes, n_ops = roofline.decim_fir_work(st["n_in"], b.taps.shape[-1], st["n_out"], complex_taps)
    return roofline.share_pct(n_bytes, n_ops, st["seconds"])
