"""Share of the roofline of the RF decimating FIR (the first FreqShiftFir
or Fir stage; kernel K1 in the WBFM chain's ``shiftfir``) inside the real
tick: the same work as ``rf_fir_roofline_pct`` (``roofline.decim_fir_work``)
over the stage's median time in the traced re-drive's replays, from the
stamp after the stage before it to the stamp after it (``spans``)."""

from sdrbench import roofline, spans


def read(r):
    if r.mode != "replay" or not spans.on_card(r):
        return None
    st = spans.stage(r, "FreqShiftFir", "Fir")
    t = spans.traced(r) if st is not None else None
    us = spans.stage_us(t, st["name"]) if t is not None else None
    if not us:
        return None
    b = st["block"]
    complex_taps = type(b).__name__ == "FreqShiftFir" or b.taps.is_complex()
    n_bytes, n_ops = roofline.decim_fir_work(st["n_in"], b.taps.shape[-1], st["n_out"], complex_taps)
    return roofline.share_pct(n_bytes, n_ops, us * 1e-6)
