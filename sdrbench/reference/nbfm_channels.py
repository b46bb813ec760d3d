"""Reference of ``nbfm_channels`` (N narrowband FM channels from one
capture): the wire samples to complex, then for each channel a mixer that
brings it to 0 Hz, the RF lowpass (Parks-McClellan, designed again here)
decimated to the quad rate, the discriminator and the rational resampler
to the audio rate; no de-emphasis.  Each stage is the plain sum of
``dsp``; nothing of the program is imported or read.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from sdrbench.reference import design, dsp


def plan(ref: dict) -> dict:
    """The rates and taps a configuration's ``reference`` section implies."""
    fs, cw = float(ref["rf_sample_rate"]), float(ref["channel_width"])
    down = int(fs // (2.0 * cw))
    quad = fs / down
    rf_taps = design.lowpass_taps(fs, cw / 2.0, cw / 2.0, ref["db_attenuation"], dtype=np.float64)
    if len(rf_taps) != ref["rf_taps"]:
        raise ValueError(f"the RF lowpass came out with {len(rf_taps)} taps, the configuration says {ref['rf_taps']}")
    ratio = Fraction(float(ref["audio_rate"]) / quad).limit_denominator(1000)
    up, dn = ratio.numerator, ratio.denominator
    return {
        "down": down, "quad": quad, "rf_taps": rf_taps, "up": up, "dn": dn,
        "audio_taps": dsp.resampler_taps(up, dn, ref["db_attenuation"]),
        "offsets": [Fraction(int(f), int(fs)) for f in ref["offsets"]],
        "gain": quad / (2.0 * math.pi * cw),
    }


def memory(p: dict) -> int:
    """Input samples an output depends on: the RF taps, then at the quad
    rate the discriminator's one sample and the resampler's taps."""
    quad = 1 + -(-len(p["audio_taps"]) // p["up"])
    return len(p["rf_taps"]) + quad * p["down"]


def decode(ref: dict, p: dict, iq: torch.Tensor, start: int, dtype) -> torch.Tensor:
    """(channels, audio samples) of the wire samples ``iq`` (the stream's
    samples from index ``start`` on), decoded from rest in ``dtype``."""
    x = dsp.int8_words(iq, dtype) if ref["input_format"] == "int8" else dsp.cf32(iq, dtype)
    rows = []
    for offset in p["offsets"]:
        v = dsp.fir_decimate(dsp.mix(x, offset, start), p["rf_taps"], p["down"])
        y = dsp.fm_discriminate(v, p["gain"])
        rows.append(dsp.resample(y, p["up"], p["dn"], p["audio_taps"]))
    return torch.stack(rows)
