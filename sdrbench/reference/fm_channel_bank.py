"""Reference of ``fm_channel_bank`` (every channel of a band demodulated):
the wire samples to complex (int8 words or cf32), a maximally decimated
filterbank (channel k centred at +k fs/M), then per channel the discriminator, one-pole de-emphasis and
the rational resampler.  The prototype lowpass is a Kaiser design made
again here; nothing of the program is imported or read.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from sdrbench.reference import design, dsp


def plan(ref: dict) -> dict:
    m = int(ref["num_channels"])
    cutoff = 0.5 / m  # input rate 1, channel width 1/M
    transition = 0.8 * cutoff
    proto = design.kaiser_lowpass(
        1.0, cutoff - transition / 2, transition, ref["db_attenuation"], num_taps=ref["taps_per_channel"] * m
    )
    chan = float(ref["rf_sample_rate"]) / m
    ratio = Fraction(float(ref["audio_rate"]) / chan).limit_denominator(1000)
    up, dn = ratio.numerator, ratio.denominator
    return {
        "m": m, "proto": np.asarray(proto, np.float64), "chan": chan, "up": up, "dn": dn,
        "audio_taps": dsp.resampler_taps(up, dn, ref["db_attenuation"]),
        "gain": 1.0 / (2.0 * math.pi),  # channel rate over 2 pi times the channel width, which is the rate
        "tau": float(ref["deemphasis_tau"]),
    }


def memory(p: dict) -> int:
    """Input samples an output depends on: the prototype's taps, then at the
    channel rate the discriminator's one sample, the de-emphasis sum and
    the resampler's taps."""
    chan = 1 + dsp.one_pole_taps(p["tau"], p["chan"]) + -(-len(p["audio_taps"]) // p["up"])
    return len(p["proto"]) + chan * p["m"]


def decode(ref: dict, p: dict, iq: torch.Tensor, start: int, dtype) -> torch.Tensor:
    """(M, audio samples) of the wire samples ``iq``, decoded from rest in
    ``dtype``; ``start`` does not matter (no oscillator)."""
    x = dsp.int8_words(iq, dtype) if ref.get("input_format") == "int8" else dsp.cf32(iq, dtype)
    y = dsp.filterbank(x, p["proto"], p["m"])
    a = dsp.fm_discriminate(y, p["gain"])
    a = dsp.one_pole(a, p["tau"], p["chan"])
    return dsp.resample(a, p["up"], p["dn"], p["audio_taps"])
