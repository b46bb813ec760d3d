"""The radio's samples, made from the seed on the card.

A broadcast-like band: FM stations, each a carrier with one audio tone,
plus Gaussian noise, in the wire format the radio sends (int8 IQ words or
cf32).  The stations' sum repeats every ``period`` samples (their
carriers and tones are whole multiples of rate/period), so it is made
once; the noise is drawn fresh for every sample, so no two blocks are
alike.  A configuration's ``signal`` section gives the stations, their
level, deviation and tone range and the noise; the seed picks each
station's tone and phases and the noise.  Every seed gives the same sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Band:
    def __init__(self, cfg: dict, seed: int, device):
        sig = cfg["signal"]
        fs = float(cfg["rf_sample_rate"])
        self.period = L = int(sig["period"])
        self.wire = cfg["wire"]
        self.noise_rms = float(sig["noise_rms"])
        self.device = torch.device(device)
        res = fs / L  # Hz a bin: carriers and tones are whole bins
        offsets = sig["station_offsets_hz"]
        if offsets == "channels":
            m = int(cfg["build"]["kwargs"]["num_channels"])
            offsets = [k * fs / m for k in range(m)]
        rng = np.random.default_rng(seed)
        lo, hi = sig["tone_hz"]
        i = torch.arange(L, dtype=torch.int64, device=self.device)
        clean = torch.zeros(L, dtype=torch.complex128, device=self.device)
        for f in offsets:
            kc = round(f / res) % L
            if abs(kc * res - f % fs) > 1e-6 * fs:
                raise ValueError(f"station at {f} Hz is not a whole multiple of {res} Hz")
            km = int(rng.integers(math.ceil(lo / res), math.floor(hi / res) + 1))
            beta = float(sig["deviation_hz"]) / (km * res)
            ph_c, ph_m = rng.uniform(0.0, 2.0 * math.pi, 2)
            carrier = (kc * i % L).to(torch.float64) * (2.0 * math.pi / L) + ph_c
            tone = (km * i % L).to(torch.float64) * (2.0 * math.pi / L) + ph_m
            clean += float(sig["station_amplitude"]) * torch.polar(
                torch.ones_like(carrier), carrier + beta * torch.sin(tone)
            )
        self.clean = clean.to(torch.complex64)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def samples(self, start: int, n: int) -> torch.Tensor:
        """complex64 samples start .. start+n-1 of the band (fresh noise)."""
        parts, pos = [], start % self.period
        left = n
        while left:
            k = min(left, self.period - pos)
            parts.append(self.clean[pos : pos + k])
            left -= k
            pos = 0
        z = parts[0] if len(parts) == 1 else torch.cat(parts)
        noise = torch.randn((n, 2), generator=self.gen, device=self.device) * self.noise_rms
        return z + torch.view_as_complex(noise)

    def to_wire(self, z: torch.Tensor) -> torch.Tensor:
        """int8 IQ as little-endian int16 words (I the low byte), scaled by
        128 and clipped as the radio's ADC does; or cf32 as it is."""
        if self.wire == "cf32":
            return z
        q = torch.round(torch.view_as_real(z) * 128.0).clamp_(-128, 127).to(torch.int8)
        return q.view(torch.int16).reshape(-1)

    def block(self, start: int, n: int) -> torch.Tensor:
        return self.to_wire(self.samples(start, n))
