"""The blocks of the FM receiver's main path (port of tpusdr/graph/blocks.py:
FreqShift :298, Fir :168, FreqShiftFir :372, FusedFmDemod :526,
QuadFmDemod :774, Deemphasis :901, Resampler :953).

Complex streams are complex64 tensors; NCO phases are Python ints (uint32
values) in the carry.  Taps are registered buffers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpusdr_torch.graph.block import Block
from tpusdr_torch.graph.registry import register_block
from tpusdr_torch.kernels import fir_banded
from tpusdr_torch.kernels.fm_fused import fused_fm_demod
from tpusdr_torch.ops import cplx, demod, fir, iir, mix, osc
from tpusdr_torch.ops import resample as resops
from tpusdr_torch.utils.numerics import cdiv

_U32 = 1 << 32


def _mod_taps_np(taps: np.ndarray, inc: int) -> np.ndarray:
    """taps[j] * e^{j theta(T-1-j)}: the shift folded into the taps, with
    angles from the exact uint32 accumulator, evaluated in float64 on the
    host (blocks.py:413-420)."""
    T = len(taps)
    k = (T - 1 - np.arange(T)) * int(inc) % _U32
    ang = k.astype(np.float64) * (2.0 * np.pi / 2.0**32)
    return (taps * np.exp(1j * ang)).astype(np.complex64)


@register_block("FreqShift")
class FreqShift(Block):
    """Fused oscillator + multiply frequency translation."""

    def __init__(self, sample_rate: float, frequency: float, initial_phase: float = 0.0):
        super().__init__()
        self.sample_rate = float(sample_rate)
        self.frequency = float(frequency)
        self.inc = osc.freq_to_inc_u32(frequency, sample_rate)
        self.initial_phase = initial_phase

    def set_inc(self, inc: int) -> None:
        self.inc = int(inc)

    def init_state(self, batch_shape=(), device=None):
        return mix.freq_shift_init(self.initial_phase)

    def apply(self, state, x):
        return mix.freq_shift_apply(state, x, self.inc)

    def shift_state(self, state, offset_samples):
        return (state + self.inc * int(offset_samples)) % _U32

    def advance_state(self, state, num_samples):
        return osc.advance_phase(state, self.inc, num_samples)


@register_block("Fir")
class Fir(Block):
    """Decimating FIR (Fir.cpp + gsdrFirFF/FC/CC/CF).  Modes as in
    ``ops.fir``; 'pallas' (the TPU kernel ``fir_decim_pallas``) is not
    ported yet."""

    def __init__(self, taps, decimation: int = 1, signal_type: str = "FloatComplex", mode: fir.FirMode = "auto"):
        super().__init__()
        if mode in ("pallas", "poly", "fft"):
            raise fir._not_ported(mode)
        self.register_buffer("taps", cplx.from_numpy(np.asarray(taps)))
        self.decimation = int(decimation)
        self.mode = mode
        self.down = self.decimation
        self.history = fir.history_len(self.taps.shape[-1])
        is_cplx = signal_type in ("FloatComplex", "ComplexFloat")
        self.in_dtype = torch.complex64 if is_cplx else torch.float32
        self.out_dtype = torch.complex64 if (is_cplx or self.taps.is_complex()) else torch.float32

    def init_state(self, batch_shape=(), device=None):
        return fir.fir_init_state(
            self.taps.shape[-1], self.in_dtype == torch.complex64, batch_shape, device
        )

    def apply(self, state, x):
        return fir.fir_apply(state, x, self.taps, self.decimation, self.mode)


@register_block("FreqShiftFir")
class FreqShiftFir(Block):
    """Frequency shift folded into a decimating FIR.

    y[m] = e^{j theta(mD)} * sum_k (h_rev[k] e^{j k w}) x[mD + k]: the
    shift lives in the complex taps, and the only other work is one
    rotation at the decimated rate.  In modes 'auto' and 'banded' a single
    stream goes through the D-FIR kernel (history form) on the card."""

    out_dtype = torch.complex64

    def __init__(self, sample_rate: float, frequency: float, taps, decimation: int,
                 initial_phase: float = 0.0, mode: fir.FirMode = "auto"):
        super().__init__()
        taps = np.asarray(taps)
        if np.iscomplexobj(taps):
            raise ValueError("FreqShiftFir folds the shift itself; taps must be real")
        if mode in ("pallas", "poly", "fft"):
            raise fir._not_ported(mode)
        self.sample_rate = float(sample_rate)
        self.frequency = float(frequency)
        self.decimation = int(decimation)
        self.down = self.decimation
        self.mode = mode
        self.initial_phase = float(initial_phase)
        self.history = len(taps) - 1
        self.register_buffer("taps", torch.from_numpy(taps.astype(np.float32)))
        self.register_buffer("mod_taps", torch.zeros(len(taps), dtype=torch.complex64))
        self.set_inc(osc.freq_to_inc_u32(frequency, sample_rate))

    def set_inc(self, inc: int) -> None:
        """Set the NCO increment and refold the shifted taps."""
        self.inc = int(inc)
        mod = _mod_taps_np(self.taps.cpu().numpy(), self.inc)
        self.mod_taps.copy_(torch.from_numpy(mod))

    def init_state(self, batch_shape=(), device=None):
        T = self.taps.shape[-1]
        # phase of the first history sample: T-1 zeros precede the stream
        back = (osc.init_phase(self.initial_phase) - self.inc * (T - 1)) % _U32
        return {"tail": cplx.zeros(tuple(batch_shape) + (T - 1,), device), "phase": back}

    def apply(self, state, x):
        n = x.shape[-1]
        hist = self.taps.shape[-1] - 1
        tail = state["tail"]
        if self.mode in ("auto", "banded") and x.dim() == 1:
            v = fir_banded.banded_fir(x, self.mod_taps, self.decimation, history=tail)
            if n >= hist:
                new_tail = x[n - hist :].clone()
            else:
                new_tail = torch.cat([tail, x])[-hist:].clone()
        else:
            ext = torch.cat([tail, x], dim=-1)
            mode = "mxu" if self.mode in ("auto", "banded") else self.mode
            v = fir.fir_extended(ext, self.mod_taps, self.decimation, mode)
            new_tail = ext[..., ext.shape[-1] - hist :].clone()
        rot = osc.complex_cosine_block(
            state["phase"], self.inc * self.decimation % _U32, v.shape[-1], device=x.device
        )
        new_state = {"tail": new_tail, "phase": (state["phase"] + self.inc * n) % _U32}
        return new_state, v * rot

    def shift_state(self, state, offset_samples):
        return {**state, "phase": (state["phase"] + self.inc * int(offset_samples)) % _U32}

    def advance_state(self, state, num_samples):
        return {**state, "phase": osc.advance_phase(state["phase"], self.inc, num_samples)}


@register_block("FusedFmDemod")
class FusedFmDemod(Block):
    """Fused shift -> decimating FIR -> FM discriminator (blocks.py:526).

    Three branches, chosen by the JAX package's shape rules:
      * whole-row ticks (``prelude_eligible``): the D-FIR kernel in prelude
        form over the tick and 8 carried rows of G = 128*D samples, then
        the discriminator with the carried previous output ``vprev``;
      * other ticks of a row-capable shape: the D-FIR kernel in history
        form;
      * shapes the banded rule rejects: the FM-fused kernel.
    With the shift folded into the taps, the discriminator product
    v[k] conj(v[k-1]) carries a constant rotation e^{j*D*w}, removed by one
    audio-rate complex rotation before ``atan2``.
    Carry: ``tail`` (8G samples when row-capable, else (T-1)+D), ``phase``
    (uint32 int of the first carried sample), ``vprev``.
    """

    out_dtype = torch.float32

    def __init__(self, sample_rate: float, frequency: float, taps, decimation: int, gain: float):
        super().__init__()
        taps = np.asarray(taps, np.float32)
        self.sample_rate = float(sample_rate)
        self.frequency = float(frequency)
        self.decimation = int(decimation)
        self.down = self.decimation
        self.gain = float(gain)
        T = len(taps)
        self.history = (T - 1) + self.decimation
        self._G, _ = fir_banded.prelude_plan(T, self.decimation)
        self._rows_capable = fir_banded.eligible(T, self.decimation, True)
        self._tail_len = fir_banded._GUARD * self._G if self._rows_capable else self.history
        self.register_buffer("taps", torch.from_numpy(taps))
        self.register_buffer("mod_taps", torch.zeros(T, dtype=torch.complex64))
        self.set_inc(osc.freq_to_inc_u32(frequency, sample_rate))

    def set_inc(self, inc: int) -> None:
        """Set the NCO increment and refold the shifted taps."""
        self.inc = int(inc)
        self.mod_taps.copy_(torch.from_numpy(_mod_taps_np(self.taps.cpu().numpy(), self.inc)))
        wd = (self.inc * self.decimation % _U32) * (2.0 * np.pi / 2.0**32)
        self._rot = (float(np.float32(np.cos(wd))), float(np.float32(np.sin(wd))))

    @property
    def granule(self) -> int:
        return fir_banded._GUARD * self._G if self._rows_capable else self.down

    def init_state(self, batch_shape=(), device=None):
        if batch_shape:
            raise ValueError("FusedFmDemod is a single-stream block")
        return {
            "tail": cplx.zeros((self._tail_len,), device),
            "phase": (-self.inc * self._tail_len) % _U32,
            "vprev": cplx.zeros((1,), device),
        }

    def apply(self, state, x):
        n = x.shape[-1]
        T = self.taps.shape[-1]
        D = self.decimation
        tail = state["tail"]
        new_vprev = state["vprev"]
        if self._rows_capable and fir_banded.prelude_eligible(T, D, n, True):
            pre = tail.reshape(fir_banded._GUARD, self._G)
            v = fir_banded.banded_fir_prelude(x, pre, self.mod_taps, D)
            vfull = torch.cat([state["vprev"], v])
            y = self._discriminate(vfull[1:], vfull[:-1])
            new_vprev = v[-1:].clone()
        elif self._rows_capable:
            v = fir_banded.banded_fir(x, self.mod_taps, D, history=tail[-self.history :])
            y = self._discriminate(v[1:], v[:-1])
            new_vprev = v[-1:].clone()
        else:
            # phase of ext[0]: the carry is tail_len samples deep, ext
            # starts history samples back
            ph = (state["phase"] + self.inc * (self._tail_len - self.history)) % _U32
            ext = torch.cat([tail[-self.history :], x])
            y = fused_fm_demod(ext, self.taps, D, self.inc, ph, self.gain)
        L = self._tail_len
        new_tail = x[n - L :].clone() if n >= L else torch.cat([tail, x])[-L:].clone()
        new_state = {
            "tail": new_tail,
            "phase": (state["phase"] + self.inc * n) % _U32,
            "vprev": new_vprev,
        }
        return new_state, y

    def _discriminate(self, v_cur, v_prev):
        prod = v_cur * v_prev.conj()
        c, s = self._rot
        pr = prod.real * c - prod.imag * s
        pi = prod.real * s + prod.imag * c
        return self.gain * demod.arg(pi, pr)

    def shift_state(self, state, offset_samples):
        return {**state, "phase": (state["phase"] + self.inc * int(offset_samples)) % _U32}

    def advance_state(self, state, num_samples):
        return {**state, "phase": osc.advance_phase(state["phase"], self.inc, num_samples)}


@register_block("QuadFmDemod")
class QuadFmDemod(Block):
    """FM discriminator (QuadFmDemod.cpp:76-113). Carry: 1 complex sample."""

    history = 1
    out_dtype = torch.float32

    def __init__(self, gain: float | None = None, sample_rate: float | None = None,
                 channel_width: float | None = None):
        super().__init__()
        if gain is None:
            if sample_rate is None or channel_width is None:
                raise ValueError("need gain or (sample_rate, channel_width)")
            gain = demod.quad_fm_demod_gain(sample_rate, channel_width)
        self.gain = float(gain)

    def init_state(self, batch_shape=(), device=None):
        return demod.quad_fm_demod_init(batch_shape, device)

    def apply(self, state, x):
        return demod.quad_fm_demod_apply(state, x, self.gain)


@register_block("Deemphasis")
class Deemphasis(Block):
    """FM de-emphasis one-pole IIR.  ``history`` is the warm-up after which
    the initial state's influence is below -140 dB."""

    in_dtype = torch.float32
    out_dtype = torch.float32
    _MAX_IIR_WARMUP = 1 << 15

    def __init__(self, sample_rate: float, tau: float = 75e-6):
        super().__init__()
        self.tau = tau
        self.sample_rate = sample_rate
        self.set_coeffs(*iir.deemphasis_coeffs(tau, sample_rate))

    def set_coeffs(self, a: float, b: float) -> None:
        self.a, self.b = float(a), float(b)
        warmup = int(math.ceil(math.log(1e-7) / math.log(self.a)))
        self.time_shardable = warmup <= self._MAX_IIR_WARMUP
        self.history = warmup if self.time_shardable else 1

    def init_state(self, batch_shape=(), device=None):
        return iir.single_pole_init(batch_shape, device)

    def apply(self, state, x):
        return iir.single_pole_apply(state, x, self.a, self.b)


@register_block("Resampler")
class Resampler(Block):
    """Rational polyphase resampler."""

    def __init__(self, up: int, down: int, taps=None, db_attenuation: float = -60.0,
                 signal_type: str = "Float"):
        super().__init__()
        g = math.gcd(int(up), int(down))
        self.up, self.down = int(up) // g, int(down) // g
        is_cplx = signal_type in ("FloatComplex", "ComplexFloat")
        self.in_dtype = torch.complex64 if is_cplx else torch.float32
        self.out_dtype = self.in_dtype
        if taps is None:
            taps = resops.design_resampler_taps(self.up, self.down, db_attenuation)
        self.register_buffer("taps", torch.from_numpy(np.asarray(taps, np.float32)))
        self.history = cdiv(len(taps), self.up) - 1
        self._plans: dict[int, resops.ResamplerPlan] = {}
        self._frame_taps: dict[tuple[int, str], torch.Tensor] = {}

    def _plan(self, n: int) -> resops.ResamplerPlan:
        if n not in self._plans:
            self._plans[n] = resops.make_plan(self.taps.cpu().numpy(), self.up, self.down, n)
        return self._plans[n]

    def init_state(self, batch_shape=(), device=None):
        dt = self.in_dtype
        return torch.zeros(tuple(batch_shape) + (self.history,), dtype=dt, device=device)

    def apply(self, state, x):
        n = x.shape[-1]
        plan = self._plan(n)
        key = (n, str(x.device))
        if key not in self._frame_taps:
            self._frame_taps[key] = torch.from_numpy(plan.frame_taps).to(x.device)
        return resops.resample_apply(state, x, plan, self._frame_taps[key])
