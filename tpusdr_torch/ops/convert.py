"""Sample-format conversion (port of tpusdr/ops/convert.py:1-129).

Int8ToFloat (Int8ToFloat.cpp:89-94) and its int16 and interleaved-IQ
siblings: stateless 1:1 elementwise maps.

Integer IQ keeps the JAX package's contract: one PACKED WORD per complex
sample (an int8 [I, Q] pair as a little-endian int16 word, an int16 pair as
an int32 word), so the stream's rate is 1:1 and its granule 1 whatever the
wire width.  The host views the wire bytes as words for free
(``pack_int8_words``).  A word is split with a dtype view, ``w.view(int8)``
giving the [I, Q] pair, not with shifts.
"""

from __future__ import annotations

import numpy as np
import torch

INT8_SCALE = 1.0 / 128.0  # HackRF-style int8 IQ: -128..127 -> ~[-1, 1)
INT16_SCALE = 1.0 / 32768.0


def int8_to_float(x: torch.Tensor, scale: float = INT8_SCALE) -> torch.Tensor:
    return x.to(torch.float32) * float(np.float32(scale))


def int16_to_float(x: torch.Tensor, scale: float = INT16_SCALE) -> torch.Tensor:
    return x.to(torch.float32) * float(np.float32(scale))


def float_to_int16(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x, -1.0, 1.0) * 32767.0).to(torch.int16)


def interleaved_to_complex(x: torch.Tensor) -> torch.Tensor:
    """[i0, q0, i1, q1, ...] float32 (..., 2N) -> complex64 (..., N)."""
    if x.shape[-1] % 2:
        raise ValueError(f"interleaved IQ needs an even last axis, got {x.shape[-1]}")
    return torch.view_as_complex(x.to(torch.float32).reshape(x.shape[:-1] + (-1, 2)).contiguous())


def complex_to_interleaved(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x.contiguous()).reshape(x.shape[:-1] + (-1,))


def _words_to_complex(w: torch.Tensor, half: torch.dtype, scale: float) -> torch.Tensor:
    pairs = w.contiguous().view(half).reshape(w.shape + (2,))  # [..., (I, Q)]
    f = pairs.to(torch.float32) * float(np.float32(scale))
    return torch.view_as_complex(f)


def int8_words_to_complex(w: torch.Tensor, scale: float = INT8_SCALE) -> torch.Tensor:
    """Packed int8 IQ words -> complex64: ``w`` is int16, one word per
    complex sample, little-endian (I = low byte, Q = high byte)."""
    return _words_to_complex(w, torch.int8, scale)


def int16_words_to_complex(w: torch.Tensor, scale: float = INT16_SCALE) -> torch.Tensor:
    """Packed int16 IQ words (int32, I = low half, Q = high half) -> complex64."""
    return _words_to_complex(w, torch.int16, scale)


def int8_iq_to_complex(x: torch.Tensor, scale: float = INT8_SCALE) -> torch.Tensor:
    """Interleaved int8 IQ (the HackRF wire format) -> complex64."""
    return int8_words_to_complex(x.contiguous().view(torch.int16), scale)


def int16_iq_to_complex(x: torch.Tensor, scale: float = INT16_SCALE) -> torch.Tensor:
    """Interleaved int16 IQ -> complex64."""
    return int16_words_to_complex(x.contiguous().view(torch.int32), scale)


def pack_int8_words(raw: np.ndarray) -> np.ndarray:
    """Host-side zero-copy view of interleaved int8 IQ as int16 words."""
    return np.ascontiguousarray(raw).view(np.int16)


def pack_int16_words(raw: np.ndarray) -> np.ndarray:
    """Host-side zero-copy view of interleaved int16 IQ as int32 words."""
    return np.ascontiguousarray(raw).view(np.int32)
