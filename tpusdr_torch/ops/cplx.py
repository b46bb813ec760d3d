"""Complex data at the edges of the port.

Inside ``tpusdr_torch`` a complex stream is a ``torch.complex64`` tensor:
interleaved (re, im) float32 pairs, which is what a CUDA kernel wants (one
8-byte ``float2`` load per sample).  The JAX package keeps planar
``Complex(re, im)`` pairs only because its TPU backend has no complex dtype
(tpusdr/ops/cplx.py); these helpers convert between the two layouts and
between numpy and torch, and are used at the API edge only.
"""

from __future__ import annotations

import numpy as np
import torch


def pair_to_tensor(re, im, device=None) -> torch.Tensor:
    """Planar (re, im) float arrays -> complex64 tensor."""
    z = np.asarray(re, np.float32) + 1j * np.asarray(im, np.float32)
    return torch.from_numpy(z.astype(np.complex64)).to(device)


def tensor_to_pair(z: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """complex64 tensor -> planar (re, im) float32 numpy arrays."""
    a = z.detach().cpu().numpy()
    return a.real.astype(np.float32), a.imag.astype(np.float32)


def from_numpy(a, device=None) -> torch.Tensor:
    """numpy array -> tensor: complex data as complex64, real as float32."""
    a = np.asarray(a)
    dt = np.complex64 if np.iscomplexobj(a) else np.float32
    return torch.from_numpy(np.ascontiguousarray(a.astype(dt))).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def zeros(shape, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.complex64, device=device)


def expj(theta: torch.Tensor) -> torch.Tensor:
    """exp(j*theta) for real float32 theta."""
    return torch.complex(torch.cos(theta), torch.sin(theta))
