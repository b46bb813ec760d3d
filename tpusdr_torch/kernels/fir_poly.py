"""Polyphase decimating FIR, complex data x real taps: kernel K4
(``csrc/fir_poly.cu``) and its plain version.

Replaces ``fir_decim_pallas`` (tpusdr/kernels/fir_pallas.py), with the same
contract as ``ops.fir.fir_extended`` for a complex stream and real taps:
x_ext of length L gives M = (L - (T-1)) // D outputs

    y[m] = sum_j taps[j] * x_ext[m*D + T-1-j].

A CUDA tensor launches the kernel; a CPU tensor takes the plain version,
``ops.fir._fir_poly`` on the stacked I and Q (the FC branch of
``fir_extended``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpusdr_torch.kernels.dispatch import check_launch, launch_target, on_cuda

WARP_PER_OUTPUT_MIN_D = 32  # from this decimation on, one warp per output


def fir_decim_plain(x_ext: torch.Tensor, taps: torch.Tensor, D: int, M: int) -> torch.Tensor:
    from tpusdr_torch.ops import fir

    y = fir._fir_poly(torch.stack([x_ext.real, x_ext.imag]), taps, D, M)
    return torch.complex(y[0], y[1])


def _launch(x_ext: torch.Tensor, taps: torch.Tensor, D: int, M: int) -> torch.Tensor:
    from tpusdr_torch.kernels.build import library

    lib = library()
    T = taps.shape[-1]
    if x_ext.dtype != torch.complex64 or x_ext.dim() != 1:
        raise ValueError("fir_decim: x_ext must be a 1-D complex64 tensor")
    if taps.dtype != torch.float32 or taps.dim() != 1:
        raise ValueError("fir_decim: taps must be 1-D float32")
    dev, stream = launch_target(x_ext, lib.tpusdr_fir_poly_smem(T), f"fir_decim (T={T}, D={D})")
    x_ext = x_ext.contiguous()
    taps = taps.contiguous()
    y = torch.empty(M, dtype=torch.complex64, device=x_ext.device)
    err = lib.tpusdr_fir_poly(
        x_ext.data_ptr(), taps.data_ptr(), T, D, M,
        int(D >= WARP_PER_OUTPUT_MIN_D), y.data_ptr(), dev, stream,
    )
    check_launch(err, "fir_decim")
    return y


def fir_decim(x_ext: torch.Tensor, taps, decimation: int) -> torch.Tensor:
    """Decimating FIR of a 1-D complex64 stream with real taps (D >= 2)."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.from_numpy(np.asarray(taps, np.float32)).to(x_ext.device)
    D = int(decimation)
    T = taps.shape[-1]
    if D < 2 or x_ext.dim() != 1 or taps.is_complex():
        raise ValueError("fir_decim takes a 1-D complex stream, real taps and D >= 2")
    M = (x_ext.shape[-1] - (T - 1)) // D
    if M <= 0:
        return torch.zeros(0, dtype=torch.complex64, device=x_ext.device)
    if on_cuda(x_ext, taps):
        y = _launch(x_ext, taps, D, M)
        fir_decim.launches += 1
        return y
    return fir_decim_plain(x_ext, taps, D, M)


fir_decim.launches = 0
