"""Fused NCO mix -> decimating FIR -> FM discriminator: kernel FM-fused
(``csrc/fm_fused.cu``) and its plain version.

Replaces ``fused_fm_demod_pallas`` (tpusdr/kernels/fm_pallas.py), with the
same contract: ext of length (T-1) + (M+1)*D gives M float32 outputs.  A
CUDA tensor launches the kernel; a CPU tensor takes the plain version, the
torch mix -> ``fir_extended`` -> ``quad_fm_demod_ext`` pipeline.
``fm_fused_plan`` picks the kernel's tile and tap chunk so that one block
fits an H100's shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusdr_torch.kernels.dispatch import check_launch, launch_target, on_cuda
from tpusdr_torch.kernels.fir_banded import SMEM_LIMIT, TILES, tap_chunk


def fm_fused_smem(D: int, nv: int, chunk: int) -> int:
    """Shared memory of one FM-fused block: the mixed window of ``nv``
    filtered samples over ``chunk`` taps, the nv samples, the chunk's taps
    (csrc/fm_fused.cu smem_bytes)."""
    return ((nv - 1) * D + chunk + nv) * 8 + chunk * 4


def fm_fused_plan(T: int, D: int) -> tuple[int, int]:
    """(nv, chunk) of an FM-fused launch: nv filtered samples (nv-1 outputs)
    per block, the largest of 64, 32, 16, 8 that fits ``SMEM_LIMIT`` with
    all T taps, else 8 with taps taken in chunks."""
    for nv in TILES:
        if fm_fused_smem(D, nv, T) <= SMEM_LIMIT:
            return nv, T
    nv = TILES[-1]
    return nv, tap_chunk(T, ((nv - 1) * D + nv) * 8, 12)


def fused_fm_demod_plain(x_ext, taps, D: int, inc_u32: int, phase0_u32: int, gain: float, M: int):
    from tpusdr_torch.ops import demod, fir, osc

    L = (taps.shape[-1] - 1) + (M + 1) * D
    x_ext = x_ext[:L]
    lo = osc.complex_cosine_block(phase0_u32, inc_u32, L, device=x_ext.device)
    v = fir.fir_extended(x_ext * lo, taps, D, "mxu")
    return demod.quad_fm_demod_ext(v, gain)


def _launch(x_ext, taps, D, inc_u32, phase0_u32, gain, M):
    from tpusdr_torch.kernels.build import library

    lib = library()
    T = taps.shape[-1]
    if x_ext.dtype != torch.complex64 or x_ext.dim() != 1:
        raise ValueError("fm_fused: ext must be a 1-D complex64 tensor")
    if taps.dtype != torch.float32 or taps.dim() != 1:
        raise ValueError("fm_fused: taps must be 1-D float32")
    nv, chunk = fm_fused_plan(T, D)
    dev, stream = launch_target(x_ext, lib.tpusdr_fm_fused_smem(D, nv, chunk), f"fm_fused (T={T}, D={D})")
    x_ext = x_ext.contiguous()
    taps = taps.contiguous()
    out = torch.empty(M, dtype=torch.float32, device=x_ext.device)
    err = lib.tpusdr_fm_fused(
        x_ext.data_ptr(),
        x_ext.shape[-1],
        taps.data_ptr(),
        T,
        D,
        int(inc_u32) & 0xFFFFFFFF,
        int(phase0_u32) & 0xFFFFFFFF,
        float(np.float32(gain)),
        M,
        nv,
        chunk,
        out.data_ptr(),
        dev,
        stream,
    )
    check_launch(err, "fm_fused")
    return out


def fused_fm_demod(x_ext: torch.Tensor, taps, decimation: int, inc_u32: int, phase0_u32: int, gain: float) -> torch.Tensor:
    """Fused mix + filter + decimate + discriminate.

    ``phase0_u32`` is the NCO phase (uint32 cycles) of ext sample 0; pass
    ``osc.freq_to_inc_u32(-f_offset, fs)`` as ``inc_u32`` to downconvert a
    channel at +f_offset.  Real taps."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.from_numpy(np.asarray(taps, np.float32)).to(x_ext.device)
    D = int(decimation)
    T = taps.shape[-1]
    M = (x_ext.shape[-1] - (T - 1)) // D - 1
    if M <= 0:
        return torch.zeros(0, dtype=torch.float32, device=x_ext.device)
    if on_cuda(x_ext, taps):
        y = _launch(x_ext, taps, D, inc_u32, phase0_u32, gain, M)
        fused_fm_demod.launches += 1
        return y
    return fused_fm_demod_plain(x_ext, taps, D, inc_u32, phase0_u32, gain, M)


fused_fm_demod.launches = 0
