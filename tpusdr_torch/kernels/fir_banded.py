"""Decimating complex FIR: kernel D-FIR (``csrc/decim_fir.cu``) and its
plain version.

On the TPU the JAX package has two banded Pallas kernels
(tpusdr/kernels/fir_banded_pallas.py): the history form
``banded_fir_pallas`` and the zero-copy streaming form
``banded_fir_prelude``.  On the card both are one CUDA kernel over the
virtual concatenation s = [history, x], read through two pointers:

    y[m] = sum_{u<T} h_rev[u] * s[s0 + m*D + u],   m < M.

The two entry points keep the JAX signatures and output contracts.  A
CUDA tensor launches the kernel; a CPU tensor takes the plain version, the
banded ``torch.matmul`` form of ``ops.fir._fir_mxu_cc``.

``decim_fir_plan`` is the card's shape rule: from (T, D, M) it picks the
kernel's inner loop (phase-major with register reuse for a long tick at a
moderate D, lanes across taps else), its tile (outputs per block) and tap
chunk, so that one block's shared memory stays within an H100's 232,448
bytes for every shape the receivers build and the grid fills the card's
132 SMs where M allows it.

The module also carries the JAX package's pure shape rules (``_plan``,
``eligible``, ``prelude_plan``, ``prelude_eligible``), thresholds
unchanged, so that ``FusedFmDemod`` picks the same branch and granule as
in ``tpusdr``.  The thresholds describe the TPU kernel's VMEM budget, not
this kernel's; they are kept only for that equality.  One divergence:
the JAX prelude kernel doubles its tap-matrix footprint for its bf16 hi/lo
split (fir_banded_pallas.py:641-643) while its ``prelude_eligible`` does
not (:431); the port has no split, so here the rule and the kernel agree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpusdr_torch.kernels.dispatch import check_launch, launch_target, on_cuda
from tpusdr_torch.utils.numerics import cdiv, round_up

_C = 128
_MAX_W_BYTES = 8 << 20
_RP_CANDIDATES = (200, 160, 120, 80, 40, 32, 24, 16, 8)
_GUARD = 8  # prelude rows carried across ticks

SMEM_LIMIT = 232_448  # shared memory one block may opt into on an H100
SM_SMEM = 233_472  # shared memory of one SM; each resident block reserves 1 KB of it
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
MIN_BLOCKS = 2 * SM_COUNT  # a launch that fills the card: two blocks an SM
TILES = (64, 32, 16, 8)  # outputs per block the lanes-across-taps form is built for
KERNEL_WARPS = 8  # warps of one block
PHASE_R = 7  # outputs one thread owns in the phase-major form
PHASE_TILE = 32 * PHASE_R  # its outputs per block: lanes across outputs
PHASE_MIN_BLOCKS = 2 * SM_COUNT // 3  # the grid from which the phase-major form wins


# -- the JAX package's shape rules (fir_banded_pallas.py:94-116, 392-436) --


def _plan(T: int, D: int):
    G = _C * D
    K = (_C - 1) * D + T
    kpad = round_up(K, 128)
    q = cdiv(kpad - G, G) if kpad > G else 0
    return G, kpad, q


def eligible(T: int, D: int, complex_taps: bool) -> bool:
    if D < 2:
        return False
    _, kpad, q = _plan(T, D)
    w_bytes = kpad * _C * 4 * (2 if complex_taps else 1)
    return w_bytes <= _MAX_W_BYTES and q <= 2


def prelude_plan(T: int, D: int):
    G = _C * D
    B = cdiv(T - 1, G) if T > 1 else 0
    return G, B


def _pick_rp(n_rows: int, G: int, w_bytes: int) -> int | None:
    for r in _RP_CANDIDATES:
        if n_rows % r:
            continue
        if 8 * (r + _GUARD) * G * 4 + w_bytes <= 80 << 20:
            return r
    return None


def prelude_eligible(T: int, D: int, N: int, complex_taps: bool) -> bool:
    if D < 2:
        return False
    G, B = prelude_plan(T, D)
    if B > _GUARD - 1:
        return False
    w_bytes = (B + 1) * G * _C * 4 * (2 if complex_taps else 1)
    if w_bytes > 4 * _MAX_W_BYTES:
        return False
    if N % (_GUARD * G) or N < 2 * _GUARD * G:
        return False
    return _pick_rp(N // G, G, w_bytes) is not None


# -- the card's shape rule -------------------------------------------------


class DecimFirPlan(NamedTuple):
    """How one D-FIR launch is cut: the kernel's inner loop (``FORMS``),
    ``tile`` outputs a block, ``chunk`` taps a pass (T unless shared memory
    forces less)."""

    form: str
    tile: int
    chunk: int


FORMS = ("taps", "phase")  # the kernel's inner loops, by their index on the C side


def phase_pitch(D: int) -> int:
    """Samples between rows of the phase-major window: D made odd.  Lane l
    reads row l*R + n of phase p, at 8-byte word (l*R + n) * pitch + p; with
    R and the pitch both odd the 16 lanes of a half-warp fall into 16
    different 8-byte banks, so a 64-bit load has no conflict."""
    return D | 1


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes of dynamic shared memory that share one SM."""
    return SM_SMEM // (smem + 1024)


def decim_fir_smem(T: int, D: int, complex_taps: bool, plan: DecimFirPlan) -> int:
    """Shared memory of one D-FIR block (csrc/decim_fir.cu smem_bytes and
    phase_smem_bytes).  Form "taps": the window of ``tile`` outputs over
    ``chunk`` taps, then the chunk's taps.  Form "phase": tile + Q - 1 rows
    of D samples at an odd pitch, the warps' partial sums, and the taps by
    phase, Q = ceil(T / D) of them a phase."""
    tap_bytes = 8 if complex_taps else 4
    if plan.form == "phase":
        Q = cdiv(T, D)
        rows = plan.tile + Q - 1
        return (rows * phase_pitch(D) + KERNEL_WARPS * plan.tile) * 8 + D * Q * tap_bytes
    return ((plan.tile - 1) * D + plan.chunk) * 8 + plan.chunk * tap_bytes


def tap_chunk(T: int, fixed_bytes: int, bytes_per_tap: int) -> int:
    """T if all taps fit beside ``fixed_bytes``, else the largest multiple
    of 32 taps that does (the kernel then loops over the taps in chunks)."""
    room = (SMEM_LIMIT - fixed_bytes) // bytes_per_tap
    if room >= T:
        return T
    chunk = room // 32 * 32
    if chunk < 32:
        raise ValueError(f"no tile fits {SMEM_LIMIT} B of shared memory ({fixed_bytes} B fixed)")
    return chunk


def decim_fir_plan(T: int, D: int, complex_taps: bool, M: int) -> DecimFirPlan:
    """The plan of a D-FIR launch of M outputs.

    The phase-major form (a quarter of the shared-memory traffic a MAC, no
    idle lanes) where its 224-output blocks fit shared memory, every warp
    has a phase (D >= 8) and the grid covers at least ``PHASE_MIN_BLOCKS``
    SMs: a block is then the only one on its SM, so a smaller grid leaves
    SMs idle while its time stays that of one block.

    Else lanes across taps.  Among the tiles whose window and all T taps
    fit ``SMEM_LIMIT``: of those small enough for two blocks to share an SM,
    the largest that still gives ``MIN_BLOCKS`` blocks, else the smallest
    (a large tile reuses each tap more often, but fewer blocks than SMs
    leave the card idle: at (868, /250) on a 1,280,000-sample tick tile 64
    is 80 blocks, tile 16 is 320); where no tile lets two blocks share an
    SM, the largest, since rounds of smaller blocks only lose tap reuse.
    Where not even 8 outputs fit with all the taps, the taps go in chunks."""
    phase = DecimFirPlan("phase", PHASE_TILE, T)
    if (D >= KERNEL_WARPS and decim_fir_smem(T, D, complex_taps, phase) <= SMEM_LIMIT
            and cdiv(M, PHASE_TILE) >= PHASE_MIN_BLOCKS):
        return phase

    def plan(tile, chunk=T):
        return DecimFirPlan("taps", tile, chunk)

    fits = [t for t in TILES if decim_fir_smem(T, D, complex_taps, plan(t)) <= SMEM_LIMIT]
    if not fits:
        tile = TILES[-1]
        return plan(tile, tap_chunk(T, (tile - 1) * D * 8, 16 if complex_taps else 12))
    shared = [t for t in fits if blocks_per_sm(decim_fir_smem(T, D, complex_taps, plan(t))) >= 2]
    if not shared:
        return plan(fits[0])
    return plan(next((t for t in shared if cdiv(M, t) >= MIN_BLOCKS), shared[-1]))


# -- kernel and plain version ----------------------------------------------


def _as_taps(taps, device) -> torch.Tensor:
    if isinstance(taps, torch.Tensor):
        return taps
    t = np.asarray(taps)
    t = t.astype(np.complex64 if np.iscomplexobj(t) else np.float32)
    return torch.from_numpy(t).to(device)


def decim_fir_plain(hist, x, taps, D: int, s0: int, M: int) -> torch.Tensor:
    """Plain version: the banded matmul over s[s0 : s0 + (T-1) + M*D]."""
    from tpusdr_torch.ops import fir

    s = x if hist is None else torch.cat([hist, x])
    T = taps.shape[-1]
    need = s0 + (T - 1) + M * D
    if need > s.shape[-1]:
        s = torch.nn.functional.pad(s, (0, need - s.shape[-1]))
    return fir.fir_extended(s[s0:need], taps, D, "mxu")


def _launch(hist, x, taps, D: int, s0: int, M: int) -> torch.Tensor:
    from tpusdr_torch.kernels.build import library

    lib = library()
    T = taps.shape[-1]
    for name, t in (("x", x), ("history", hist)):
        if t is not None and (t.dtype != torch.complex64 or t.dim() != 1):
            raise ValueError(f"decim_fir: {name} must be a 1-D complex64 tensor")
    if taps.dtype not in (torch.float32, torch.complex64) or taps.dim() != 1:
        raise ValueError("decim_fir: taps must be 1-D float32 or complex64")
    cplx_taps = int(taps.is_complex())
    plan = decim_fir_plan(T, D, bool(cplx_taps), M)
    form = FORMS.index(plan.form)
    smem = lib.tpusdr_decim_fir_smem(T, D, cplx_taps, form, plan.tile, plan.chunk)
    dev, stream = launch_target(x, smem, f"decim_fir (T={T}, D={D})")
    x = x.contiguous()
    hist = hist.contiguous() if hist is not None else None
    taps = taps.contiguous()
    y = torch.empty(M, dtype=torch.complex64, device=x.device)
    err = lib.tpusdr_decim_fir(
        hist.data_ptr() if hist is not None else None,
        hist.shape[-1] if hist is not None else 0,
        x.data_ptr(),
        x.shape[-1],
        taps.data_ptr(),
        T,
        cplx_taps,
        D,
        s0,
        M,
        form,
        plan.tile,
        plan.chunk,
        y.data_ptr(),
        dev,
        stream,
    )
    check_launch(err, "decim_fir")
    return y


def banded_fir(x_ext: torch.Tensor, taps, decimation: int, history: torch.Tensor | None = None) -> torch.Tensor:
    """Decimating FIR of [history, x_ext] (replaces ``banded_fir_pallas``):
    M = (H + N - (T-1)) // D outputs, y[m] = sum_j taps[j] *
    s[m*D + T-1-j].  Complex64 data; real or complex taps."""
    taps = _as_taps(taps, x_ext.device)
    D = int(decimation)
    T = taps.shape[-1]
    H = history.shape[-1] if history is not None else 0
    M = (H + x_ext.shape[-1] - (T - 1)) // D
    if M <= 0:
        return torch.zeros(0, dtype=torch.complex64, device=x_ext.device)
    if x_ext.dim() != 1:
        raise ValueError("banded_fir is single-stream (1-D) only")
    if on_cuda(x_ext, history, taps):
        y = _launch(history, x_ext, taps, D, 0, M)
        banded_fir.launches += 1
        return y
    return decim_fir_plain(history, x_ext, taps, D, 0, M)


banded_fir.launches = 0


def banded_fir_prelude(x: torch.Tensor, prelude: torch.Tensor, taps, decimation: int) -> torch.Tensor:
    """Zero-copy streaming FIR (replaces ``banded_fir_prelude``): the N/D
    outputs y[k] = sum_u h_rev[u] * s[k*D - (T-1) + u] of this tick, where
    s[0] = x[0] and s[-8G..0) are the prelude rows (8, G), G = 128*D."""
    taps = _as_taps(taps, x.device)
    D = int(decimation)
    T = taps.shape[-1]
    N = x.shape[-1]
    G, _ = prelude_plan(T, D)
    if x.dim() != 1:
        raise ValueError("banded_fir_prelude is single-stream (1-D) only")
    if N % (_GUARD * G) or N < 2 * _GUARD * G:
        raise ValueError(f"tick {N} not a usable multiple of 8G={8 * G}")
    if tuple(prelude.shape) != (_GUARD, G):
        raise ValueError(f"prelude must be ({_GUARD}, {G}), got {tuple(prelude.shape)}")
    hist = prelude.reshape(-1)
    s0 = _GUARD * G - (T - 1)
    if on_cuda(x, hist, taps):
        y = _launch(hist, x, taps, D, s0, N // D)
        banded_fir_prelude.launches += 1
        return y
    return decim_fir_plain(hist, x, taps, D, s0, N // D)


banded_fir_prelude.launches = 0
