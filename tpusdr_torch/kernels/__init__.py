"""tpusdr_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

  * ``fir_banded``: decimating complex FIR (csrc/decim_fir.cu), replacing
    the TPU kernels ``banded_fir_pallas`` and ``banded_fir_prelude``;
  * ``fm_fused``: NCO mix -> FIR -> FM discriminator (csrc/fm_fused.cu),
    replacing ``fused_fm_demod_pallas``.

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from tpusdr_torch.kernels.fir_banded import banded_fir, banded_fir_prelude
from tpusdr_torch.kernels.fm_fused import fused_fm_demod

WRAPPERS = (banded_fir, banded_fir_prelude, fused_fm_demod)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
