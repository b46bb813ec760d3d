"""tpusdr_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

  * ``fir_banded``: decimating complex FIR (csrc/decim_fir.cu), replacing
    the TPU kernels ``banded_fir_pallas`` and ``banded_fir_prelude``;
  * ``fm_fused``: NCO mix -> FIR -> FM discriminator (csrc/fm_fused.cu),
    replacing ``fused_fm_demod_pallas``;
  * ``fir_poly``: polyphase decimating FIR of [history, x], complex data x
    real taps (csrc/fir_poly.cu), replacing ``fir_decim_pallas``;
  * ``resample_poly``: rational polyphase resampler over a batch of rows
    (csrc/resample_poly.cu); it replaces no TPU kernel (the JAX package's
    resampler is plain jnp) and takes the place of the port's stacked-copy
    resampler on the card;
  * ``copy_floor``: a tick pulled whole through shared memory by
    asynchronous copies (csrc/copy_floor.cu), replacing the kernel of
    ``dma_once`` in benchmarks/kernel_floor_probe.py;
  * ``staging_probes``: staged row windows with run-time offsets, halos and
    shifted reads (csrc/staging_probes.cu), replacing the probes W4, X1 and
    X2 of benchmarks/pallas_mosaic_probes.py.

Each wrapper counts its launches in ``<wrapper>.launches``; the FM-fused
wrapper also counts the channel rows its launches write, in
``fused_fm_demod.channel_rows``, and those of them written in its shared
form, in ``fused_fm_demod.shared_rows``, and the resampler the rows it
resamples, in ``resample_poly.rows``.
"""

from tpusdr_torch.kernels import copy_floor as _copy_floor  # the modules keep their names here
from tpusdr_torch.kernels import resample_poly as _resample_poly
from tpusdr_torch.kernels.fir_banded import banded_fir, banded_fir_prelude
from tpusdr_torch.kernels.fir_poly import fir_decim
from tpusdr_torch.kernels.fm_fused import fused_fm_demod
from tpusdr_torch.kernels.staging_probes import staged_add_one, staged_shift_sum, staged_window_double

WRAPPERS = (
    banded_fir, banded_fir_prelude, fused_fm_demod, fir_decim, _resample_poly.resample_poly,
    _copy_floor.copy_floor, staged_add_one, staged_window_double, staged_shift_sum,
)


COUNTERS = ("launches", "channel_rows", "shared_rows", "rows")  # what a wrapper may count


def counts() -> dict:
    """Every counter of every wrapper: {(wrapper, counter): value}."""
    return {(w, f): getattr(w, f) for w in WRAPPERS for f in COUNTERS if hasattr(w, f)}


def reset_launch_counts() -> None:
    for w, f in counts():
        setattr(w, f, 0)
