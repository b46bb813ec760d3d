"""The work of the audio resampler stage (``Resampler``: a rational
polyphase resampler over every row, the channels of a bank or the one
channel of a receiver), for its share of the roofline
(``roofline.share_pct``).

Counted from the shapes, so that any implementation reads at most 100%:

  * bytes: each row's tick and its P-1 carried samples (P = ceil(T/U)
    taps a phase) read once, float32; each row's outputs written once,
    float32; the T float32 taps read once;
  * operations: each output sums P products, 2 operations a tap and
    output (a multiply and an add).
"""

from __future__ import annotations


def resampler_work(rows: int, n_in: int, n_out: int, up: int, n_taps: int) -> tuple[float, float]:
    """(bytes, operations) of ``rows`` rows of n_in real samples resampled to
    n_out each by an ``up``/D resampler with n_taps prototype taps."""
    taps_per_phase = -(-n_taps // up)
    n_bytes = rows * (n_in + taps_per_phase - 1) * 4 + rows * n_out * 4 + n_taps * 4
    n_ops = 2.0 * rows * n_out * taps_per_phase
    return float(n_bytes), n_ops


def rows_of(info) -> int:
    """The rows a cell's resampler runs over: the channel count of a
    multi-channel model's info, else one."""
    return int(info.get("num_channels", 1)) if isinstance(info, dict) else 1


def stage_work(st: dict, rows: int) -> tuple[float, float]:
    """The work of a ``Resampler`` stage as ``spans.stage`` gives it
    ({'block', 'n_in', 'n_out'}) over ``rows`` rows."""
    b = st["block"]
    return resampler_work(rows, st["n_in"], st["n_out"], b.up, b.taps.shape[-1])
