"""The card's peaks, the work of the stages a roofline is read for, and
the stage stepped alone on the card.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.  A
share of the roofline is the least time the card could take for a
stage's work, the larger of its bytes over the bandwidth and its
operations over the float32 rate, over the time the stage took.  Bytes
count each input sample read once, each output sample written once and
the taps once, whatever the stage reads again; operations count the
stage's arithmetic from its shapes, not what an implementation does.
"""

from __future__ import annotations

import math

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
CF32 = 8  # bytes of a complex64 sample


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_FLOPS)


def share_pct(n_bytes: float, n_ops: float, seconds: float) -> float:
    return 100.0 * least_seconds(n_bytes, n_ops) / seconds


def decim_fir_work(n_in: int, n_taps: int, n_out: int, complex_taps: bool) -> tuple[float, float]:
    """(bytes, operations) of a decimating FIR over complex samples.

    Bytes: n_in cf32 samples read, n_out cf32 samples written, the taps
    (8 bytes a complex tap, 4 a real one).  Operations: each output sums
    n_taps products; a complex tap times a complex sample is 4 multiplies
    and 2 adds, and 2 more adds put it into the sum: 8 a tap and output.
    A real tap times a complex sample is 2 multiplies and 2 adds: 4."""
    per_tap = 8 if complex_taps else 4
    n_bytes = (n_in + n_out) * CF32 + n_taps * (CF32 if complex_taps else 4)
    return float(n_bytes), float(n_out) * n_taps * per_tap


def channelizer_work(n_in: int, num_channels: int, n_taps: int) -> tuple[float, float]:
    """(bytes, operations) of an M-channel maximally decimated polyphase
    filterbank over n_in cf32 samples with a real prototype of n_taps.

    F = n_in / M frames.  Bytes: the input read once, M x F cf32 channel
    samples written once, the prototype's float32 taps.  Operations: the
    branch filter gives M x F outputs, each a sum over ceil(T/M) real taps
    times complex samples (4 operations a tap, as above), which is
    4 x ceil(T/M) x M x F; the DFT across the M branches of each frame is
    counted as a radix-2 complex FFT, 5 M log2 M a frame."""
    m = num_channels
    frames = n_in // m
    p = -(-n_taps // m)
    n_bytes = n_in * CF32 + m * frames * CF32 + n_taps * 4
    n_ops = 4.0 * p * m * frames + 5.0 * m * math.log2(m) * frames
    return float(n_bytes), n_ops


def stage_alone_seconds(block, inputs: list[torch.Tensor], reps: int = 25) -> float | None:
    """Device seconds of one step of ``block`` alone: one CUDA graph holds a
    step on each input in turn (each input with a state of its own; the
    inputs together are larger than the 50 MB L2, so they come from device
    memory), replayed ``reps`` times behind a spin kernel and timed by CUDA
    events; the time over reps x inputs.  None off the card."""
    dev = inputs[0].device
    if dev.type != "cuda":
        return None
    states = [block.init_state(device=dev) for _ in inputs]
    for state, x in zip(states, inputs):
        block.apply(state, x)  # the first call fills the block's caches
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for state, x in zip(states, inputs):
            block.apply(state, x)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(100_000_000)  # about 50 ms: the card waits while the replays are queued
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) * 1e-3 / (reps * len(inputs))
