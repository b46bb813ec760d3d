"""StreamRunner — the host-side streaming loop (port of
tpusdr/graph/runner.py:44-331).

  * one eager step per streaming tick (PyTorch has no jit to cache and no
    donation; the carry is a plain dict of tensors);
  * on a CUDA device an upload thread copies the next blocks into pinned
    host memory and onto the device on a copy stream; the compute stream
    waits on each copy's event, and the pinned buffer stays referenced
    until the tick that read it has been fetched;
  * outputs are fetched ``pipeline_depth`` ticks behind: each tick's output
    is copied without blocking into pinned memory, with an event recorded
    behind the copy, and the host waits on that event only when the sink
    needs the samples (the reference's Waiter ping-pong, depth N);
  * the stream is read to its end: a last block that is not a multiple of
    the block's granule is zero-padded to one, and its output trimmed to
    the floor(n * up / down) samples its real input owes;
  * samples-in/out counters and wall-clock throughput (RunStats).

Not ported yet (ROADMAP.md): the ``queue=`` argument and
``update_parameters*``, which need ``graph/queues.py`` and
``Block.update_parameters``.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np
import torch

from tpusdr_torch.graph.block import Block
from tpusdr_torch.utils.logging import get_logger
from tpusdr_torch.utils.numerics import round_up

log = get_logger("runner")

_TORCH_DTYPES = {
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
}


@dataclass
class RunStats:
    blocks: int = 0
    samples_in: int = 0
    samples_out: int = 0
    wall_seconds: float = 0.0
    #: per-output-port sample counts; samples_out is the first port's
    samples_out_ports: list = field(default_factory=list)

    @property
    def msps_in(self) -> float:
        return self.samples_in / max(self.wall_seconds, 1e-12) / 1e6

    @property
    def msps_out(self) -> float:
        return self.samples_out / max(self.wall_seconds, 1e-12) / 1e6


def _block_device(block: Block) -> torch.device:
    t = next(iter(block.buffers()), None)
    return t.device if t is not None else torch.device("cpu")


class StreamRunner:
    """Drive a single-input Block (a Chain) from a host source into host
    sinks, on ``device`` (default: where the block's buffers are)."""

    def __init__(self, block: Block, pipeline_depth: int = 2, device=None, upload_depth: int = 2):
        """``upload_depth``: how many ticks the upload thread may stage
        ahead of compute (0 uploads inline); it bounds the device memory of
        in-flight inputs."""
        self.block = block
        device = torch.device(device) if device is not None else _block_device(block)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.pipeline_depth = pipeline_depth
        self.upload_depth = upload_depth

    def init_state(self):
        return self.block.init_state(device=self.device)

    # -- host <-> device ----------------------------------------------------------

    def _upload(self, raw: np.ndarray, copy_stream):
        """numpy block -> (device tensor, copy event or None, host buffer)."""
        dtype = _TORCH_DTYPES[np.dtype(raw.dtype)]
        if copy_stream is None:
            return torch.from_numpy(np.array(raw, copy=True)), None, None
        host = torch.empty(raw.shape, dtype=dtype, pin_memory=True)
        host.numpy()[...] = raw
        with torch.cuda.stream(copy_stream):
            x = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(copy_stream)
        return x, ev, host

    def _fetch(self, y: torch.Tensor):
        """Start copying an output to the host: (host tensor, event or None)."""
        if y.device.type != "cuda":
            return y, None
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        host.copy_(y, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    # -- the run --------------------------------------------------------------------

    def run(
        self,
        source: Iterable[np.ndarray],
        sink,
        state=None,
        max_blocks: int | None = None,
        postprocess: Callable[[np.ndarray], np.ndarray] | None = None,
    ) -> tuple[Any, RunStats]:
        """Stream source -> block -> sink(s); returns (final state, stats).

        For a block with several outputs (a tuple from ``apply``), pass one
        sink per output port; ``postprocess`` may likewise be one callable
        per port or one for all."""
        if state is None:
            state = self.init_state()
        sinks = list(sink) if isinstance(sink, (list, tuple)) else [sink]
        n_ports = len(sinks)
        posts = list(postprocess) if isinstance(postprocess, (list, tuple)) else [postprocess] * n_ports
        if len(posts) != n_ports:
            raise ValueError(f"{len(posts)} postprocessors for {n_ports} sinks")
        stats = RunStats(samples_out_ports=[0] * n_ports)
        on_cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if on_cuda else None
        compute_stream = torch.cuda.current_stream(self.device) if on_cuda else None
        granule = self.block.granule
        up, down = self.block.up, self.block.down
        pending: deque = deque()

        def drain(item) -> None:
            outs, owed = item[0], item[1]
            for port, ((host, ev), snk, post) in enumerate(zip(outs, sinks, posts)):
                if ev is not None:
                    ev.synchronize()
                out = host.numpy()[..., :owed]
                if post is not None:
                    out = post(out)
                snk.write(out)
                stats.samples_out_ports[port] += out.shape[-1]

        def bounded():
            if max_blocks is not None and max_blocks <= 0:
                return
            for i, raw in enumerate(source):
                yield raw
                if max_blocks is not None and i + 1 >= max_blocks:
                    return

        def padded():
            """Blocks padded to the granule; only the last may need it."""
            short = None
            for raw in bounded():
                if short is not None:
                    raise ValueError(
                        f"a block of {short} samples (not a multiple of the granule "
                        f"{granule}) was followed by another: only the last may be short"
                    )
                n = raw.shape[-1]
                if n % granule:
                    short = n
                    buf = np.zeros(raw.shape[:-1] + (round_up(n, granule),), raw.dtype)
                    buf[..., :n] = raw
                    raw = buf
                yield n, raw

        t0 = time.perf_counter()
        stop = threading.Event()

        def staged_inline():
            for n, raw in padded():
                yield n, self._upload(raw, copy_stream)

        if self.upload_depth > 0:
            uq: _queue.Queue = _queue.Queue(maxsize=self.upload_depth)
            _END = object()

            def put(item) -> bool:
                # gives up once the consumer abandoned the run
                while not stop.is_set():
                    try:
                        uq.put(item, timeout=0.1)
                        return True
                    except _queue.Full:
                        continue
                return False

            def feeder():
                try:
                    if on_cuda:
                        torch.cuda.set_device(self.device)
                    for item in staged_inline():
                        if not put(item):
                            return
                except BaseException as e:  # re-raised in the main loop
                    put((_END, e))
                    return
                put((_END, None))

            th = threading.Thread(target=feeder, daemon=True)
            th.start()

            def staged():
                while True:
                    n, item = uq.get()
                    if n is _END:
                        if item is not None:
                            raise item
                        return
                    yield n, item

            blocks = staged()
        else:
            blocks = staged_inline()

        try:
            for n_in, (x, ev, host_in) in blocks:
                if ev is not None:
                    compute_stream.wait_event(ev)
                    x.record_stream(compute_stream)
                state, y = self.block.apply(state, x)
                stats.blocks += 1
                stats.samples_in += n_in
                ys = y if isinstance(y, tuple) else (y,)
                if len(ys) != n_ports:
                    raise ValueError(f"block produced {len(ys)} outputs but {n_ports} sinks given")
                owed = n_in * up // down
                # host_in stays referenced until this tick is drained
                pending.append(([self._fetch(yp) for yp in ys], owed, host_in))
                if len(pending) > self.pipeline_depth:
                    drain(pending.popleft())
            while pending:
                drain(pending.popleft())
        finally:
            stop.set()

        stats.samples_out = stats.samples_out_ports[0]
        stats.wall_seconds = time.perf_counter() - t0
        log.info(
            "stream done: %d blocks, %.2f Msps in, %.2f Msps out",
            stats.blocks, stats.msps_in, stats.msps_out,
        )
        return state, stats


def run_offline(block: Block, x_blocks: torch.Tensor, state=None, mode: str = "auto"):
    """Offline processing of stacked ticks ``x_blocks`` (K, ..., n).

    ``mode``:
      * 'flat' — apply the block once to the capture with the tick axis
        joined to the time axis: (..., K*n) in, (..., K*n*up/down) out;
        leading channel axes stay where they are;
      * 'scan' — one step per tick; the output keeps the tick axis,
        (K, ..., out);
      * 'auto' — 'flat' when K*n is a multiple of the block's granule.
    Chunking invariance makes the two give the same sample streams.
    """
    K, n = x_blocks.shape[0], x_blocks.shape[-1]
    if state is None:
        state = block.init_state(tuple(x_blocks.shape[1:-1]), device=x_blocks.device)
    if mode == "auto":
        mode = "flat" if (K * n) % block.granule == 0 else "scan"
    if mode == "flat":
        flat = x_blocks.movedim(0, -2).reshape(tuple(x_blocks.shape[1:-1]) + (K * n,))
        return block.apply(state, flat)
    if mode != "scan":
        raise ValueError(f"unknown run_offline mode {mode!r}")
    ys = []
    for k in range(K):
        state, y = block.apply(state, x_blocks[k])
        ys.append(y)
    return state, torch.stack(ys)
