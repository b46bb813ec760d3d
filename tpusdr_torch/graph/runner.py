"""StreamRunner — the host-side streaming loop (port of
tpusdr/graph/runner.py:44-331).

  * the step: on a CUDA device one captured CUDA graph a tick
    (``_build_step``, ``CapturedStep``), the counterpart of the JAX
    runner's jitted step; on the CPU, or with ``capture=False``, the eager
    ``block.apply``.  Captures are keyed by the input's shape and dtype,
    as jit's cache is: the first tick of a shape runs eager (and fills the
    blocks' lazy caches), the second is captured, every later one is one
    replay;
  * on a CUDA device an upload thread copies the next blocks into pinned
    host memory and onto the device on a copy stream; the compute stream
    waits on each copy's event, and the pinned buffer stays referenced
    until the tick that read it has been fetched;
  * outputs are drained as soon as they are done: each tick's output is
    copied without blocking into pinned memory, with an event recorded
    behind the copy.  While the host waits for the next block, it polls
    the oldest pending tick's events and drains each finished tick, in
    order, into the sinks; a block that is ready is taken first, and at
    most ``pipeline_depth`` ticks are in flight (the oldest is drained,
    waiting on its events, when one more has been stepped: the reference's
    Waiter ping-pong, depth N).  So a radio's audio leaves as soon as the
    card is done with it, and a backlogged stream keeps its overlap;
  * the stream is read to its end: a last block that is not a multiple of
    the block's granule is zero-padded to one, and its output trimmed to
    the floor(n * up / down) samples its real input owes;
  * with ``queue=`` (a ``graph.queues.CommandQueue`` or its registered
    name) the queue's stream is the compute stream: steps, captures,
    replays, fetches and their events are issued on it, and the copy
    stream's events are waited on by it;
  * samples-in/out counters, the step's captures and eager ticks, the
    ticks drained before the depth forced them, and wall-clock throughput
    (RunStats);
  * with a tracer (``utils/tracing.py``: one active when the runner or the
    step is built, or ``tracer=``), host spans at each layer boundary of a
    block (``source``, ``upload``, ``queue``, ``step``, ``fetch``,
    ``drain_wait``, ``sink``; the step's ``step.copy_in`` and
    ``step.replay``), each with the block's id, and the tick's stamps.
    Without one, the cost is one test a tick in ``CapturedStep`` and a few
    a block in the runner's loop, which takes its host timestamps either
    way.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from tpusdr_torch import kernels
from tpusdr_torch.graph.block import Block
from tpusdr_torch.utils import tracing
from tpusdr_torch.utils.logging import get_logger
from tpusdr_torch.utils.numerics import round_up

log = get_logger("runner")

#: how long the host waits for the next block before it polls the pending
#: ticks' events again (on an H100's host, 100 us gave a live radio's audio
#: the narrowest tail: 200 us holds it longer, 50 us wakes the interpreter
#: often enough to slow the upload thread)
_POLL_S = 100e-6

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
    #: the captured step's captures (a recapture after ``refresh`` counts)
    #: and ticks run eager, over the run
    captures: int = 0
    eager_ticks: int = 0
    #: ticks drained because they were finished while the runner waited for
    #: the next block, before ``pipeline_depth`` or the stream's end forced them
    early_drains: int = 0

    @property
    def msps_in(self) -> float:
        return self.samples_in / max(self.wall_seconds, 1e-12) / 1e6

    @property
    def msps_out(self) -> float:
        return self.samples_out / max(self.wall_seconds, 1e-12) / 1e6


def default_device(what: str) -> torch.device:
    """The card (the current CUDA device) when there is one; without one,
    ``ValueError`` telling the caller to name the CPU.  Never the CPU by
    default."""
    if not torch.cuda.is_available():
        raise ValueError(f"{what}: no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _block_device(block: Block) -> torch.device:
    """Where a block runs when no device is named: where its buffers are;
    a block without buffers (a demodulator, a magnitude) on the card
    (``default_device``)."""
    t = next(iter(block.buffers()), None)
    return t.device if t is not None else default_device(_name(block))


def step_in_place(block: Block, static_state, static_x: torch.Tensor):
    """The step a CUDA graph records: ``block.apply`` on the static state,
    then each leaf of the new state copied into its static leaf (a leaf
    that is the static one already is skipped).  Returns the outputs.  Run
    eagerly it gives the stream ``apply`` gives."""
    new_state, y = block.apply(static_state, static_x)
    dst, spec = pytree.tree_flatten(static_state)
    src, new_spec = pytree.tree_flatten(new_state)
    if new_spec != spec:
        raise TypeError(f"{_name(block)}: apply returned a state of another structure than it was given")
    for d, s in zip(dst, src):
        if s is not d:
            if s.shape != d.shape or s.dtype != d.dtype:
                raise TypeError(f"{_name(block)}: a state leaf changed from {d.dtype}{list(d.shape)} "
                                f"to {s.dtype}{list(s.shape)} in a step")
            d.copy_(s)
    tracing.stamp_boundary("state")  # the carry's write-back, when a tracer stamps the tick
    return y


def static_copy(block: Block, state):
    """A copy of ``state`` whose buffers a captured step owns.  Raises
    ``TypeError`` for a leaf that is not a tensor: a captured graph would
    freeze its value."""
    for path, leaf in pytree.tree_flatten_with_path(state)[0]:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(
                f"{_name(block)}: state leaf {pytree.keystr(path) or '<root>'} is a "
                f"{type(leaf).__name__}, not a tensor; a captured step would freeze its value"
            )
    return pytree.tree_map(_clone, state)


def _clone(t: torch.Tensor) -> torch.Tensor:
    """A clone that keeps the tensor's Python attributes (the NCO phase's
    mark, ``ops/osc.py``)."""
    c = t.clone()
    c.__dict__.update(t.__dict__)
    return c


def _name(block: Block) -> str:
    stages = getattr(block, "stages", None) or getattr(block, "nodes", None)
    if stages:
        return f"{block.__class__.__name__}({', '.join(stages)})"
    return block.__class__.__name__


@contextlib.contextmanager
def collector_held():
    """Python's garbage collector off inside the ``with``, as it was after: a
    collection inside a capture may free a dead reference cycle that holds
    another captured graph (a sharded stream and its step form one), and a
    graph freed there invalidates the capture.  PyTorch no longer collects
    before a capture by default, so such a cycle may still wait."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


class _Capture:
    """One captured tick: the graph, its static state, input and outputs,
    and what it adds to the kernel wrappers' counters at each replay
    (``launches``: (wrapper, counter, n) triples)."""

    def __init__(self, graph, state, x, y, launches, layout=None):
        self.graph, self.state, self.x, self.y, self.launches = graph, state, x, y, launches
        self.layout = layout  # the tracer's layout of the tick's stamps, if traced

    def load(self, state) -> bool:
        """Copy ``state`` into the static buffers; False if its structure,
        shapes, dtypes or devices are not the static state's."""
        src, spec = pytree.tree_flatten(state)
        dst, static_spec = pytree.tree_flatten(self.state)
        if spec != static_spec or not all(
            isinstance(s, torch.Tensor) and (s.shape, s.dtype, s.device) == (d.shape, d.dtype, d.device)
            for s, d in zip(src, dst)
        ):
            return False
        for s, d in zip(src, dst):
            if s is not d:
                d.copy_(s)
        return True


class CapturedStep:
    """``(state, x) -> (state, y)`` as one CUDA graph replay a tick, on the
    stream that is current when it is called.

    Captures are keyed by the input's shape and dtype.  The first tick of
    a shape runs eager: it is a real tick, and it fills the caches the
    blocks fill on a first call (plans, device tables, the kernels'
    shared-memory opt-in).  The second is captured on ``stream`` (a side
    stream when None) from a copy of its state, then replayed; every later
    tick copies ``x`` into the static input and replays.  A state that is
    not the static one is copied into it, or recaptured from where its
    structure or shapes differ.  The state and outputs returned are the
    graph's static buffers: they hold until the next call.

    Each kernel wrapper's ``launches`` counts executions: the launches
    recorded at capture are taken back and added again at every replay
    (and so are the wrappers' other counters, ``kernels.COUNTERS``);
    ``captures`` and ``eager_ticks`` count the step's captures and eager
    ticks.  A capture that fails raises ``RuntimeError`` naming the block.

    With a ``tracer`` (or one active when the step is built) the capture
    holds the tick's stamps, each replay fills a row of the tracer's ring,
    and the static-input copy and the launch are spans (``step.copy_in``,
    ``step.replay``); without one the graph is the untraced graph."""

    def __init__(self, block: Block, stream: "torch.cuda.Stream | None" = None, tracer=None):
        self.block = block
        self.stream = stream
        self._warm: set = set()
        self._graphs: dict = {}
        self.captures = 0
        self.eager_ticks = 0
        self.tracer = tracer if tracer is not None else tracing.current()

    def __call__(self, state, x: torch.Tensor):
        key = (tuple(x.shape), x.dtype)
        cap = self._graphs.get(key)
        captured = False
        if cap is None and key not in self._warm:
            self._warm.add(key)
            self.eager_ticks += 1
            with tracing.using(self.tracer):  # a traced Chain stamps and claims its row
                return self.block.apply(state, x)
        if cap is None or (state is not cap.state and not cap.load(state)):
            cap = self._graphs[key] = self._capture(state, x)
            captured = True
        if self.tracer is None:
            cap.x.copy_(x)
            cap.graph.replay()
        else:
            self.tracer.replay(cap, x, captured)
        for w, f, n in cap.launches:
            setattr(w, f, getattr(w, f) + n)
        return cap.state, cap.y

    def _capture(self, state, x: torch.Tensor) -> _Capture:
        static_state = static_copy(self.block, state)
        static_x = x.clone()
        before = kernels.counts()
        graph = torch.cuda.CUDAGraph()
        replay_stream = None
        if self.tracer is not None:
            # the replays run on the queue's stream, else on the one current now
            replay_stream = self.stream if self.stream is not None else torch.cuda.current_stream(x.device)
            self.tracer.ring(x.device, replay_stream)  # made before the capture, so that no replay clears it
        try:
            # thread_local: the runner's upload thread may allocate and copy
            # on its own stream while this thread captures
            with tracing.capturing(self.tracer, replay_stream) as tick, collector_held():
                with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                    y = step_in_place(self.block, static_state, static_x)
        except Exception as e:
            raise RuntimeError(f"capture of {_name(self.block)} failed: {e}") from e
        finally:
            recorded = [(w, f, getattr(w, f) - n) for (w, f), n in before.items()]
            for (w, f), n in before.items():
                setattr(w, f, n)
        self.captures += 1
        layout = tick.layout if tick is not None else None
        return _Capture(graph, static_state, static_x, y, [r for r in recorded if r[2]], layout)


class StreamRunner:
    """Drive a single-input Block (a Chain or Graph) from a host source
    into host sinks, on ``device`` (default: the queue's device, else where
    the block's buffers are, else the card; a block without buffers and
    no card raise ``ValueError`` unless ``device='cpu'`` is named)."""

    def __init__(self, block: Block, pipeline_depth: int = 2, device=None, upload_depth: int = 2,
                 queue=None, capture: bool | None = None, tracer=None):
        """``upload_depth``: how many ticks the upload thread may stage
        ahead of compute (0 uploads inline); it bounds the device memory of
        in-flight inputs.  ``queue``: a CommandQueue or a registered queue
        name; it gives the device when ``device`` is not named, and its
        stream becomes the compute stream.  ``capture``: None replays one
        captured CUDA graph a tick on a CUDA device and steps eagerly on the
        CPU (which has no graphs); False keeps the eager step on the card
        (for comparison); True on the CPU raises ``ValueError``.
        ``tracer``: a ``utils.tracing.Tracer`` to record into (default: the
        one active on this thread now, if any)."""
        self.block = block
        self.tracer = tracer if tracer is not None else tracing.current()
        self._retired = [0, 0]  # captures and eager ticks of the steps that refresh dropped
        if isinstance(queue, str):
            from tpusdr_torch.graph.queues import get_queue_registry

            queue = get_queue_registry().get(queue)
        self.queue = queue
        if device is not None:
            device = torch.device(device)
        elif queue is not None:
            device = queue.device
        else:
            device = _block_device(block)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if queue is not None and queue.device != device:
            raise ValueError(f"queue {queue.name!r} is on {queue.device}, the runner on {device}")
        if capture and device.type != "cuda":
            raise ValueError(f"capture=True needs a CUDA device; the runner is on {device}")
        self.device = device
        self.pipeline_depth = pipeline_depth
        self.upload_depth = upload_depth
        self.capture = device.type == "cuda" if capture is None else bool(capture)
        self._build_step()

    def _on_queue(self):
        """Context in which the queue's stream (if any) is current."""
        return self.queue.activate() if self.queue is not None else contextlib.nullcontext()

    def _build_step(self) -> None:
        """``self._step(state, x) -> (state, y)``: the captured step
        (``CapturedStep``, captured on the queue's stream when there is a
        queue) or, without capture, ``block.apply``."""
        old = getattr(self, "_step", None)
        if isinstance(old, CapturedStep):
            self._retired[0] += old.captures
            self._retired[1] += old.eager_ticks
        if self.capture:
            self._step = CapturedStep(self.block, self.queue.stream if self.queue is not None else None,
                                      tracer=self.tracer)
        else:
            self._step = self.block.apply

    def _step_counts(self) -> tuple[int, int]:
        """Captures and eager ticks of every step this runner has had."""
        step = self._step
        if isinstance(step, CapturedStep):
            return self._retired[0] + step.captures, self._retired[1] + step.eager_ticks
        return self._retired[0], self._retired[1]

    def refresh(self) -> None:
        """Drop every capture after ``block.update_parameters``, as the JAX
        runner re-jits its step: a graph replays the buffers and host values
        it was captured with, so a parameter change is invisible to it.  The
        next tick of each shape runs eager and the one after is captured
        anew.  A block updated behind the runner's back, without this call,
        stays invisible to the captured step, as it does to a jitted one."""
        self._build_step()

    def update_parameters(self, block_name: str | None = None, **params) -> None:
        """updateParameters on the block itself or, with ``block_name``, on
        a member of a Chain or Graph, then ``refresh``."""
        if block_name is None:
            self.block.update_parameters(**params)
        else:
            self.block.update_block_parameters(block_name, **params)
        self.refresh()

    def update_parameters_json(self, block_name: str | None, payload) -> None:
        """updateParameters(json): ``payload`` is a JSON string or dict in
        the reference's camelCase schema; then ``refresh``."""
        if block_name is None:
            self.block.update_parameters_json(payload)
        else:
            self.block.update_block_parameters_json(block_name, payload)
        self.refresh()

    def init_state(self):
        with self._on_queue():
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
        """Start copying an output to the host: (host tensor, event or None).
        Issued on the compute stream right behind the step, so a captured
        step's next replay, on the same stream, cannot overwrite its static
        output before this copy has read it."""
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

        For a block with several outputs (a tuple from ``apply``, as a
        tapped graph gives), pass one sink per output port; ``postprocess``
        may likewise be one callable per port or one for all.

        With a captured step the state returned is the graph's static
        state: it aliases the graph's buffers until the next ``run`` (clone
        it to keep it).  A ``state`` given here that is not the static one
        is copied into the static buffers (one of another structure or
        shape is captured anew); the caller's tensors are not written."""
        with self._on_queue():
            return self._run(source, sink, state, max_blocks, postprocess)

    def _run(self, source, sink, state, max_blocks, postprocess):
        if state is None:
            state = self.init_state()
        sinks = list(sink) if isinstance(sink, (list, tuple)) else [sink]
        n_ports = len(sinks)
        posts = list(postprocess) if isinstance(postprocess, (list, tuple)) else [postprocess] * n_ports
        if len(posts) != n_ports:
            raise ValueError(f"{len(posts)} postprocessors for {n_ports} sinks")
        stats = RunStats(samples_out_ports=[0] * n_ports)
        counts0 = self._step_counts()
        on_cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if on_cuda else None
        compute_stream = torch.cuda.current_stream(self.device) if on_cuda else None
        granule = self.block.granule
        pending: deque = deque()
        tr = self.tracer
        base = 0
        if tr is not None:
            # block ids unique across runs; the run's counters read at summary
            base = tr.run_base()
            tr.count_from(stats, ("blocks", "samples_in", "samples_out", "captures", "eager_ticks", "early_drains"))
            source = tracing.timed_source(source, tr, base)

        def drain(item) -> None:
            outs, n_in, n_padded, _, bid = item
            for port, ((host, ev), snk, post) in enumerate(zip(outs, sinks, posts)):
                if ev is not None:
                    t_wait = tracing.now()
                    ev.synchronize()
                    if tr is not None:
                        tr.span("drain_wait", bid, t_wait)
                out = host.numpy()
                if n_in != n_padded:
                    # the padded last block: each port keeps the share of its
                    # output that the real input owes, floor(n * up / down)
                    out = out[..., : out.shape[-1] * n_in // n_padded]
                if post is not None:
                    out = post(out)
                t_sink = tracing.now()
                snk.write(out)
                if tr is not None:
                    tr.span("sink", bid, t_sink)
                stats.samples_out_ports[port] += out.shape[-1]

        def drain_finished() -> bool:
            """Drain, in order, the pending ticks whose copies are done;
            whether any was."""
            drained = False
            while pending and all(ev is None or ev.query() for _, ev in pending[0][0]):
                drain(pending.popleft())
                stats.early_drains += 1
                drained = True
            return drained

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
            for i, (n, raw) in enumerate(padded(), base):
                t_up = tracing.now()
                item = self._upload(raw, copy_stream)
                if tr is not None:
                    tr.span("upload", i, t_up)
                yield n, item

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

            def next_up():
                """(when the wait began, the next uploaded block); while ticks
                are pending, the finished ones are drained as it is waited
                for, and the wait begins again after them."""
                t_q = tracing.now()
                while pending:
                    try:
                        return t_q, uq.get_nowait()
                    except _queue.Empty:
                        if drain_finished():
                            t_q = tracing.now()
                    if pending:
                        try:
                            return t_q, uq.get(timeout=_POLL_S)
                        except _queue.Empty:
                            continue
                return t_q, uq.get()

            def staged():
                for i in itertools.count(base):
                    t_q, (n, item) = next_up()
                    if tr is not None:
                        tr.span("queue", i, t_q)
                    if n is _END:
                        if item is not None:
                            raise item
                        return
                    yield n, item

            blocks = staged()
        else:

            def inline():
                for item in staged_inline():
                    yield item
                    drain_finished()  # before the source is asked for the next block

            blocks = inline()

        try:
            with tracing.using(tr):
                for n_in, (x, ev, host_in) in blocks:
                    bid = base + stats.blocks
                    if tr is not None:
                        tr.block = bid  # the id of the rows the step claims
                    t_step = tracing.now()
                    if ev is not None:
                        compute_stream.wait_event(ev)
                        x.record_stream(compute_stream)
                    state, y = self._step(state, x)
                    t_fetch = tracing.now()
                    stats.blocks += 1
                    stats.samples_in += n_in
                    ys = y if isinstance(y, tuple) else (y,)
                    if len(ys) != n_ports:
                        raise ValueError(f"block produced {len(ys)} outputs but {n_ports} sinks given")
                    fetched = [self._fetch(yp) for yp in ys]
                    if tr is not None:
                        tr.span("step", bid, t_step, t_fetch)
                        tr.span("fetch", bid, t_fetch)
                    # host_in stays referenced until this tick is drained
                    pending.append((fetched, n_in, x.shape[-1], host_in, bid))
                    if len(pending) > self.pipeline_depth:
                        drain(pending.popleft())
                while pending:
                    drain(pending.popleft())
        finally:
            stop.set()

        stats.samples_out = stats.samples_out_ports[0]
        stats.wall_seconds = time.perf_counter() - t0
        counts = self._step_counts()
        stats.captures = counts[0] - counts0[0]
        stats.eager_ticks = counts[1] - counts0[1] if self.capture else stats.blocks
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
