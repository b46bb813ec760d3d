"""The port's tracer: device timestamps at each stage boundary of a tick,
host spans at the runner's and the step's layer boundaries, both on the
host's ``time.perf_counter_ns`` clock.

    tracer = Tracer()
    with tracer:                      # active on this thread
        runner = StreamRunner(chain)  # built while active: records into it
        runner.run(source, sink)
    print(tracer.summary())

A ``CapturedStep`` or ``StreamRunner`` built while a tracer is active, or
given ``tracer=``, records into it; one built with no active tracer records
nothing, and its captured graph is the graph it would be without this
module.  ``Chain.apply`` stamps only while a tracer is active on the
current thread.  A tracer records the ticks of one stream of one device:
it claims rows in the order the host issues ticks, which is the order they
run only on one stream.  A tick on another stream or device (a
``MergedRunner`` on two queues, a second card) raises ``ValueError``.

Device stamps.  A stamp is a one-thread kernel (``tpusdr_stamp`` in
``kernels/csrc/runtime.cu``) that writes the card's nanosecond clock
(``%globaltimer``) into ``ring[row][k]``; its plain version, for CPU
tensors, writes ``time.perf_counter_ns()`` into the same ring.  A tick's
stamps are: ``start`` before the chain's first stage, one after each
stage, and, inside a captured step, ``state`` after the carry is copied
back into the static state.  Stamp k = 0 advances a counter that lives
with the ring (on the card for a card's ring), so that each replay of a
captured graph writes a row of its own with no Python on the host.  The
host keeps, for each row, whether the tick was eager, a capture or a
replay, the stage names, the block it belonged to and the thread that
launched it.  The stamp is not one of ``kernels.WRAPPERS``: it is not
counted as a launch.

Host spans.  ``span(name, id, t0, t1)`` records one interval of
``perf_counter_ns``; a runner's spans carry the block's id (its index in
the run, the run's number above bit 32).  Spans from every thread go into
one ring.  Nothing is written to disk: the rings (``RING_TICKS`` rows,
``RING_SPANS`` spans; the newest are kept) are read when ``summary()`` (or
a reader of ``rows()`` / ``spans()``) asks.  Counters are read from each
run's ``RunStats`` and from the kernel wrappers' launch counts; the tracer
keeps no reference to a step.

One clock.  Card stamps are mapped onto the host's clock by calibrations
at the start and the end of a recording (``calibrate``): single stamps,
each between two host readings with a synchronise after the stamp; the
narrowest bracket gives the offset, half of it the uncertainty.  The
offset between the two calibrations is interpolated; its change is the
drift.  The stamp kernel has one name (``tpusdr_stamp_kernel``) in a
``torch.profiler`` trace, so ``line_up`` can match a trace's stamp records
to the ring's values.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from math import gcd
from typing import NamedTuple

import numpy as np
import torch

now = time.perf_counter_ns

EAGER, CAPTURE, REPLAY = 0, 1, 2
MODES = ("eager", "capture", "replay")
STAMP_KERNEL = "tpusdr_stamp_kernel"
STAMPS = 32  # stamps a row holds: a tick of up to 30 stages, its start and its carry's write-back
RING_TICKS = 1 << 16  # rows of the device ring: 16 MiB of int64 stamps
RING_SPANS = 1 << 18  # host spans kept


class _Local(threading.local):
    tracer: "Tracer | None" = None  # the tracer active on this thread
    tick: "_Tick | None" = None  # the tick being stamped on this thread


local = _Local()


def current() -> "Tracer | None":
    """The tracer active on the current thread, or None."""
    return local.tracer


@contextlib.contextmanager
def using(tracer: "Tracer | None"):
    """Make ``tracer`` the active one on this thread for the block (None
    leaves the active one as it is)."""
    if tracer is None:
        yield
        return
    before, local.tracer = local.tracer, tracer
    try:
        yield
    finally:
        local.tracer = before


@contextlib.contextmanager
def suspended():
    """No tracer active on this thread for the block (a step that records
    nothing captures its graph so)."""
    before, local.tracer = local.tracer, None
    try:
        yield None
    finally:
        local.tracer = before


# -- the stamp: kernel and plain version ---------------------------------------


def stamp_plain(ring: torch.Tensor, slot: torch.Tensor, k: int) -> None:
    """The stamp's plain version: ``time.perf_counter_ns()`` into
    ``ring[(slot - 1) % R, k]``, ``slot`` advanced first when k == 0."""
    if k == 0:
        slot += 1
    ring[(int(slot) - 1) % ring.shape[0], k] = now()


def stamp(ring: torch.Tensor, slot: torch.Tensor, k: int) -> None:
    """One stamp on the current stream: the kernel for card tensors, the
    plain version for CPU tensors."""
    from tpusdr_torch.kernels.dispatch import check_launch, launch_target, on_cuda

    if not on_cuda(ring, slot):
        stamp_plain(ring, slot, k)
        return
    from tpusdr_torch.kernels.build import library

    dev, stream = launch_target(ring, 0, "stamp")
    err = library().tpusdr_stamp(ring.data_ptr(), slot.data_ptr(), ring.shape[0], ring.shape[1], k, dev, stream)
    check_launch(err, "stamp")


# -- one clock -------------------------------------------------------------------


class Calibration(NamedTuple):
    """host ns = device ns + ``offset_ns``, within ``uncertainty_ns``, taken
    at device time ``device_ns``."""

    offset_ns: int
    uncertainty_ns: float
    device_ns: int


def calibrate(stamp_once, clock=now, n: int = 32) -> Calibration:
    """``n`` single stamps, each between two readings of ``clock``:
    ``stamp_once()`` launches one stamp and synchronises, and returns
    something ``int()`` reads as the stamp's value (read after the second
    host reading).  The narrowest bracket gives the offset (its middle less
    the stamp) and, halved, the uncertainty."""
    best = None
    for _ in range(n):
        h0 = clock()
        d = stamp_once()
        h1 = clock()
        if best is None or h1 - h0 < best[1] - best[0]:
            best = (h0, h1, int(d))
    h0, h1, d = best
    return Calibration((h0 + h1) // 2 - d, (h1 - h0) / 2, d)


# -- ticks ----------------------------------------------------------------------


class _Tick:
    """The stamps of one tick as they are launched on this thread."""

    __slots__ = ("tracer", "mode", "names", "device", "stream", "in_chain", "layout")

    def __init__(self, tracer: "Tracer", mode: int, stream=None):
        self.tracer, self.mode = tracer, mode
        self.names: list[str] = []
        self.device = None
        self.stream = stream  # the stream the tick runs on (None: the current one)
        self.in_chain = False
        self.layout: int | None = None

    def stamp(self, name: str, device=None) -> None:
        tr = self.tracer
        if self.device is None:
            self.device = torch.device(device)
        ring, slot = tr.ring(self.device, self.stream)
        k = len(self.names)
        if k >= ring.shape[1]:
            raise ValueError(f"tracer: a tick of more than {ring.shape[1]} stamps")
        stamp(ring, slot, k)
        self.names.append(name)


@contextlib.contextmanager
def tick(tracer: "Tracer", mode: int, stream=None):
    """Open a tick on this thread (or join the one open).  On leaving, an
    eager tick that was stamped claims its row (also when it raised: its
    stamps ran); a capture's tick keeps its layout in ``.layout`` for the
    replays to claim."""
    if local.tick is not None:
        yield local.tick
        return
    t = local.tick = _Tick(tracer, mode, stream)
    try:
        yield t
    finally:
        local.tick = None
        if t.names:
            t.layout = tracer.layout(t.names)
            if mode != CAPTURE:
                tracer.claim(t.layout, mode)


@contextlib.contextmanager
def chain_tick(tracer: "Tracer", x: torch.Tensor):
    """The tick a ``Chain.apply`` stamps its stages into: the one open on
    this thread, or one opened here (an eager tick, claimed on leaving),
    with ``start`` stamped before the first chain's first stage.  Yields
    None inside a chain that is already stamping: only the outermost chain
    stamps."""
    with tick(tracer, EAGER) as t:
        if t.in_chain:
            yield None
            return
        t.in_chain = True
        try:
            if not t.names:
                t.stamp("start", x.device)
            yield t
        finally:
            t.in_chain = False


@contextlib.contextmanager
def capturing(tracer: "Tracer | None", stream):
    """Around a captured step's capture.  With ``tracer``: the tracer
    active and a capture's tick open, whose stamps the graph holds, for
    replays on ``stream``; yields the tick.  Without: no tracer active at
    all, so the graph holds no stamp; yields None."""
    if tracer is None:
        with suspended():
            yield None
        return
    with using(tracer), tick(tracer, CAPTURE, stream) as t:
        yield t


def stamp_boundary(name: str) -> None:
    """A stamp named ``name`` on the tick open on this thread, if a chain
    has stamped it (a captured step's carry write-back)."""
    t = local.tick
    if t is not None and t.names:
        t.stamp(name)


def timed_source(source, tracer: "Tracer", base: int):
    """``source`` with a ``source`` span around each ``next``: for a radio,
    the wait for its next block."""
    it = iter(source)
    for i in itertools.count():
        t0 = now()
        try:
            raw = next(it)
        except StopIteration:
            return
        tracer.span("source", base + i, t0)
        yield raw


# -- the tracer -------------------------------------------------------------------


class Tracer:
    """Rings of device stamps and host spans, and the counters of the runs
    that record into it: ``RING_TICKS`` rows of up to ``STAMPS`` stamps and
    ``RING_SPANS`` host spans; each ring keeps the newest."""

    def __init__(self):
        self.R, self.K, self.S = RING_TICKS, STAMPS, RING_SPANS
        self.block = -1  # the id the rows claimed now belong to (the runner's block)
        self._lock = threading.Lock()
        self._ring = self._slot = None
        self._lane = None  # (device, stream handle) of the ticks the ring records
        self._calib: list[Calibration] = []
        self._exited = False  # the end calibration is taken on leaving, else at each read
        self._n_rows = 0
        self._row_mode = np.zeros(self.R, np.int8)
        self._row_layout = np.zeros(self.R, np.int32)
        self._row_id = np.zeros(self.R, np.int64)
        self._row_thread = np.zeros(self.R, np.int32)
        self._layouts: dict[tuple, int] = {}
        self._span_n = 0
        self._sp_name = np.zeros(self.S, np.int32)
        self._sp_id = np.zeros(self.S, np.int64)
        self._sp_t = np.zeros((self.S, 2), np.int64)
        self._sp_thread = np.zeros(self.S, np.int32)
        self._names: dict[str, int] = {}
        self._threads: dict[int, int] = {}
        self._runs = itertools.count()
        self._counted: list[tuple[object, tuple, tuple]] = []
        self._launches0 = _launch_counts()
        self._outer = None

    # -- switching on and off

    def __enter__(self) -> "Tracer":
        self._launches0 = _launch_counts()
        self._outer, local.tracer = local.tracer, self
        self._exited = False
        return self

    def __exit__(self, *exc) -> None:
        local.tracer = self._outer
        self._end_calibration()
        self._exited = True

    # -- the device ring

    def ring(self, device, stream=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The ring and its counter, made on ``device`` at first use (and the
        first calibration taken).  ``stream``: the stream the tick runs on
        (None: the device's current stream).  A tick on another device or
        stream than the first raises ``ValueError``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        lane = (device, _stream_handle(device, stream))
        if self._ring is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("tracer: the ring must be made before a capture (Tracer.ring(device))")
            self._ring = torch.zeros((self.R, self.K), dtype=torch.int64, device=device)
            self._slot = torch.zeros(1, dtype=torch.int64, device=device)
            self._lane = lane
            if device.type == "cuda":
                self._calib.append(self._calibrate())
        elif lane != self._lane:
            raise ValueError(f"tracer: a tick on {_lane_name(lane)}, the ring records {_lane_name(self._lane)}; "
                             "a tracer records the ticks of one stream of one device")
        return self._ring, self._slot

    def _calibrate(self) -> Calibration:
        dev = self._ring.device
        scratch = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        slot = torch.zeros(1, dtype=torch.int64, device=dev)

        def once():
            stamp(scratch, slot, 0)
            torch.cuda.synchronize(dev)
            return scratch[0, 0]

        once()
        return calibrate(once)

    def _end_calibration(self) -> None:
        if self._ring is not None and self._ring.device.type == "cuda" and self._calib:
            self._calib[1:] = [self._calibrate()]

    def layout(self, names) -> int:
        key = tuple(names)
        with self._lock:
            return self._layouts.setdefault(key, len(self._layouts))

    def replay(self, cap, x: torch.Tensor, captured: bool) -> None:
        """A captured step's replay (``cap``: its ``_Capture``) with this
        tracer: the static-input copy (``step.copy_in``) and the launch
        (``step.replay``) as spans, and the row that the replay's stamps
        write claimed, as a capture's when ``captured``."""
        t0 = now()
        cap.x.copy_(x)
        t1 = now()
        self.span("step.copy_in", self.block, t0, t1)
        self.claim(cap.layout, CAPTURE if captured else REPLAY)
        cap.graph.replay()
        self.span("step.replay", self.block, t1)

    def claim(self, layout: int | None, mode: int) -> None:
        """The host's record of the row the next tick's stamps write."""
        if layout is None:
            return
        r = self._n_rows % self.R
        self._row_mode[r] = mode
        self._row_layout[r] = layout
        self._row_id[r] = self.block
        self._row_thread[r] = self._thread()
        self._n_rows += 1

    # -- host spans and counters

    def _thread(self) -> int:
        ident = threading.get_ident()
        i = self._threads.get(ident)
        if i is None:
            with self._lock:
                i = self._threads.setdefault(ident, len(self._threads))
        return i

    def span(self, name: str, id: int, t0: int, t1: int | None = None) -> None:
        """One host span, from ``t0`` to ``t1`` (now when None), in ns of
        ``perf_counter_ns``."""
        t1 = now() if t1 is None else t1
        k = self._names.get(name)
        with self._lock:
            if k is None:
                k = self._names.setdefault(name, len(self._names))
            i = self._span_n % self.S
            self._span_n += 1
        self._sp_name[i] = k
        self._sp_id[i] = id
        self._sp_t[i] = (t0, t1)
        self._sp_thread[i] = self._thread()

    def run_base(self) -> int:
        """The first block id of a new run: the run's number above bit 32."""
        return next(self._runs) << 32

    def count_from(self, obj, fields: tuple[str, ...]) -> None:
        """Read the counters ``fields`` of ``obj`` (a run's ``RunStats``) at
        ``summary``, less what they held now."""
        with self._lock:
            self._counted.append((obj, fields, tuple(getattr(obj, f) for f in fields)))

    # -- reading

    def _to_host(self, dev_ns: np.ndarray) -> np.ndarray:
        """Card ns onto the host's clock (the identity for a CPU ring)."""
        if not self._calib:
            return dev_ns
        c0 = self._calib[0]
        if len(self._calib) == 1:
            return dev_ns + c0.offset_ns
        c1 = self._calib[-1]
        span = max(1, c1.device_ns - c0.device_ns)
        frac = (dev_ns - c0.device_ns) / span
        # the offset itself is ~1e18 ns: only its small drift goes through floats
        return dev_ns + c0.offset_ns + np.rint(frac * (c1.offset_ns - c0.offset_ns)).astype(np.int64)

    def rows(self) -> dict:
        """The kept rows, oldest first: ``stamps`` (n, K) card ns (-1 past a
        row's last stamp), ``host`` the same on the host's clock, ``mode``,
        ``layout`` (an index into ``names``), ``id``, ``thread``, ``names``
        (each layout's stamp names) and ``claimed`` (every row ever claimed,
        kept or not)."""
        n = self._n_rows
        kept = min(n, self.R)
        order = (np.arange(n - kept, n) % self.R) if kept else np.zeros(0, np.int64)
        names = [list(k) for k, _ in sorted(self._layouts.items(), key=lambda kv: kv[1])]
        if self._ring is None:
            stamps = np.zeros((0, self.K), np.int64)
        else:
            if self._ring.device.type == "cuda":
                torch.cuda.synchronize(self._ring.device)
                if not self._exited:
                    self._end_calibration()
            ring = self._ring.cpu().numpy()
            written = int(self._slot.cpu()[0])
            if written != n:
                raise RuntimeError(f"tracer: {written} ticks stamped, {n} claimed on the host")
            stamps = ring[order].copy()
        layout = self._row_layout[order]
        widths = np.array([len(x) for x in names], np.int64)
        if kept:
            past = np.arange(self.K)[None, :] >= widths[layout][:, None]
            stamps[past] = -1
        host = np.where(stamps >= 0, self._to_host(stamps), -1)
        return {"stamps": stamps, "host": host, "mode": self._row_mode[order], "layout": layout,
                "id": self._row_id[order], "thread": self._row_thread[order], "names": names, "claimed": n}

    def spans(self, name: str | None = None) -> dict:
        """The kept spans (all, or those named ``name``), oldest first:
        ``name`` (indices into ``names``), ``id``, ``t0``, ``t1``,
        ``thread``, ``names``, ``recorded`` (every span ever recorded)."""
        n = self._span_n
        kept = min(n, self.S)
        order = np.arange(n - kept, n) % self.S
        names = [k for k, _ in sorted(self._names.items(), key=lambda kv: kv[1])]
        sel = order
        if name is not None:
            k = self._names.get(name, -1)
            sel = order[self._sp_name[order] == k]
        return {"name": self._sp_name[sel], "id": self._sp_id[sel], "t0": self._sp_t[sel, 0],
                "t1": self._sp_t[sel, 1], "thread": self._sp_thread[sel], "names": names, "recorded": n}

    def counters(self) -> dict:
        """The counters of the runs that record into the tracer (their
        ``RunStats``: blocks, samples, the step's captures and eager ticks)
        and the kernel wrappers' launches, since each joined: ``launches``
        by wrapper, and each other counter of the wrappers
        (``kernels.COUNTERS``: ``channel_rows``, ``shared_rows``, ``rows``)
        where one moved."""
        out: dict = {}
        for obj, fields, base in list(self._counted):
            for f, b in zip(fields, base):
                out[f] = out.get(f, 0) + getattr(obj, f) - b
        out["launches"] = {}
        for (f, name), v in _launch_counts().items():
            if v != self._launches0.get((f, name), 0):
                out.setdefault(f, {})[name] = v - self._launches0.get((f, name), 0)
        return out

    def clock(self) -> dict:
        if not self._calib:
            return {"device": "cpu" if self._ring is not None else None, "offset_ns": 0,
                    "uncertainty_ns": 0.0, "drift_ns": 0}
        c0, c1 = self._calib[0], self._calib[-1]
        return {"device": str(self._ring.device), "offset_ns": int(c0.offset_ns),
                "uncertainty_ns": float(max(c0.uncertainty_ns, c1.uncertainty_ns)),
                "drift_ns": int(c1.offset_ns - c0.offset_ns)}

    def summary(self) -> dict:
        """Everything the rings hold, reduced: ``spans`` (per name: count,
        total, p50, p95 and self time, ms), ``stages`` (per stage: its
        device time inside the tick, p50 and p95, us, over the replays, or
        over every tick where none replayed), ``ticks``, ``gaps`` (between
        consecutive ticks, us, and their total by the innermost span open
        at each gap's middle on the thread that launched the next tick),
        ``counters`` and ``clock``."""
        rows = self.rows()
        sp = self.spans()
        clock = self.clock()
        clock["resolution_ns"] = _resolution(rows["stamps"])
        return {"spans": _span_table(sp), "spans_dropped": sp["recorded"] - len(sp["t0"]),
                **_tick_tables(rows, sp), "counters": self.counters(), "clock": clock}


# -- reductions --------------------------------------------------------------------


def _stream_handle(device: torch.device, stream) -> int | None:
    if device.type != "cuda":
        return None
    return (stream if stream is not None else torch.cuda.current_stream(device)).cuda_stream


def _lane_name(lane) -> str:
    device, handle = lane
    return str(device) if handle is None else f"{device} stream {handle:#x}"


def _launch_counts() -> dict:
    """{(counter, wrapper name): value} of every kernel wrapper."""
    from tpusdr_torch import kernels

    return {(f, w.__name__): v for (w, f), v in kernels.counts().items()}


def _pct(v, q) -> float:
    return float(np.percentile(v, q)) if len(v) else 0.0


def _resolution(stamps: np.ndarray) -> int:
    """The greatest common step of the stamps' differences within rows."""
    g = 0
    for row in stamps[:256]:
        row = row[row >= 0]
        for d in np.diff(row):
            g = gcd(g, int(d))
    return g


def self_times(t0: np.ndarray, t1: np.ndarray, thread: np.ndarray) -> np.ndarray:
    """Each span's duration less the parts of it that its child spans (the
    spans of its thread directly inside it) cover."""
    out = (t1 - t0).astype(np.int64)
    for th in np.unique(thread):
        idx = np.flatnonzero(thread == th)
        idx = idx[np.lexsort((-t1[idx], t0[idx]))]
        stack: list[int] = []
        for i in idx:
            while stack and t0[i] >= t1[stack[-1]]:
                stack.pop()
            if stack and t1[i] <= t1[stack[-1]]:
                out[stack[-1]] -= t1[i] - t0[i]
            stack.append(i)
    return out


def _span_table(sp: dict) -> dict:
    selfs = self_times(sp["t0"], sp["t1"], sp["thread"])
    dur = sp["t1"] - sp["t0"]
    table = {}
    for k, name in enumerate(sp["names"]):
        m = sp["name"] == k
        if not m.any():
            continue
        d = dur[m] * 1e-6
        table[name] = {"count": int(m.sum()), "total_ms": float(d.sum()), "p50_ms": _pct(d, 50),
                       "p95_ms": _pct(d, 95), "self_ms": float(selfs[m].sum() * 1e-6)}
    return table


class _OpenSpans:
    """Which span of a thread is open at a time: the latest-starting one
    that contains it."""

    def __init__(self, sp: dict, back: int = 256):
        self.sp, self.back = sp, back
        self.by_thread = {}
        for th in np.unique(sp["thread"]):
            idx = np.flatnonzero(sp["thread"] == th)
            idx = idx[np.argsort(sp["t0"][idx], kind="stable")]
            self.by_thread[int(th)] = (idx, sp["t0"][idx])

    def at(self, thread: int, t: int) -> str:
        """The innermost span of ``thread`` open at ``t``; 'no span' when
        none is."""
        found = self.by_thread.get(int(thread))
        if found is None:
            return "no span"
        idx, starts = found
        j = int(np.searchsorted(starts, t, side="right")) - 1
        for i in idx[max(0, j - self.back + 1) : j + 1][::-1]:
            if self.sp["t1"][i] > t:
                return self.sp["names"][self.sp["name"][i]]
        return "no span"


def _tick_tables(rows: dict, sp: dict) -> dict:
    st, mode, layout, names = rows["stamps"], rows["mode"], rows["layout"], rows["names"]
    n = len(st)
    widths = np.array([len(x) for x in names], np.int64)[layout] if n else np.zeros(0, np.int64)
    first = st[:, 0] if n else np.zeros(0, np.int64)
    last = st[np.arange(n), widths - 1] if n else np.zeros(0, np.int64)
    use = mode == REPLAY if (mode == REPLAY).any() else np.ones(n, bool)
    stages: dict = {}
    for lid, lnames in enumerate(names):
        m = use & (layout == lid)
        if not m.any():
            continue
        for k in range(1, len(lnames)):
            d = (st[m, k] - st[m, k - 1]) * 1e-3
            acc = stages.setdefault(lnames[k], [])
            acc.extend(d.tolist())
    stage_table = {k: {"count": len(v), "p50_us": _pct(v, 50), "p95_us": _pct(v, 95)} for k, v in stages.items()}
    tick_us = (last - first)[use] * 1e-3
    ticks = {"claimed": rows["claimed"], "kept": n, **{m_: int((mode == i).sum()) for i, m_ in enumerate(MODES)},
             "stages_from": "replay" if (mode == REPLAY).any() else "all",
             "p50_us": _pct(tick_us, 50), "p95_us": _pct(tick_us, 95)}
    gaps_us = (first[1:] - last[:-1]) * 1e-3 if n > 1 else np.zeros(0)
    by: dict = {}
    if n > 1:
        host = rows["host"]
        hlast = host[np.arange(n), widths - 1]
        open_at = _OpenSpans(sp)
        for j in range(1, n):
            label = open_at.at(rows["thread"][j], (hlast[j - 1] + host[j, 0]) // 2)
            e = by.setdefault(label, {"count": 0, "total_ms": 0.0})
            e["count"] += 1
            e["total_ms"] += float(gaps_us[j - 1]) * 1e-3
    gaps = {"count": len(gaps_us), "p50_us": _pct(gaps_us, 50), "p95_us": _pct(gaps_us, 95),
            "total_ms": float(gaps_us.sum() * 1e-3), "by_span": by}
    return {"stages": stage_table, "ticks": ticks, "gaps": gaps}


# -- lining a profiler trace up with the ring ---------------------------------------


def line_up(stamp_starts_ns, rows: dict, match: int = 64) -> dict:
    """Match a profiler trace's stamp records (their start times, on the
    profiler's clock, oldest first) to the ring's stamps: the stamps the
    trace holds are a run of consecutive ring stamps, found where the
    records' steps best match the ring's.  Returns the first matched ring
    stamp's (row, k) ``at``, the ``offset_ns`` (profiler clock less card
    clock, median over the records), its ``spread_ns`` (max less min) and
    the ``residual_ns`` of the steps' match."""
    p = np.sort(np.asarray(stamp_starts_ns, np.int64))
    st = rows["stamps"]
    where = np.argwhere(st >= 0)
    g = st[where[:, 0], where[:, 1]]
    order = np.argsort(g, kind="stable")
    g, where = g[order], where[order]
    m = min(match, len(p) - 1)
    if m < 1 or len(g) < len(p):
        raise ValueError("line_up: too few stamps to match")
    dp = np.diff(p[: m + 1])
    dg = np.diff(g)
    windows = np.lib.stride_tricks.sliding_window_view(dg, m)
    cost = np.abs(windows - dp[None, :]).sum(axis=1)
    s = int(np.argmin(cost[: len(g) - len(p) + 1]))
    off = p - g[s : s + len(p)]
    return {"at": tuple(int(v) for v in where[s]), "offset_ns": int(np.median(off)),
            "spread_ns": int(off.max() - off.min()), "residual_ns": float(cost[s] / m)}


def attribute(records, rows: dict) -> dict:
    """Device records of a profiler trace, ``(name, start_ns, duration_ns)``
    on the profiler's clock, summed by the stage they ran in: a record
    belongs to the stage whose stamps bracket its start.  Stamps are lined
    up with ``line_up``; records outside every stamped tick go under
    'between ticks'.  Returns {stage: {name: total ns}}."""
    records = sorted(records, key=lambda r: r[1])
    stamps = [r[1] for r in records if STAMP_KERNEL in r[0]]
    fit = line_up(stamps, rows)
    st = rows["stamps"]
    bounds, labels = [], []
    for r in range(len(st)):
        lnames = rows["names"][rows["layout"][r]]
        for k in range(len(lnames)):
            bounds.append(st[r, k] + fit["offset_ns"])
            labels.append("between ticks" if k == 0 else lnames[k])
    bounds = np.asarray(bounds, np.int64)
    out: dict = {}
    for name, start, dur in records:
        if STAMP_KERNEL in name:
            continue
        j = int(np.searchsorted(bounds, start, side="right"))
        label = labels[j] if 0 < j < len(labels) else "between ticks"
        by = out.setdefault(label, {})
        by[name] = by.get(name, 0) + int(dur)
    return out
