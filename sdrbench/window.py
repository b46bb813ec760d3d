"""What every traffic mode shares: the window a mode's driver returns, the
sample of ticks kept for the check, the block a mix drives, and the set-up
and window of a mix fed through ``StreamRunner``.

A mode is a file of its own, ``sdrbench/traffic/<mode>.py``, with one
function ``drive(cell) -> Window``; ``run.drive`` finds it by the ``mode``
that a traffic file names.  Every driver keeps the audio of a sample of
ticks drawn from the seed (``Sampler``) for the check against the
reference, and says how to find each tick's input again
(``Window.inputs``).
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from sdrbench import trace as trace_mod


class Sampler:
    """The audio of the first tick of the window, the last one, and a
    reservoir of ``k`` others drawn from the seed (Algorithm R)."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng([seed, 0x5d7b])
        self.k = k
        self.first = None
        self.last = None
        self.res: list = []
        self.seen = 0
        self.lengths: Counter = Counter()  # ticks by audio length

    def offer(self, index: int, audio: np.ndarray) -> None:
        self.offer_many(range(index, index + 1), audio[None])

    def offer_many(self, indices: range, audio: np.ndarray) -> None:
        """Offer consecutive ticks whose audio is stacked in ``audio``;
        copies only what it keeps."""
        self.lengths[audio.shape[-1]] += len(indices)
        for j, g in enumerate(indices):
            if self.first is None:
                self.first = (g, np.array(audio[j]))
                continue
            self.seen += 1
            if len(self.res) < self.k:
                self.res.append((g, np.array(audio[j])))
            else:
                r = int(self.rng.integers(self.seen))
                if r < self.k:
                    self.res[r] = (g, np.array(audio[j]))
        if len(indices) and indices[-1] != self.first[0]:
            self.last = (indices[-1], np.array(audio[len(indices) - 1]))

    def kept(self) -> dict[int, np.ndarray]:
        out = dict(self.res)
        for item in (self.first, self.last):
            if item is not None:
                out[item[0]] = item[1]
        return out


@dataclass
class Window:
    end_to_end: dict
    attempted: int
    failed: int
    kept: dict
    lengths: Counter
    inputs: object  # (index, k) -> (wire samples of ticks index-k .. index, stream index of the first, context samples)
    tick: int
    host_cpu_s: float = 0.0
    host_ticks: int = 0
    slice: trace_mod.Slice | None = None
    notes: dict = field(default_factory=dict)
    stage_inputs: list = field(default_factory=list)


def wire_dtype(cfg: dict) -> torch.dtype:
    return torch.int16 if cfg["wire"] == "int8" else torch.complex64


def captured_step(chain, device):
    if device.type == "cuda":
        from tpusdr_torch.graph.runner import CapturedStep

        return CapturedStep(chain)
    return chain.apply


class Sink:
    """Stamps each write, offers the audio to the sampler and steps the
    trace slice."""

    def __init__(self, sampler: Sampler | None, sl: trace_mod.Slice | None, t0_ref: list):
        self.sampler, self.sl, self.t0_ref = sampler, sl, t0_ref
        self.stamps: list[float] = []

    def write(self, out: np.ndarray) -> None:
        now = time.perf_counter()
        if self.sampler is not None:
            self.sampler.offer(len(self.stamps), out)
        self.stamps.append(now)
        if self.sl is not None:
            self.sl.poll(now - self.t0_ref[0], len(self.stamps))


def make_pool(c, n: int, count: int) -> list[np.ndarray]:
    """``count`` distinct wire blocks of n samples, made on the card and
    brought to host memory once."""
    blocks = [c.band.block(j * n, n) for j in range(count)]
    return [b.cpu().numpy() for b in blocks]


def _runner(c):
    from tpusdr_torch.graph.runner import StreamRunner

    return StreamRunner(c.chain, device=c.device)


def _warm(runner, pool, c):
    """A warm run of three blocks: eager, captured, replayed.  It leaves the
    capture in place for the timed run."""
    c.mark("data")
    runner.run(iter(pool[:3]), Sink(None, None, [0.0]))
    c.sync()


def _pool_inputs(pool, n):
    P = len(pool)

    def inputs(index: int, k: int):
        lo = max(0, index - k)
        return torch.cat([torch.from_numpy(pool[j % P]) for j in range(lo, index + 1)]), lo * n, (index - lo) * n

    return inputs


def block_samples(traffic: dict, cfg: dict, granule: int) -> int:
    """The block a mix drives: a radio transfer (``block_samples``) rounded
    up to the chain's granule, else the configuration's tick."""
    if "block_samples" in traffic:
        return -(-int(traffic["block_samples"]) // granule) * granule
    return int(cfg["tick"])


def runner_window(c, n: int, make_source):
    """Set-up and window of a mix fed through ``StreamRunner``: a pool of distinct
    blocks in host memory, a warm run, then one timed ``run`` of
    ``make_source(pool, t0_ref)`` into a stamping sink.  Returns the pool,
    the sink, the sampler, the slice, the window's start and end and the
    process's CPU seconds over it."""
    tr = c.traffic
    pool = make_pool(c, n, c.sizes.get("pool_blocks", int(tr["pool_blocks"])))
    runner = _runner(c)
    _warm(runner, pool, c)
    sampler = Sampler(c.seed, int(tr["check_ticks"]))
    sl = trace_mod.Slice(c.trace, float(tr["trace_slice_s"]), c.device)
    t0_ref = [0.0]
    sink = Sink(sampler, sl, t0_ref)
    source = make_source(pool, t0_ref)
    cpu0 = time.process_time()
    c.t_window = t0_ref[0] = t0 = time.perf_counter()
    runner.run(source, sink)
    t1 = time.perf_counter()
    cpu = time.process_time() - cpu0
    sl.stop(len(sink.stamps))
    c.keep_alive = (pool, runner)
    return pool, sink, sampler, sl, t0, t1, cpu


def runner_result(c, n, pool, sink, sampler, sl, cpu, end_to_end, attempted) -> Window:
    done = len(sink.stamps)
    w = Window(
        end_to_end=end_to_end, attempted=attempted, failed=attempted - min(done, attempted),
        kept=sampler.kept(), lengths=sampler.lengths, inputs=_pool_inputs(pool, n), tick=n,
        host_cpu_s=cpu - sl.cpu, host_ticks=done - sl.ticks, slice=sl,
    )
    w.notes["block_bytes"] = pool[0].nbytes
    w.stage_inputs = [torch.from_numpy(b).to(c.device) for b in pool[:8]]
    return w


