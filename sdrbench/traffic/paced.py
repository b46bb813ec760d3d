"""The ``paced`` mode (open loop, through ``StreamRunner``): blocks of one
radio transfer offered at the radio's rate; block i is due at
t0 + (i+1) x block / rate and handed over no earlier, whatever the runner
does.  The sink stamps each write.  End to end: ``audio_latency_p95_ms``,
over every block due in the window, a block never delivered counting as
infinitely late.

The mix's parameters: ``block_samples`` (one radio transfer, rounded up to
the chain's granule), ``pool_blocks`` (distinct blocks in host memory,
cycled), ``check_ticks`` and ``trace_slice_s``.
"""

from __future__ import annotations

import time

import numpy as np

from sdrbench.window import Window, block_samples, runner_result, runner_window

NEVER_MS = 1e9  # the latency of a block never delivered: beyond any percentile's limit


class Pacer:
    """The open loop's schedule: block i is due at t0 + (i+1) x period and
    is handed over no earlier; a block handed over late is not waited for
    again, and its lateness is recorded.  ``clock`` and ``sleep`` are the
    host's unless a test gives its own."""

    def __init__(self, period: float, blocks: int, clock=time.perf_counter, sleep=time.sleep):
        self.period, self.blocks, self.clock, self.sleep = period, blocks, clock, sleep
        self.late = np.zeros(blocks)

    def due(self, t0: float) -> np.ndarray:
        return t0 + (np.arange(self.blocks) + 1) * self.period

    def source(self, pool: list, t0_ref: list):
        for i in range(self.blocks):
            due = t0_ref[0] + (i + 1) * self.period
            wait = due - self.clock()
            if wait > 0:
                self.sleep(wait)
            self.late[i] = self.clock() - due
            yield pool[i % len(pool)]

    def latencies_ms(self, t0: float, stamps: list[float]) -> np.ndarray:
        """Each block's time from due to its audio's write; ``NEVER_MS`` for
        a block never written."""
        lat = np.full(self.blocks, NEVER_MS)
        done = min(len(stamps), self.blocks)
        lat[:done] = (np.asarray(stamps[:done]) - self.due(t0)[:done]) * 1e3
        return lat


def p95(latencies_ms: np.ndarray) -> float:
    """The 95th percentile, numpy's linear interpolation between ranks."""
    return float(np.percentile(latencies_ms, 95))


def drive(c) -> Window:
    n = block_samples(c.traffic, c.cfg, c.chain.granule)
    period = n / float(c.cfg["rf_sample_rate"])
    pacer = Pacer(period, int(c.seconds / period))
    pool, sink, sampler, sl, t0, _, cpu = runner_window(c, n, pacer.source)
    lat = pacer.latencies_ms(t0, sink.stamps)
    w = runner_result(c, n, pool, sink, sampler, sl, cpu, {"audio_latency_p95_ms": p95(lat)}, pacer.blocks)
    done = len(sink.stamps)
    third = max(1, done // 3)
    w.notes["live"] = {
        "block": n,
        "period_ms": period * 1e3,
        "blocks": pacer.blocks,
        "generator_late_ms_p50_p99_max": [float(np.percentile(pacer.late, q)) * 1e3 for q in (50, 99, 100)],
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_median_first_third_last_third": [
            float(np.median(lat[:third])), float(np.median(lat[done - third : done]))
        ],
    }
    return w
