"""A bounded slice of the window under ``torch.profiler``, reduced in memory.

Device records (kernels, copies, sets) give the slice: it runs from the
first record's start to the last one's end.  ``busy_s`` is the length of
the union of the records, ``window_s`` the slice's length.  Idle gaps between device records are
named by the innermost host event that was running at the gap's middle.
No trace file is written.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch


def warm_profiler(device) -> None:
    """Start and stop the profiler once in set-up, so that starting it in
    the window does not pay the tracer's first start."""
    with torch.profiler.profile(activities=_activities(device)):
        torch.ones(8, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _activities(device):
    """The card's records and the CUDA runtime calls (CUPTI) only: recording
    every host-side operator too slows the host enough to starve the card
    in a replayed window, so the idle share would measure the profiler."""
    if device.type == "cuda":
        return [torch.profiler.ProfilerActivity.CUDA]
    return [torch.profiler.ProfilerActivity.CPU]


class Slice:
    """Profiles from ``start_after`` seconds into the window for
    ``seconds``; ``poll(elapsed, ticks)`` is called by the driver after each
    tick.  The host's CPU time and the ticks inside the slice are recorded,
    so that the host's cost a tick can be taken over the rest of the
    window."""

    def __init__(self, enabled: bool, seconds: float, device, start_after: float = 1.0):
        self.enabled, self.seconds, self.device = enabled, seconds, device
        self.start_after = start_after
        self.prof = None
        self.state = "before"
        self.cpu = 0.0
        self.ticks = 0
        self._cpu0 = self._t0 = 0.0
        self._ticks0 = 0

    def poll(self, elapsed: float, ticks: int) -> None:
        if not self.enabled or self.state == "done":
            return
        if self.state == "before" and elapsed >= self.start_after:
            self._cpu0, self._ticks0, self._t0 = time.process_time(), ticks, elapsed
            self.prof = torch.profiler.profile(activities=_activities(self.device))
            self.prof.start()
            self.state = "on"
        elif self.state == "on" and elapsed - self._t0 >= self.seconds:
            self.stop(ticks)

    def stop(self, ticks: int) -> None:
        if self.state != "on":
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # every record of the slice has ended
        self.prof.stop()
        self.cpu = time.process_time() - self._cpu0
        self.ticks = ticks - self._ticks0
        self.state = "done"

    def reduce(self, top: int = 10) -> dict | None:
        """busy_s, window_s, device_records, device_ops, idle_gaps; None when the slice holds no device record."""
        if self.prof is None:
            return None
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                dev.append((s, s + d, e.name()))
            elif d > 0:
                host.append((s, s + d, e.name()))
        if not dev:
            return None
        dev.sort()
        merged: list[list[int]] = []
        for s, e, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        window = merged[-1][1] - merged[0][0]
        by_name: dict[str, int] = defaultdict(int)
        for s, e, name in dev:
            by_name[name[:120]] += e - s
        host.sort()
        starts = [h[0] for h in host]
        gaps: dict[str, int] = defaultdict(int)
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            gaps[_host_label(host, starts, (e0 + s1) // 2)] += s1 - e0
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {
            "busy_s": busy * 1e-9,
            "window_s": window * 1e-9,
            "device_records": len(dev),
            "device_ops": [[n, v * 1e-9] for n, v in ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in idle],
        }


def _host_label(host, starts, t: int) -> str:
    """The innermost host event running at ``t`` (the latest-starting one
    of those that contain it); 'host: no event' when none does."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 200), -1):
        s, e, name = host[j]
        if s <= t < e:
            return f"host: {name[:100]}"
    return "host: no event"
