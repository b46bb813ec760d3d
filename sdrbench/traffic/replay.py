"""The ``replay`` mode (closed loop, on the card): a recording made on the
card from the seed is replayed cyclically as one continuous stream through
the runner's captured step (``CapturedStep``), the state carried; each
tick's audio is copied into a device buffer and, once a pass, fetched to
pinned host memory on a side stream.  The window ends when the last fetch
has landed.  End to end: ``capture_msps``, every sample of the window over
its whole length.

The mix's parameters: ``recording_s`` (the recording's length of RF),
``check_ticks`` (ticks sampled for the check besides the first and last)
and ``trace_slice_s`` (the profiled slice of a traced run).
"""

from __future__ import annotations

import time

import torch

from sdrbench import trace as trace_mod
from sdrbench.window import Sampler, Window, captured_step, wire_dtype


def drive(c) -> Window:
    tr, cfg, dev, n = c.traffic, c.cfg, c.device, c.tick
    R = max(3, round(float(tr["recording_s"]) * float(cfg["rf_sample_rate"]) / n))
    R = c.sizes.get("recording_ticks", R)
    rec = torch.empty((R, n), dtype=wire_dtype(cfg), device=dev)
    for t in range(R):
        rec[t] = c.band.block(t * n, n)
    c.sync()
    c.mark("data")
    step = captured_step(c.chain, dev)
    state = c.chain.init_state(device=dev)
    for g in range(3):  # eager, captured, replayed
        state, y = step(state, rec[g])
    first = 3
    bufs = [torch.empty((R,) + tuple(y.shape), dtype=y.dtype, device=dev) for _ in range(2)]
    on_card = dev.type == "cuda"
    hosts = [torch.empty(b.shape, dtype=b.dtype, pin_memory=on_card) for b in bufs]
    side = torch.cuda.Stream(dev) if on_card else None
    fetched = [None, None]  # the event behind each buffer's last fetch
    c.sync()
    sampler = Sampler(c.seed, int(tr["check_ticks"]))
    sl = trace_mod.Slice(c.trace, float(tr["trace_slice_s"]), dev)
    pending = None  # (pass, first index, indices) of the fetch in flight

    def consume(p_info):
        p, lo, hi = p_info
        if on_card:
            fetched[p % 2].synchronize()
        audio = hosts[p % 2].numpy()
        sampler.offer_many(range(lo, hi), audio[lo - p * R : hi - p * R])

    g = first
    cpu0 = time.process_time()
    c.t_window = t0 = time.perf_counter()
    while True:
        t = g % R
        p = g // R
        if t == 0 and on_card and fetched[p % 2] is not None:
            torch.cuda.current_stream(dev).wait_event(fetched[p % 2])  # its fetch has read it
        state, y = step(state, rec[t])
        bufs[p % 2][t].copy_(y)
        g += 1
        now = time.perf_counter() - t0
        sl.poll(now, g - first)
        if t == R - 1:
            if pending is not None:
                consume(pending)
            lo = max(first, p * R)
            if on_card:
                done = torch.cuda.Event()
                done.record()
                with torch.cuda.stream(side):
                    side.wait_event(done)
                    hosts[p % 2].copy_(bufs[p % 2], non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(side)
                fetched[p % 2] = ev
            else:
                hosts[p % 2].copy_(bufs[p % 2])
            pending = (p, lo, g)
            if now >= c.seconds:
                break
    consume(pending)
    t1 = time.perf_counter()
    cpu = time.process_time() - cpu0
    sl.stop(g - first)
    ticks = g - first

    def inputs(index: int, k: int):
        lo = max(0, index - k)
        return torch.cat([rec[j % R] for j in range(lo, index + 1)]), lo * n, (index - lo) * n

    w = Window(
        end_to_end={"capture_msps": ticks * n / (t1 - t0) / 1e6},
        attempted=ticks, failed=0, kept=sampler.kept(), lengths=sampler.lengths,
        inputs=inputs, tick=n, host_cpu_s=cpu - sl.cpu, host_ticks=ticks - sl.ticks, slice=sl,
    )
    w.notes["recording"] = {"ticks": R, "bytes": rec.numel() * rec.element_size(), "passes": ticks / R}
    w.stage_inputs = [rec[t] for t in range(min(8, R))]
    c.keep_alive = (rec, bufs, hosts, step, state)
    return w
