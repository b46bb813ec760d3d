"""Profiling and timing utilities (port of tpusdr/utils/profiling.py).

  * ``device_ms(fn, reps)`` — mean device time of ``fn()`` on CUDA events,
    with a spin kernel queued ahead so the events see the card's time and
    not the Python wrapper's launch latency;
  * ``trace(logdir)`` — context manager around ``torch.profiler`` that
    writes a Chrome trace of any streaming run;
  * ``time_block(block, x, device)`` — steady-state throughput of one block,
    through its captured step on a CUDA device (as the JAX package times
    the jitted step);
  * ``profile_chain(chain, x, device)`` — per-stage breakdown of a Chain;
  * ``scan_marginal(run, state0, xs)`` — the marginal wall time of one tick:
    a Theil-Sen slope over runs of several lengths, with its error bar
    (the JAX package's estimator, arithmetic for arithmetic), and
    ``captured_run(block, device)``, a ``run`` of k captured replays, so
    the slope is a replay's cost without the fixed costs of a run (the
    first replay, the sync, the host's return);
  * ``tile_ticks(xs, k, device)`` — a few host ticks uploaded once and
    tiled on the device into the k ticks of a run.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.runner import CapturedStep
from tpusdr_torch.utils.logging import get_logger

log = get_logger("profiling")

SPIN_CYCLES = 100_000_000  # ~50 ms at 2 GHz: covers enqueueing the timed calls
H100_PEAK_GBPS = 3350.0  # HBM3 bandwidth of an H100 SXM (NVIDIA's data sheet)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in milliseconds on CUDA events, after a
    warm-up.  A spin kernel queued first keeps the card busy while the host
    enqueues the timed calls, so back-to-back launches are measured at the
    card's pace."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def trace(logdir: str = "build/tpusdr_torch_trace"):
    """Capture a ``torch.profiler`` trace (CPU and, on a card, CUDA
    activity); yields the profiler, and writes ``trace.json`` (Chrome trace
    format) into ``logdir`` on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def sync_device(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_block(block, x: torch.Tensor, device, iters: int = 10, warmup: int = 2) -> dict:
    """Steady-state samples/s of one Block on ``device`` (host clock around
    ``iters`` steps that end in a synchronise).  The block's buffers must
    already be on ``device``.  On a CUDA device the step is the runner's
    captured one (``graph.runner.CapturedStep``: the first warm-up tick
    eager, the second captured); on the CPU it is ``apply``."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    step = CapturedStep(block) if on_card else block.apply
    state = block.init_state(device=device)
    xd = x.to(device)
    for _ in range(max(warmup, 2) if on_card else warmup):
        state, _ = step(state, xd)
    sync_device(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, _ = step(state, xd)
    sync_device(device)
    dt = (time.perf_counter() - t0) / iters
    n = x.shape[-1]
    return {"seconds_per_tick": dt, "msps": n / dt / 1e6, "tick": n}


def captured_run(block, device):
    """``run(state, xs) -> (state, y)``: ``len(xs)`` steps of ``block`` over
    the ticks ``xs`` (a leading tick axis), ``y`` the last tick's output.
    On a CUDA device the steps are one ``CapturedStep`` kept across runs,
    so after the first two ticks of a shape (eager, then the capture) a
    run of k ticks is k replays; on the CPU they are ``block.apply``.  The
    block's buffers must already be on ``device``.  A captured run's state
    and output are the graph's static buffers, valid until the next run."""
    device = torch.device(device)
    step = CapturedStep(block) if device.type == "cuda" else block.apply

    def run(state, xs):
        y = None
        for x in xs:
            state, y = step(state, x)
        return state, y

    return run


def scan_marginal(
    run,
    state0,
    xs,
    ks: tuple[int, ...] = (2, 6, 12),
    reps: int = 5,
    max_spread: float | None = None,
    retries: int = 1,
) -> dict:
    """Marginal per-tick seconds of ``run(state, xs[:k])`` via a Theil-Sen
    fit over ``reps x len(ks)`` (run length, wall time) points (the JAX
    package's ``scan_marginal``, its estimator arithmetic unchanged).

    The slope over run lengths leaves out what every run pays once: the
    first replay of a graph, the host's return from the sync, the launch
    of the run itself.  The arms are visited round-robin (k1, k2, ..., k1,
    ...) so slow drift shows up as per-point noise rather than per-arm
    bias, and the slope is the median of ALL cross-arm pairwise slopes
    over the raw points (Theil-Sen: robust to ~29% outliers, so a single
    hiccup cannot move the estimate).  ``spread`` is the error bar of the
    estimate: the interquartile range of per-round Theil-Sen estimates
    (each round-robin pass over the arms yields one) relative to the
    global median.  The raw pairwise-slope IQR (``pair_spread``) is also
    reported; it measures the points' scatter and overstates the
    estimator's uncertainty.

    Every arm runs once before the first timed point, so a run that
    compiles or captures on the first ticks of a shape (``captured_run``)
    has done so outside the slope.  Each timed run ends in
    ``torch.cuda.synchronize`` of the device of its output's first tensor
    (nothing to join on the CPU).

    Returns ``{'per_tick', 'spread', 'pair_spread', 'times', 'n_points'}``.
    Raises ``RuntimeError`` only when the measurement is meaningless
    (non-positive median slope after ``retries`` re-runs) or when the
    caller opts into a hard gate with ``max_spread``; fewer than 3 arms
    raise ``ValueError``.
    """
    if len(ks) < 3:
        raise ValueError(f"need >= 3 scan lengths for a robust slope, got {tuple(ks)}")

    def sync(ys) -> None:
        leaf = next((t for t in pytree.tree_leaves(ys) if isinstance(t, torch.Tensor)), None)
        if leaf is not None:
            sync_device(leaf.device)

    def run_once(k: int) -> None:
        s, ys = run(state0, pytree.tree_map(lambda a: a[:k], xs))
        sync(ys)

    def timed(k: int) -> float:
        t0 = time.perf_counter()
        run_once(k)
        return time.perf_counter() - t0

    last_err = None
    for _attempt in range(retries + 1):
        # warm every arm first: the first run of a length compiles or
        # captures; after this, timed runs are steady state
        for k in ks:
            run_once(k)
        points: list[tuple[int, float]] = []
        for _ in range(reps):
            for k in ks:
                points.append((k, timed(k)))

        def theil_sen(pts):
            s = sorted(
                (tb - ta) / (kb - ka)
                for i, (ka, ta) in enumerate(pts)
                for kb, tb in pts[i + 1 :]
                if kb != ka
            )
            return s

        slopes = theil_sen(points)
        med = slopes[len(slopes) // 2]
        if med <= 0:
            last_err = f"non-positive marginal slope {med:.3g}s"
            continue

        def iqr_rel(s):
            n = len(s)
            core = s[n // 4 : n - n // 4] or s
            return (core[-1] - core[0]) / med

        pair_spread = iqr_rel(slopes)
        # one independent estimate per round-robin pass -> estimator spread
        n_arms = len(ks)

        def round_median(r):
            s = theil_sen(points[r * n_arms : (r + 1) * n_arms])
            return s[len(s) // 2]

        round_est = sorted(round_median(r) for r in range(reps))
        spread = iqr_rel(round_est)
        # per-arm median wall times, for the human-readable report
        by_arm: dict[int, list[float]] = {k: [] for k in ks}
        for k, t in points:
            by_arm[k].append(t)
        times = {k: sorted(v)[len(v) // 2] for k, v in by_arm.items()}
        if max_spread is not None and spread > max_spread:
            last_err = f"slope spread {spread:.1%} > {max_spread:.0%} (times={times})"
            continue
        return {
            "per_tick": med,
            "spread": spread,
            "pair_spread": pair_spread,
            "times": times,
            "n_points": len(points),
        }
    raise RuntimeError(f"scan_marginal: unstable measurement: {last_err}")


def tile_ticks(xs_np, k: int, device):
    """Upload a few unique host ticks (leading axis) once and tile them to
    ``k`` on ``device``: rows ``i mod u`` for i < k, as the JAX package's
    ``tile(...)[:k]`` gives them.  The tile is a device-memory copy, so a
    run's ticks cost one upload of the unique ones.  Works on any pytree of
    arrays."""

    def tile_one(a_np):
        a = torch.from_numpy(np.ascontiguousarray(a_np)).to(device)
        rep = -(-k // a.shape[0])  # ceil
        return a.repeat((rep,) + (1,) * (a.ndim - 1))[:k]

    return pytree.tree_map(tile_one, xs_np)


def profile_chain(chain: Chain, x: torch.Tensor, device, iters: int = 10) -> list[dict]:
    """Per-stage steady-state timing of a Chain: the whole chain, then each
    stage alone on the input the stages before it produce (each through
    ``time_block``, so captured on a CUDA device)."""
    device = torch.device(device)
    results = [{"stage": "<whole chain>", **time_block(chain, x, device, iters)}]
    cur = x.to(device)
    for name, b in chain.blocks:
        results.append({"stage": name, **time_block(b, cur, device, iters)})
        _, cur = b.apply(b.init_state(device=device), cur)
    return results


def format_profile(rows: list[dict]) -> str:
    lines = [f"{'stage':<16} {'Msps':>10} {'ms/tick':>9} {'tick':>10}"]
    for r in rows:
        lines.append(
            f"{r['stage']:<16} {r['msps']:>10.1f} "
            f"{r['seconds_per_tick'] * 1e3:>9.2f} {r['tick']:>10}"
        )
    return "\n".join(lines)
