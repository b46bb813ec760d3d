"""The FIR kernels in isolation against the card's own copy floor (port of
benchmarks/kernel_floor_probe.py).

At the WBFM shape (T=546, D=50, taps folded with a +2.5 MHz shift) and a
tick of 1,280,000 or 2,048,000 samples, one JSON line per arm:

  * ``dma``     — kernel K5 (``kernels.copy_floor``) at n_split 1, 2, 5, 10,
                  each line with the plan ``copy_floor_plan`` picks: the
                  tick pulled whole through shared memory, zero
                  arithmetic.  Its best rate is the ceiling the other arms
                  print beside their own.  On a card its first line is the
                  timer's floor: one trivial launch timed the same way; its
                  last is a read yardstick, ``torch.sum`` over the same
                  rotating ticks viewed as float32 (one PyTorch call that
                  reads the same bytes once; the port never calls it).
                  ``--plan PER_SMxPIECE`` (repeatable) also times plans
                  other than the rule's at n_split 1: blocks an SM and the
                  largest piece in bytes, uncounted launches through
                  ``copy_floor.launch``;
  * ``prelude`` — kernel K2 (``banded_fir_prelude``) streaming with its
                  8-row carry, after a value check against
                  ``fir.fir_extended(mode='mxu')``;
  * ``legacy``  — kernel K1 (``banded_fir``) as ``kernel_hist1copy``
                  (history through the second pointer), ``kernel_nohist``
                  and ``kernel_concat2copy`` (history concatenated first);
  * ``noslice`` — the prelude kernel on one fixed tick.

Each line has ``per_tick_ms``, ``value`` (Msps of input), the implied
minimum traffic in GB/s (8 B a sample read once, the decimated output
written once) and the card's name and power limit.  The ticks rotate
through a set larger than the L2 cache, so every arm but ``noslice`` reads
device memory.

Run:  python -m tpusdr_torch.benchmarks.kernel_floor_probe [--only dma]
      python -m tpusdr_torch.benchmarks.kernel_floor_probe --only dma --tick 12800000
(the second: K5 alone at a 102 MB tick, past the L2 cache on its own, which
separates the kernel's fixed part from its rate; 12,800,000 is a multiple
of 51,200 like every tick the probe takes).
``--device`` defaults to ``cuda``; without a card pass ``--device cpu``
(the plain versions on the host clock: a check of the arms, not a
measurement).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch

from tpusdr_torch.kernels import copy_floor as cf
from tpusdr_torch.kernels import fir_banded
from tpusdr_torch.ops import fir
from tpusdr_torch.utils.profiling import H100_PEAK_GBPS, card_line, device_ms

T, D = 546, 50
FS = 20e6
TICKS = (1_280_000, 2_048_000)
N_SPLITS = (1, 2, 5, 10)
N_UNIQUE = 8  # distinct ticks the timed loops rotate through
VALUE_TOL = 5e-5  # prelude kernel against the plain banded matmul, of peak
ARMS = ("dma", "prelude", "legacy", "noslice")


def wbfm_taps() -> np.ndarray:
    """The probe's taps: a 546-tap low-pass folded with a +2.5 MHz shift."""
    import scipy.signal as sps

    taps = sps.firwin(T, 2 * 100e3 / FS).astype(np.float32)
    shift = np.exp(-2j * np.pi * 2.5e6 / FS * np.arange(T)).astype(np.complex64)
    return (taps * shift).astype(np.complex64)


def launches_expected(reps: int, warmup: int = 3) -> dict:
    """Launches of each wrapper in one ``floor_probe(..., only="all")`` on a
    card: every timed arm makes ``warmup + reps`` calls (``device_ms``);
    each ``dma`` arm and the prelude arm make one more for the value check."""
    per_arm = warmup + reps
    return {
        "copy_floor": len(N_SPLITS) * (1 + per_arm),
        "banded_fir_prelude": 1 + 2 * per_arm,  # prelude (checked) and noslice
        "banded_fir": 3 * per_arm,
    }


def _per_tick_ms(fn, reps: int, device: torch.device) -> float:
    """CUDA events behind a spin kernel on a card, the host clock on a CPU."""
    if device.type == "cuda":
        return device_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _rates(tick: int, ms: float) -> dict:
    msps = tick / (ms * 1e3)
    return {
        "value": msps,
        "per_tick_ms": ms,
        "implied_min_traffic_gbps": msps * 1e6 * 8 * (1 + 1 / D) / 1e9,
    }


def arm_steps(xs: torch.Tensor, ctaps: torch.Tensor, decimation: int) -> dict:
    """The timed step of each FIR arm, as a zero-argument callable that
    returns the step's output.  ``xs`` is (n_unique, tick); every call takes
    the next tick in turn (the first call takes ``xs[1]``) and keeps the
    arm's carry, as the streaming caller would."""
    n_unique, tick = xs.shape
    T = ctaps.shape[-1]
    G, _ = fir_banded.prelude_plan(T, decimation)
    guard = fir_banded._GUARD
    turn = [0]

    def next_tick() -> torch.Tensor:
        turn[0] = (turn[0] + 1) % n_unique
        return xs[turn[0]]

    pre_zero = torch.zeros(guard, G, dtype=torch.complex64, device=xs.device)
    pre = [pre_zero]
    tail = [torch.zeros(T - 1, dtype=torch.complex64, device=xs.device)]

    def step_prelude():
        x = next_tick()
        y = fir_banded.banded_fir_prelude(x, pre[0], ctaps, decimation)
        pre[0] = x[tick - guard * G :].view(guard, G)
        return y

    def step_hist():
        x = next_tick()
        y = fir_banded.banded_fir(x, ctaps, decimation, history=tail[0])
        tail[0] = x[tick - (T - 1) :]
        return y

    def step_nohist():
        return fir_banded.banded_fir(next_tick(), ctaps, decimation)

    def step_concat():
        ext = torch.cat([tail[0], next_tick()])
        y = fir_banded.banded_fir(ext, ctaps, decimation)
        tail[0] = ext[ext.shape[-1] - (T - 1) :]
        return y

    def step_noslice():
        return fir_banded.banded_fir_prelude(xs[0], pre_zero, ctaps, decimation)

    return {
        "kernel_prelude": step_prelude,
        "kernel_hist1copy": step_hist,
        "kernel_nohist": step_nohist,
        "kernel_concat2copy": step_concat,
        "kernel_prelude_noslice": step_noslice,
    }


def parse_plan(spec: str) -> dict:
    """``PER_SMxPIECE`` (blocks an SM, the largest piece in bytes) as
    ``copy_floor_plan`` keywords."""
    try:
        per_sm, piece = (int(v) for v in spec.split("x"))
    except ValueError:
        raise ValueError(f"plan {spec!r} is not PER_SMxPIECE") from None
    return {"per_sm": per_sm, "piece": piece}


def floor_probe(device, tick: int = TICKS[0], reps: int = 20, only: str = "all",
                seed: int = 0, emit=None, plans: tuple[str, ...] = ()) -> list[dict]:
    """Run the arms ``only`` names at one tick; returns (and emits) their
    lines.  ``plans``: K5 plans besides the rule's (``parse_plan``), timed
    in the ``dma`` arm.  Raises ``ValueError`` for a tick the prelude form
    cannot take."""
    device = torch.device(device)
    G, _ = fir_banded.prelude_plan(T, D)
    guard = fir_banded._GUARD
    if tick % (guard * G) or tick < 2 * guard * G:
        raise ValueError(f"tick {tick} is not a usable multiple of 8G = {guard * G}")
    card = card_line() if device.type == "cuda" else "cpu"
    clock = "cuda_events" if device.type == "cuda" else "host"
    lines: list[dict] = []

    def out(**kw):
        kw.update(tick=tick, card=card, clock=clock)
        lines.append(kw)
        if emit is not None:
            emit(kw)

    rng = np.random.default_rng(seed)
    z = rng.standard_normal((N_UNIQUE, tick, 2)).astype(np.float32)
    xs = torch.view_as_complex(torch.from_numpy(z)).to(device)
    ctaps = torch.from_numpy(wbfm_taps()).to(device)
    arms = ARMS if only == "all" else (only,)
    steps = arm_steps(xs, ctaps, D)

    ceiling = None
    if "dma" in arms:
        if device.type == "cuda":
            one = torch.zeros(1, device=device)
            out(check="launch_floor", launch_floor_ms=device_ms(lambda: one.add_(1), reps),
                note="one trivial launch on the same timer: what every arm's time holds besides its work")
        n_rows = tick // G
        turn = itertools.cycle(xs)
        sms = cf.sm_count(device.index or 0) if device.type == "cuda" else cf.SM_COUNT
        want = cf.copy_floor_plain(xs[0].view(n_rows, G))

        def dma_line(metric: str, call, plan: cf.CopyFloorPlan, **extra):
            exact = bool(torch.equal(call(xs[0].view(n_rows, G)), want))
            ms = _per_tick_ms(lambda: call(next(turn).view(n_rows, G)), reps, device)
            gbps = tick * 8 / (ms * 1e6)
            total = cf.moved_bytes(n_rows, G) / (ms * 1e6)
            real = device.type != "cuda" or total <= H100_PEAK_GBPS
            out(metric=metric, **_rates(tick, ms), dma_gbps=gbps, moved_gbps=total, plan=plan._asdict(),
                values_exact=exact, within_peak=real, ok=exact and real, **extra,
                note="asynchronous copy in + (n_rows, 128) out only; random data, ticks rotate past the L2")
            return gbps if exact and real else None

        for n_split in N_SPLITS:
            gbps = dma_line(f"dma_floor_split{n_split}_msps", lambda x, n_split=n_split: cf.copy_floor(x, n_split),
                            cf.copy_floor_plan(n_rows, G, n_split, sms))
            if gbps is not None:
                ceiling = max(ceiling or 0.0, gbps)
        for spec in plans:
            plan = cf.copy_floor_plan(n_rows, G, 1, sms, **parse_plan(spec))
            launch = cf.launch if device.type == "cuda" else lambda x, n_split, plan: cf.copy_floor_plain(x)
            dma_line(f"dma_plan_{spec}_msps", lambda x, plan=plan: launch(x, 1, plan), plan,
                     is_rule_plan=plan == cf.copy_floor_plan(n_rows, G, 1, sms))
        ms = _per_tick_ms(lambda: next(turn).view(torch.float32).sum(), reps, device)
        out(yardstick="read_sum_f32", per_tick_ms=ms, read_gbps=tick * 8 / (ms * 1e6),
            note="torch.sum over the same rotating ticks viewed as float32: one PyTorch call that reads "
                 "the tick's bytes once (a yardstick of the read rate, not the library call)")

    def timed(name: str, **extra):
        ms = _per_tick_ms(steps[name], reps, device)
        out(metric=f"{name}_msps", **_rates(tick, ms), ceiling_copy_floor_gbps=ceiling, **extra)

    if "prelude" in arms:
        pre0 = torch.zeros(guard, G, dtype=torch.complex64, device=device)
        yp = fir_banded.banded_fir_prelude(xs[0], pre0, ctaps, D)
        p0 = guard * G - (T - 1)
        flat = torch.cat([pre0.reshape(-1), xs[0]])
        yref = fir.fir_extended(flat[p0:], ctaps, D, mode="mxu")[: tick // D]
        err = ((yp - yref).abs().max() / yref.abs().max()).item()
        out(check="prelude_vs_plain_mxu", rel_err=err, ok=bool(err < VALUE_TOL))
        timed("kernel_prelude")
    if "legacy" in arms:
        for name in ("kernel_hist1copy", "kernel_nohist", "kernel_concat2copy"):
            timed(name)
    if "noslice" in arms:
        timed("kernel_prelude_noslice",
              note="the prelude kernel on one fixed tick: eager PyTorch slices no stacked scan input, "
                   "so what this arm isolates here is a tick that stays in the L2 cache")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="FIR kernels against the card's copy floor")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:1' or 'cpu'")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="all", choices=("all",) + ARMS)
    ap.add_argument("--tick", type=int, nargs="*", default=list(TICKS),
                    help="tick lengths in samples (multiples of 51,200)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", action="append", default=[],
                    help="a K5 plan to time besides the rule's, PER_SMxPIECE (dma arm, n_split 1)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain versions on the CPU")
    for spec in args.plan:
        try:
            parse_plan(spec)
        except ValueError as e:
            ap.error(f"--plan {spec}: {e}")
    ok = True
    for tick in args.tick:
        lines = floor_probe(device, tick, args.reps, args.only, args.seed,
                            emit=lambda kw: print(json.dumps(kw), flush=True), plans=tuple(args.plan))
        ok = ok and all(line.get("ok", True) for line in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
