"""Capability probes of the staged-copy kernels (port of
benchmarks/pallas_mosaic_probes.py).

  W4  kernel K6: each of 4 blocks copies its 1024 rows of a (4096, 128)
      array from an offset computed at run time and writes ``s + 1``;
  X1  kernel K7: each block stages the 1034-row window at g*1024 of a
      (4106, 128) array (not a multiple of 8 rows, overlapping the next
      block's by 10) and writes rows 0:1024 of it times 2;
  X2  kernel K8: ``out[r] = sum_{p<11} x[r + p]`` from a staged
      (1034, 128) block, reading shared memory at every row offset.

Each probe first holds the whole output against the plain version on
seeded random data, then prints ``{"which": ..., "v": ...}`` where ``v`` is
output element [0, 0] for an input of ones, as the TPU probes print it
(W4 2.0, X1 2.0, X2 11.0).

``--time`` (card only) times the kernel instead: one JSON line a plan, the
rule's first, then each ``--plan``, all by uncounted launches.  W4 and X1
(``staging_plan``, ``staging_probes.launch``): ``PIECE[xGROUPS]``, the
largest piece in bytes and the groups of warps (1, 2, 4 or 8).  X2
(``shift_sum_plan``, ``staging_probes.launch_shift_sum``):
``[RUN][xGROUPS]``, the rows of a run and the groups of threads over a
run's rows, each left out the rule's.  Each line has the device microseconds
on CUDA events, the plan, its blocks, shared memory, staged bytes (X2
also the busiest block's), whether it is the rule's, whether its
output is exact, the library call's time on the same inputs (``torch.add``
for W4, ``torch.mul`` for X1, ``conv2d`` with a (1, 1, 11, 1) column of
ones for X2, in fp32) and the timer's trivial launch.  ``--input rotate``
rotates through 128 MiB of inputs (64 for W4 and X1, 254 for X2), past the
50 MB L2, so that every byte comes from device memory; by default one
fixed input is read from the L2.
``--wrapper`` times the wrapper as a caller calls it, with no plan: one
line, which needs nothing of the package but the wrappers, so that the
same timing can be run with another checkout's ``tpusdr_torch`` on the
path (``PYTHONPATH=<checkout> python tpusdr_torch/benchmarks/staging_probes.py
W4 --time --wrapper``, run from that checkout).

Run:  python -m tpusdr_torch.benchmarks.staging_probes X1
      python -m tpusdr_torch.benchmarks.staging_probes X1 --time --input rotate --plan 4096x4
      python -m tpusdr_torch.benchmarks.staging_probes X2 --time --plan 8x8 --plan x2
``--device`` defaults to ``cuda``; without a card pass ``--device cpu``
(not with ``--time``).
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import sys

import numpy as np
import torch

from tpusdr_torch.kernels import copy_floor
from tpusdr_torch.kernels import staging_probes as sp
from tpusdr_torch.utils.profiling import card_line, device_ms

B, P, GRID, W = 1024, 11, 4, 128
ROTATE_BYTES = 128 << 20  # inputs in rotation for --input rotate, past the 50 MB L2

#: which -> (input rows, wrapper call, plain version)
PROBES = {
    "W4": (GRID * B, lambda x: sp.staged_add_one(x, B), sp.staged_add_one_plain),
    "X1": (GRID * B + P - 1, lambda x: sp.staged_window_double(x, B, P),
           lambda x: sp.staged_window_double_plain(x, P)),
    "X2": (B + P - 1, lambda x: sp.staged_shift_sum(x, P), lambda x: sp.staged_shift_sum_plain(x, P)),
}


@functools.lru_cache(maxsize=None)
def _ones(device: torch.device) -> torch.Tensor:
    return torch.ones(1, 1, P, 1, device=device)


#: which -> (op, one PyTorch call that computes the same function)
TIMED = {
    "W4": (0, lambda x: torch.add(x, 1.0)),
    "X1": (1, lambda x: torch.mul(x[: GRID * B], 2.0)),
    "X2": (2, lambda x: torch.nn.functional.conv2d(x[None, None], _ones(x.device))[0, 0]),
}


def run_probe(which: str, device, seed: int = 0) -> dict:
    """Check one probe on random data, then return its ones-case line."""
    rows, kernel, plain = PROBES[which]
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, W)).astype(np.float32)).to(device)
    got, ref = kernel(x), plain(x)
    exact = bool(torch.equal(got, ref))
    ones = kernel(torch.ones((rows, W), dtype=torch.float32, device=device))
    return {"which": which, "v": float(ones[0, 0].item()), "rows": rows,
            "max_abs_err": float((got - ref).abs().max().item()), "ok": exact, "device": str(device)}


def parse_plan(spec: str, which: str = "W4") -> dict:
    """``PIECE[xGROUPS]`` (the largest piece in bytes, the groups of warps)
    as ``staging_plan`` keywords; for X2 ``[RUN][xGROUPS]`` (the rows of a
    run, the groups of threads; each left out is the rule's) as
    ``shift_sum_plan`` keywords."""
    if which == "X2":
        run, x, groups = spec.partition("x")
        if not spec or any(v and not (v.isdigit() and int(v) > 0) for v in (run, groups)) or (x and not groups):
            raise ValueError(f"plan {spec!r} is not [RUN][xGROUPS]")
        return {**({"run_rows": int(run)} if run else {}), **({"groups": int(groups)} if groups else {})}
    parts = spec.split("x")
    if not (1 <= len(parts) <= 2 and all(v.isdigit() for v in parts)) or (
            len(parts) == 2 and int(parts[1]) not in sp.GROUPS):
        raise ValueError(f"plan {spec!r} is not PIECE[xGROUPS] with GROUPS one of {sp.GROUPS}")
    return {"piece": int(parts[0]), **({"groups": int(parts[1])} if len(parts) == 2 else {})}


def time_calls(which: str, device, calls: dict, input_mode: str = "fixed", reps: int = 20,
               seed: int = 0) -> dict:
    """Device microseconds of each of ``calls`` (name -> call on one input
    of the probe's shape), of the library call on the same inputs and of
    the timer's trivial launch, each the mean of
    ``reps`` launches (from device memory one on each input of
    ``ROTATE_BYTES`` in rotation, two at least); each call's output is
    first held to the plain version.  Card only."""
    rows, _, plain = PROBES[which]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_inputs = max(2, -(-ROTATE_BYTES // (rows * W * 4))) if input_mode == "rotate" else 1
    xs = [torch.randn((rows, W), generator=gen, device=device) for _ in range(n_inputs)]
    turn = itertools.cycle(xs)
    reps = max(reps, len(xs))  # from device memory: every input once at least
    one = torch.zeros(1, device=device)
    out = {"launch_floor_us": device_ms(lambda: one.add_(1), reps) * 1e3}
    library = TIMED[which][1]
    out["library_us"] = device_ms(lambda: library(next(turn)), reps) * 1e3
    want = plain(xs[0])
    for name, call in calls.items():
        out[name] = {"exact": bool(torch.equal(call(xs[0]), want)),
                     "us": device_ms(lambda call=call: call(next(turn)), reps) * 1e3}
    return out


def time_probe(which: str, device, specs: tuple[str, ...] = (), input_mode: str = "fixed",
               reps: int = 20, seed: int = 0) -> list[dict]:
    """One line a plan of K6 (W4), K7 (X1) or K8 (X2): the rule's, then
    each of ``specs`` (``parse_plan``), by uncounted launches.  Card only."""
    if which == "X2":
        return time_shift_sum(device, specs, input_mode, reps, seed)
    rows = PROBES[which][0]
    op = TIMED[which][0]
    rows_out = rows - (P - 1 if op else 0)
    shape = (rows_out, W, *sp.windows(op, rows_out, B, P))
    device = torch.device(device)
    rule = sp.staging_plan(*shape, copy_floor.sm_count(device.index or 0))
    plans = {"rule": rule}
    for spec in specs:
        plans[spec] = sp.staging_plan(*shape, rule.blocks, **parse_plan(spec))
    calls = {spec: lambda x, plan=plan: sp.launch(op, x, B, P, plan) for spec, plan in plans.items()}
    times = time_calls(which, device, calls, input_mode, reps, seed)
    card = card_line()
    return [{"which": which, "plan_spec": spec, "input": input_mode, "us": times[spec]["us"],
             "plan": plan._asdict(), "blocks": plan.blocks, "smem": sp.staging_smem(plan),
             "staged_bytes": sp.staged_bytes(*shape),
             "is_rule_plan": plan == rule, "exact": times[spec]["exact"], "ok": times[spec]["exact"],
             "library_us": times["library_us"], "launch_floor_us": times["launch_floor_us"], "card": card}
            for spec, plan in plans.items()]


def time_shift_sum(device, specs: tuple[str, ...] = (), input_mode: str = "fixed", reps: int = 20,
                   seed: int = 0) -> list[dict]:
    """``time_probe`` for K8 (X2): one line a ``shift_sum_plan``."""
    device = torch.device(device)
    sms = copy_floor.sm_count(device.index or 0)
    rule = sp.shift_sum_plan(B, W, P, sms)
    plans = {"rule": rule, **{spec: sp.shift_sum_plan(B, W, P, sms, **parse_plan(spec, "X2")) for spec in specs}}
    calls = {spec: lambda x, plan=plan: sp.launch_shift_sum(x, P, plan) for spec, plan in plans.items()}
    times = time_calls("X2", device, calls, input_mode, reps, seed)
    card = card_line()
    lines = []
    for spec, plan in plans.items():
        staged, busiest = sp.shift_sum_staged(B, W, P, plan)
        lines.append({"which": "X2", "rows_out": B, "plan_spec": spec, "input": input_mode,
                      "us": times[spec]["us"],
                      "plan": plan._asdict(), "blocks": plan.blocks, "smem": sp.shift_sum_smem(B, P, plan),
                      "staged_bytes": staged, "busiest_bytes": busiest, "is_rule_plan": plan == rule,
                      "exact": times[spec]["exact"], "ok": times[spec]["exact"], "library_us": times["library_us"],
                      "launch_floor_us": times["launch_floor_us"], "card": card})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="staged-copy capability probes")
    ap.add_argument("which", nargs="?", default="W4", choices=sorted(PROBES))
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:1' or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time", action="store_true", help="time K6 (W4), K7 (X1) or K8 (X2) by plan (card only)")
    ap.add_argument("--plan", action="append", default=[],
                    help="with --time: a plan to time besides the rule's, PIECE[xGROUPS] (e.g. 4096x4); "
                         "for X2 [RUN][xGROUPS] (e.g. 8x8, x2)")
    ap.add_argument("--wrapper", action="store_true",
                    help="with --time: time the wrapper as a caller calls it instead, one line, no plan")
    ap.add_argument("--input", default="fixed", choices=("fixed", "rotate"),
                    help="with --time: one fixed input (from the L2) or 128 MiB in rotation (from device memory)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run the plain versions on the CPU")
    if not args.time and (args.plan or args.wrapper or args.input != "fixed"):
        ap.error("--plan, --wrapper and --input go with --time")
    if args.wrapper and args.plan:
        ap.error("--wrapper times no plan")
    if args.time:
        if device.type != "cuda":
            ap.error("--time measures the kernels: it needs a CUDA device")
        torch.backends.cudnn.allow_tf32 = False  # X2's library call in full fp32, as the kernel
        for spec in args.plan:
            try:
                parse_plan(spec, args.which)
            except ValueError as e:
                ap.error(f"--plan {spec}: {e}")
        if args.wrapper:
            times = time_calls(args.which, device, {"wrapper": PROBES[args.which][1]}, args.input, seed=args.seed)
            timed = times.pop("wrapper")
            lines = [{"which": args.which, "input": args.input, **timed, "ok": timed["exact"], **times,
                      "card": card_line()}]
        else:
            lines = time_probe(args.which, device, tuple(args.plan), args.input, seed=args.seed)
        for line in lines:
            print(json.dumps(line), flush=True)
        return 0 if all(line["ok"] for line in lines) else 1
    out = run_probe(args.which, device, args.seed)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
