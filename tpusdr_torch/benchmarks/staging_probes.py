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

``--time`` (W4 and X1, card only) times the kernel instead: one JSON line a
plan, the rule's (``staging_plan``) first, then each ``--plan
PIECE[xGROUPS]`` (the largest piece in bytes and the groups of warps, 1,
2, 4 or 8), all by uncounted launches through ``staging_probes.launch``.
Each line has the device microseconds on CUDA events, the plan, its blocks,
shared memory and staged bytes, whether it is the rule's, whether its
output is exact, the library call's time on the same inputs (``torch.add``
for W4, ``torch.mul`` for X1) and the timer's trivial launch.  ``--input rotate``
rotates through 64 inputs (128 MB, past the 50 MB L2) so that every byte
comes from device memory; by default one fixed input is read from the L2.
``--wrapper`` times the wrapper as a caller calls it, with no plan: one
line, which needs nothing of the package but the wrappers, so that the
same timing can be run with another checkout's ``tpusdr_torch`` on the
path (``PYTHONPATH=<checkout> python tpusdr_torch/benchmarks/staging_probes.py
W4 --time --wrapper``, run from that checkout).

Run:  python -m tpusdr_torch.benchmarks.staging_probes X1
      python -m tpusdr_torch.benchmarks.staging_probes X1 --time --input rotate --plan 4096x4
``--device`` defaults to ``cuda``; without a card pass ``--device cpu``
(not with ``--time``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np
import torch

from tpusdr_torch.kernels import copy_floor
from tpusdr_torch.kernels import staging_probes as sp
from tpusdr_torch.utils.profiling import card_line, device_ms

B, P, GRID, W = 1024, 11, 4, 128
N_ROTATE = 64  # inputs in rotation for --input rotate

#: which -> (input rows, wrapper call, plain version)
PROBES = {
    "W4": (GRID * B, lambda x: sp.staged_add_one(x, B), sp.staged_add_one_plain),
    "X1": (GRID * B + P - 1, lambda x: sp.staged_window_double(x, B, P),
           lambda x: sp.staged_window_double_plain(x, P)),
    "X2": (B + P - 1, lambda x: sp.staged_shift_sum(x, P), lambda x: sp.staged_shift_sum_plain(x, P)),
}
#: which -> (op, one PyTorch call that computes the same function)
TIMED = {
    "W4": (0, lambda x: torch.add(x, 1.0)),
    "X1": (1, lambda x: torch.mul(x[: GRID * B], 2.0)),
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


def parse_plan(spec: str) -> dict:
    """``PIECE[xGROUPS]`` (the largest piece in bytes, the groups of warps)
    as ``staging_plan`` keywords."""
    parts = spec.split("x")
    if not (1 <= len(parts) <= 2 and all(v.isdigit() for v in parts)) or (
            len(parts) == 2 and int(parts[1]) not in sp.GROUPS):
        raise ValueError(f"plan {spec!r} is not PIECE[xGROUPS] with GROUPS one of {sp.GROUPS}")
    return {"piece": int(parts[0]), **({"groups": int(parts[1])} if len(parts) == 2 else {})}


def time_calls(which: str, device, calls: dict, input_mode: str = "fixed", reps: int = 20,
               seed: int = 0) -> dict:
    """Device microseconds of each of ``calls`` (name -> call on one input
    of the probe's shape), of the library call on the same inputs and of
    the timer's trivial launch, each the mean of ``reps`` launches (of 64,
    one on each input, from device memory); each call's output is first
    held to the plain version.  Card only."""
    rows, _, plain = PROBES[which]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = [torch.randn((rows, W), generator=gen, device=device)
          for _ in range(N_ROTATE if input_mode == "rotate" else 1)]
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
    """One line a plan of K6 (W4) or K7 (X1): the rule's, then each of
    ``specs`` (``parse_plan``), by uncounted launches.  Card only."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="staged-copy capability probes")
    ap.add_argument("which", nargs="?", default="W4", choices=sorted(PROBES))
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:1' or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time", action="store_true", help="time K6 (W4) or K7 (X1) by plan (card only)")
    ap.add_argument("--plan", action="append", default=[],
                    help="with --time: a plan to time besides the rule's, PIECE[xGROUPS] (e.g. 4096x4)")
    ap.add_argument("--wrapper", action="store_true",
                    help="with --time: time the wrapper as a caller calls it instead, one line, no plan")
    ap.add_argument("--input", default="fixed", choices=("fixed", "rotate"),
                    help="with --time: one fixed input (from the L2) or 64 in rotation (from device memory)")
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
        if args.which not in TIMED:
            ap.error(f"--time takes {sorted(TIMED)}")
        for spec in args.plan:
            try:
                parse_plan(spec)
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
