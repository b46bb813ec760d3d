"""The readings a cell's limit is set from.

    python3 -m sdrbench.control --workload <name> --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2]

  * program: ``run.run_cell`` for each seed, a short window at the cell's
    own sizes and load, all in this process; its ``audio_peak_err_db``;
  * control: the reference itself put in the program's place, computed in
    bfloat16 (the precision below the configuration's float32), on the
    cell's own blocks made from each seed; its ``audio_peak_err_db``
    against the float64 reference.

The benchmark's runs never run this.  One JSON line a reading, then the
largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sdrbench import check as check_mod
from sdrbench import run as run_mod
from sdrbench.signal import Band
from sdrbench.window import block_samples


def control_reading(workload: str, seed: int, device, blocks: int = 12, sizes: dict | None = None,
                    dtype=torch.bfloat16) -> float:
    """Worst ``audio_peak_err_db`` of the reference in ``dtype`` against
    the float64 reference over blocks 1 .. blocks-1 of the cell's stream."""
    spec = run_mod.load_spec(workload)
    cfg = dict(spec["cfg"])
    sizes = dict(sizes or {})
    if "period" in sizes:
        cfg["signal"] = {**cfg["signal"], "period": sizes["period"]}
    chain, _ = run_mod.build_chain(cfg)
    n = int(sizes.get("tick", block_samples(spec["traffic"], cfg, chain.granule)))
    band = Band(cfg, seed, device)
    wires = [band.block(j * n, n) for j in range(blocks)]

    def inputs(index: int, k: int):
        lo = max(0, index - k)
        return torch.cat(wires[lo : index + 1]), lo * n, (index - lo) * n

    mod = check_mod.reference_module(cfg)
    plan = mod.plan(cfg["reference"])
    worst = -1e9
    for index in range(1, blocks):
        ref = check_mod.decode_tick(cfg, plan, inputs, index, n, device)
        low = check_mod.decode_tick(cfg, plan, inputs, index, n, device, dtype=dtype)
        worst = max(worst, check_mod.peak_err_db(low, ref))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="program and control readings of a cell's check")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    run_mod.pin_caches()
    if not torch.cuda.is_available():
        print("sdrbench.control: no CUDA device", file=sys.stderr)
        return 2
    prog, ctrl = [], []
    for s in filter(None, args.program_seeds.split(",")):
        r = run_mod.run_cell(args.workload, int(s), args.seconds, False, "cuda", say=lambda _: None)
        v = r["check"]["audio_peak_err_db"]["value"]
        prog.append(v)
        print(json.dumps({"arm": "program", "seed": int(s), "audio_peak_err_db": v, "correct": r["correct"],
                          "metrics": {k: m["value"] for k, m in r["metrics"].items()}}), flush=True)
        torch.cuda.empty_cache()
    for s in filter(None, args.control_seeds.split(",")):
        v = control_reading(args.workload, int(s), torch.device("cuda"))
        ctrl.append(v)
        print(json.dumps({"arm": "control_bf16", "seed": int(s), "audio_peak_err_db": v}), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": max(prog, default=None),
                      "control_min": min(ctrl, default=None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
