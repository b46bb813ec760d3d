"""The benchmark of tpusdr_torch: one run of one cell.

    python3 -m sdrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``sdrbench/configs/<name>.json``: the
receiver to build, its sizes, its band and its reference) and a traffic
mix (``sdrbench/traffic/<name>.json``, read by the driver of its ``mode``,
``sdrbench/traffic/<mode>.py``).  A per-layer metric is read by
``sdrbench/metrics/<name>.py``.  So a cell, a configuration, a mix, a mode
or a metric is added with files of its own.

A run builds the receiver, makes its inputs on the card from the seed,
warms every shape it will use (the first run in a checkout also builds the
port's kernels, into ``build/tpusdr_torch/``), measures for ``--seconds``,
reads the device's peak memory, then decodes a sample of the ticks again
with the plain reference and compares.  With ``--trace 0`` the last line
of standard output carries the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics (a bounded slice of the window under the
profiler).  Without a CUDA device, or with fewer than the cell asks for,
it prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusdr")  # whole top-level module names


def pin_caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    own library into build/tpusdr_torch/ beside them)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "sdrbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "sdrbench" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_spec(workload: str) -> dict:
    """The cell, its configuration and mix, and the metrics it reports, as
    ``BENCHMARK.json`` names them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
    return {"cell": cell, "cfg": cfg, "traffic": traffic, "end_to_end": e2e, "per_layer": per_layer}


def build_chain(cfg: dict):
    """The configuration's receiver: ``build.function`` of
    ``tpusdr_torch.models`` with ``build.kwargs``, on the CPU.  With
    ``build.iq_format`` the port's ``IqToComplex`` goes ahead of it, as
    ``tpusdr_torch/apps/channels.py`` builds the bank for integer input."""
    from tpusdr_torch import models
    from tpusdr_torch.graph.blocks import IqToComplex
    from tpusdr_torch.graph.chain import Chain

    build = cfg["build"]
    chain, info = getattr(models, build["function"])(**build["kwargs"])
    if "iq_format" in build:
        chain = Chain([("iq", IqToComplex(build["iq_format"])), *chain.blocks])
    return chain, info


def _load(kind: str, name: str):
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"sdrbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_mode(mode: str):
    """The driver of a traffic mode, ``sdrbench/traffic/<mode>.py``."""
    return _load("traffic", mode)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Cell:
    """What a driver needs: the configuration, the mix, the built chain on
    its device, the band, the seed and the window's length."""

    def __init__(self, spec, seed, seconds, trace, device, sizes):
        import torch

        from sdrbench.signal import Band

        self.marks = {"imports": time.perf_counter()}  # set-up phases, for the earlier line
        self.spec, self.cfg, self.traffic = spec, spec["cfg"], spec["traffic"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.sizes = dict(sizes or {})
        torch.empty(0, device=self.device)  # the CUDA context, apart from the chain's build
        self.mark("card")
        self.chain, self.info = build_chain(self.cfg)
        self.chain.to(self.device)
        self.mark("chain")
        self.tick = int(self.sizes.get("tick", self.cfg["tick"]))
        cfg = dict(self.cfg)
        if "period" in self.sizes:
            cfg["signal"] = {**cfg["signal"], "period": self.sizes["period"]}
        self.band = Band(cfg, self.seed, self.device)
        self.keep_alive = None
        self.mark("band")

    def mark(self, phase: str) -> None:
        self.marks[phase] = time.perf_counter()

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Readings:
    """What a per-layer metric's reader reads: the cell, the window, the
    reduced trace slice and stages stepped alone."""

    def __init__(self, cell: Cell, window, sliced: dict | None):
        self.cell, self.window, self.trace = cell, window, sliced
        self.mode = cell.traffic["mode"]
        self._stages: dict = {}

    def stage(self, *kinds: str) -> dict | None:
        """The first stage of the chain whose block class is one of
        ``kinds``, stepped alone (``roofline.stage_alone_seconds``) on the
        ticks that the stages before it make of the window's first
        inputs: {'name', 'block', 'seconds', 'n_in', 'n_out'}; None when
        the chain has no such stage or the run is off the card."""
        if kinds in self._stages:
            return self._stages[kinds]
        from sdrbench import roofline

        found = None
        blocks = self.cell.chain.blocks
        for k, (name, block) in enumerate(blocks):
            if type(block).__name__ not in kinds:
                continue
            xs = []
            for x in self.window.stage_inputs:
                for _, before in blocks[:k]:
                    _, x = before.apply(before.init_state(device=x.device), x)
                xs.append(x)
            seconds = roofline.stage_alone_seconds(block, xs)
            if seconds is not None:
                n_in = xs[0].shape[-1]
                found = {"name": name, "block": block, "seconds": seconds, "n_in": n_in,
                         "n_out": block.out_len(n_in)}
            break
        self._stages[kinds] = found
        return found


def read_metric(name: str, readings: Readings):
    return _load("metrics", name).read(readings)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: no reading"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             sizes: dict | None = None, t_start: float = T_START, say=print) -> dict:
    """One run; returns the result object (the last line's JSON).  ``sizes``
    overrides sizes of the configuration or the mix (tests on the CPU)."""
    import torch

    from sdrbench import check as check_mod
    from sdrbench import trace as trace_mod
    from tpusdr_torch import kernels

    spec = load_spec(workload)
    cell = Cell(spec, seed, seconds, trace, device, sizes)
    dev = cell.device
    on_card = dev.type == "cuda"
    if trace:
        trace_mod.warm_profiler(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    window = traffic_mode(cell.traffic["mode"]).drive(cell)
    setup_s = cell.t_window - t_start
    launches = {w.__name__: w.launches for w in kernels.WRAPPERS if w.launches}
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    sliced = window.slice.reduce() if window.slice is not None else None

    metrics = {}
    if not trace:
        values = {**window.end_to_end, "setup_s": setup_s}
        for m in spec["end_to_end"]:
            if m["name"] not in values:
                raise RuntimeError(f"{workload}: the {cell.traffic['mode']!r} driver does not give {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        readings = Readings(cell, window, sliced)
        for m in spec["per_layer"]:
            v = read_metric(m["name"], readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    phases, last = {}, t_start
    for phase, t in cell.marks.items():
        phases[phase] = t - last
        last = t
    phases["warm"] = cell.t_window - last
    say(json.dumps({"workload": workload, "seed": seed, "setup_s": setup_s, "setup_phases_s": phases,
                    "ticks": window.attempted,
                    "host_cpu_ms_per_tick": window.host_cpu_s * 1e3 / max(1, window.host_ticks),
                    "launches_per_tick": {k: v / max(1, window.attempted) for k, v in launches.items()},
                    **window.notes}))
    if sliced is not None:
        say(json.dumps({"trace_slice": {k: v for k, v in sliced.items() if k not in ("device_ops", "idle_gaps")}}))

    window.stage_inputs = []  # the program's state and inputs go before the reference runs
    cell.keep_alive = None
    cell.chain = None
    if on_card:
        torch.cuda.empty_cache()
    correct, numbers = check_mod.check(cell.cfg, window, dev)

    result = {
        "correct": bool(correct),
        "attempted": int(window.attempted),
        "failed": int(window.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace and sliced is not None:
        result["device"]["busy_s"] = sliced["busy_s"]
        result["device"]["window_s"] = sliced["window_s"]
        result["breakdown"] = {"device_ops": sliced["device_ops"], "idle_gaps": sliced["idle_gaps"]}
    result["check"] = numbers
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    import torch

    if not torch.cuda.is_available():
        print("sdrbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    spec = load_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"sdrbench: {args.workload} needs {chips} cards, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    print(json.dumps({"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"sdrbench: the run loaded {bad}; the benchmark may not", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
