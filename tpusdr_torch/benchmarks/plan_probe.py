"""Time hand-picked plans of the three FIR kernels that have a shape rule.

D-FIR (``kernels.fir_banded``, csrc/decim_fir.cu), FM-fused
(``kernels.fm_fused``, csrc/fm_fused.cu) and K4 (``kernels.fir_poly``,
csrc/fir_poly.cu) each cut a launch by a plan: the inner loop (``taps``:
lanes across taps; ``phase``: phase-major; K4 also ``outputs``: lanes
across outputs), the tile (outputs a block,
filtered samples a block for FM-fused) and the tap chunk.
``decim_fir_plan``, ``fm_fused_plan`` and ``fir_decim_plan`` pick one from
(T, D, M).  This probe launches any plan the kernels are built for through
the C entry points, so that the rules' thresholds can be read again on the
card:

    python -m tpusdr_torch.benchmarks.plan_probe --kernel fm_fused \\
        --T 728 --D 66 --M 20000 --form phase taps --tile 224 160 64 32

prints one JSON line for each (form, tile) pair the kernel has: device
microseconds a launch (``utils.profiling.device_ms``: CUDA events behind a
spin kernel), blocks, shared memory a block, blocks an SM, the error
against the plain version, whether it is the plan the rule picks, and the
card's name and power limit.  A pair the kernel is not built for, or whose
block does not fit shared memory, prints a line with ``skipped``.

  * ``--M`` outputs, or ``--tick`` input samples (M = tick // D).  The
    launch is the streaming one: a history of T-1 samples (D-FIR, K4) or
    (T-1) + D (FM-fused) through the second pointer, then the tick.
  * ``--complex-taps`` for D-FIR (FM-fused and K4 have real taps only).
  * ``--chunk`` taps a pass for the lanes-across-taps form (default: all
    T; where they do not fit beside the window, the line says so).
  * ``--input fixed`` launches on one tick again and again, so it is read
    from the L2 cache; ``--input rotate`` goes through enough ticks (8 or
    more) to pass the cache, so every launch reads device memory.
  * FM-fused only: ``--part fill`` and ``--part fill+mix`` cut the launch
    after the window fill or after the mix (the kernel's probe-only entry
    point; no receiver path reaches it), so the parts can be timed apart.

``--device cpu`` is refused: a plan means nothing without the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tpusdr_torch.kernels import fir_banded, fir_poly, fm_fused
from tpusdr_torch.kernels.dispatch import check_launch
from tpusdr_torch.ops import osc
from tpusdr_torch.utils.numerics import cdiv
from tpusdr_torch.utils.profiling import card_line, device_ms

KERNELS = ("decim_fir", "fm_fused", "fir_decim")
PHASE_TILES = {"decim_fir": (fir_banded.PHASE_TILE,), "fm_fused": fm_fused.PROBE_PHASE_TILES,
               "fir_decim": fir_poly.PHASE_TILES}
# tiles of the forms with a contiguous window, by kernel and form
WINDOW_TILES = {("fir_decim", "taps"): fir_poly.TAP_TILES, ("fir_decim", "outputs"): fir_poly.OUTPUT_TILES}
PLANS = {"decim_fir": fir_banded.DecimFirPlan, "fm_fused": fm_fused.FmFusedPlan, "fir_decim": fir_poly.FirDecimPlan}
PARTS = ("all", "fill", "fill+mix")  # by their index on the C side
L2_BYTES = 50 << 20  # an H100's L2 cache
FS, F_OFF, GAIN = 2e6, 100e3, 0.32  # the probe's signal (a tone at +F_OFF) and FM gain
VALUE_TOL = 1e-5  # kernel against plain: of peak (D-FIR), times the gain (FM-fused)


def rule_plan(kernel: str, T: int, D: int, M: int, complex_taps: bool):
    """The plan the kernel's own rule picks."""
    if kernel == "fm_fused":
        return fm_fused.fm_fused_plan(T, D, M)
    if kernel == "fir_decim":
        return fir_poly.fir_decim_plan(T, D, M)
    return fir_banded.decim_fir_plan(T, D, complex_taps, M)


def make_plan(kernel: str, T: int, D: int, complex_taps: bool, form: str, tile: int, chunk: int | None):
    """The plan (form, tile, chunk) of ``kernel``, or a string that says why
    there is none.  ``chunk`` None: all T taps in one pass."""
    cls = PLANS[kernel]
    if form == "phase":
        if tile not in PHASE_TILES[kernel]:
            return f"the phase-major form is built for tiles {PHASE_TILES[kernel]}"
        if D < 2:
            return "the phase-major form needs D >= 2"
        plan = cls("phase", tile, T)
    elif form == "taps" or (kernel, form) in WINDOW_TILES:
        tiles = WINDOW_TILES.get((kernel, form), fir_banded.TILES)
        if tile not in tiles:
            return f"the {form} form is built for tiles {tiles}"
        plan = cls(form, tile, T if chunk is None else chunk)
    else:
        return f"{kernel} has no {form} form"
    if not 1 <= plan.chunk <= T:
        return f"chunk {plan.chunk} is not within 1..{T}"
    smem = plan_smem(kernel, T, D, complex_taps, plan)
    if smem > fir_banded.SMEM_LIMIT:
        return f"a block needs {smem} B of shared memory, over {fir_banded.SMEM_LIMIT}: fewer taps a pass (--chunk)?"
    return plan


def plan_smem(kernel: str, T: int, D: int, complex_taps: bool, plan) -> int:
    if kernel == "fm_fused":
        return fm_fused.fm_fused_smem(T, D, plan)
    if kernel == "fir_decim":
        return fir_poly.fir_decim_smem(T, D, plan)
    return fir_banded.decim_fir_smem(T, D, complex_taps, plan)


def describe(kernel: str, T: int, D: int, M: int, complex_taps: bool, plan) -> dict:
    """What a plan means for the card, from shapes alone."""
    smem = plan_smem(kernel, T, D, complex_taps, plan)
    blocks = fm_fused.fm_fused_blocks(M, plan) if kernel == "fm_fused" else cdiv(M, plan.tile)
    return {
        "form": plan.form, "tile": plan.tile, "chunk": plan.chunk, "blocks": blocks, "smem": smem,
        "blocks_per_sm": fir_banded.blocks_per_sm(smem),
        "is_rule_plan": tuple(plan) == tuple(rule_plan(kernel, T, D, M, complex_taps)),
    }


def probe_inputs(kernel: str, T: int, D: int, n: int, complex_taps: bool, seed: int = 0):
    """(signal of n samples, T taps) as numpy arrays.  The signal is a 1 kHz
    FM tone of modulation index 1 with a little noise; the taps are a
    windowed-sinc low-pass of cutoff 0.4 / D.  The tone sits where the
    kernel's passband is, so that the output is of order 1 and the value
    check means something: at +F_OFF for FM-fused (its NCO mixes it down)
    and for D-FIR with complex taps (the taps are shifted up to it), at 0
    for D-FIR with real taps."""
    offset = F_OFF if kernel == "fm_fused" or complex_taps else 0.0
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    ph = 2 * np.pi * offset * t + np.sin(2 * np.pi * 1e3 * t)
    noise = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    signal = (0.9 * np.exp(1j * ph) + 0.01 * noise).astype(np.complex64)
    k = np.arange(T) - (T - 1) / 2
    cutoff = 0.4 / D
    taps = (2 * cutoff * np.sinc(2 * cutoff * k) * np.hamming(T)).astype(np.float32)
    if complex_taps:
        taps = (taps * np.exp(2j * np.pi * F_OFF / FS * np.arange(T))).astype(np.complex64)
    return signal, taps


def probe(kernel: str, T: int, D: int, M: int, complex_taps: bool, pairs, chunk: int | None = None,
          input_mode: str = "fixed", part: str = "all", reps: int = 20, seed: int = 0,
          device="cuda", emit=None) -> list[dict]:
    """Time each (form, tile) of ``pairs``; returns (and emits) the lines."""
    from tpusdr_torch.kernels.build import library

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("plan_probe needs a CUDA device: a plan means nothing without the card")
    if kernel != "decim_fir" and complex_taps:
        raise ValueError(f"{kernel} takes real taps")
    if kernel != "fm_fused" and part != "all":
        raise ValueError("--part is FM-fused's")
    lib = library()
    card = card_line()
    H = (T - 1) + (D if kernel == "fm_fused" else 0)
    tick = M * D  # [history, tick] is (T-1) + M*D samples, and D more for FM-fused's M + 1 filtered samples
    n_unique = 1 if input_mode == "fixed" else max(8, cdiv(3 * L2_BYTES // 2, tick * 8))
    signal, taps = probe_inputs(kernel, T, D, H + tick, complex_taps, seed)
    first = torch.from_numpy(signal).to(device)
    xs = first[H:].repeat(n_unique, 1)
    hists = [first[:H]] + [xs[k - 1][tick - H:] if tick >= H else first[:H] for k in range(1, n_unique)]
    taps = torch.from_numpy(taps).to(device)
    inc, ph0 = osc.freq_to_inc_u32(-F_OFF, FS), osc.init_phase(0.3)
    if kernel == "fm_fused":
        out = torch.empty(M, dtype=torch.float32, device=device)
        ref = fm_fused.fused_fm_demod_plain(xs[0], taps, D, inc, ph0, GAIN, M, history=hists[0])
        tol = VALUE_TOL * GAIN
    elif kernel == "fir_decim":
        out = torch.empty(M, dtype=torch.complex64, device=device)
        ref = fir_poly.fir_decim_plain(xs[0], taps, D, M, hists[0])
        tol = VALUE_TOL * ref.abs().max().item()
    else:
        out = torch.empty(M, dtype=torch.complex64, device=device)
        ref = fir_banded.decim_fir_plain(hists[0], xs[0], taps, D, 0, M)
        tol = VALUE_TOL * ref.abs().max().item()
    rule = rule_plan(kernel, T, D, M, complex_taps)
    lines = []
    for form, tile in pairs:
        line = {"kernel": kernel, "T": T, "D": D, "M": M, "tick": tick, "complex_taps": complex_taps,
                "input": input_mode, "n_unique": n_unique, "part": part, "reps": reps,
                "rule_plan": list(rule), "card": card}
        plan = make_plan(kernel, T, D, complex_taps, form, tile, chunk)
        if isinstance(plan, str):
            line.update(form=form, tile=tile, skipped=plan)
        else:
            line.update(describe(kernel, T, D, M, complex_taps, plan))
            turn = [0]

            def launch(plan=plan):
                k = turn[0] = (turn[0] + 1) % n_unique
                if kernel == "fm_fused":
                    head, tail = fm_fused.launch_args(lib, hists[k], xs[k], taps, D, inc, ph0, GAIN, M, plan, out)
                    if part == "all":
                        err = lib.tpusdr_fm_fused(*head, *tail)
                    else:
                        err = lib.tpusdr_fm_fused_probe(*head, PARTS.index(part), *tail)
                elif kernel == "fir_decim":
                    head, tail = fir_poly.launch_args(lib, hists[k], xs[k], taps, D, M, plan, out)
                    err = lib.tpusdr_fir_poly(*head, *tail)
                else:
                    err = lib.tpusdr_decim_fir(
                        hists[k].data_ptr(), H, xs[k].data_ptr(), tick, taps.data_ptr(), T, int(complex_taps),
                        D, 0, M, fir_banded.FORMS.index(plan.form), plan.tile, plan.chunk,
                        out.data_ptr(), device.index or 0, torch.cuda.current_stream(device).cuda_stream)
                check_launch(err, f"plan_probe {kernel} {tuple(plan)}")

            out.zero_()
            turn[0] = -1  # the checked launch takes tick 0
            launch()
            torch.cuda.synchronize()
            if part == "all":
                line["max_abs_err"] = (out - ref).abs().max().item()
                line["ok"] = bool(line["max_abs_err"] <= tol)
            line["us"] = device_ms(launch, reps) * 1e3
        lines.append(line)
        if emit is not None:
            emit(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="time hand-picked plans of the D-FIR, FM-fused and K4 kernels")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cuda:1'; 'cpu' is refused")
    ap.add_argument("--kernel", required=True, choices=KERNELS)
    ap.add_argument("--T", type=int, required=True, help="taps")
    ap.add_argument("--D", type=int, required=True, help="decimation")
    size = ap.add_mutually_exclusive_group(required=True)
    size.add_argument("--M", type=int, help="outputs of the launch")
    size.add_argument("--tick", type=int, help="input samples of the tick (M = tick // D)")
    ap.add_argument("--complex-taps", action="store_true", help="D-FIR with complex taps")
    ap.add_argument("--form", nargs="+", default=["rule"], choices=("rule",) + fir_poly.FORMS,
                    help="inner loops to time; 'rule' (default) times the rule's own plan")
    ap.add_argument("--tile", type=int, nargs="+", default=[],
                    help="tiles to time with each form (taps: 64 32 16 8, for fir_decim any multiple of 8 "
                         "up to 64; phase: 224, and 160 for fm_fused and fir_decim; fir_decim's outputs: "
                         "256 128 64 32)")
    ap.add_argument("--chunk", type=int, default=None, help="taps a pass (default: all that fit)")
    ap.add_argument("--input", default="fixed", choices=("fixed", "rotate"))
    ap.add_argument("--part", default="all", choices=PARTS, help="FM-fused: cut the launch after a part")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda":
        ap.error("a plan means nothing without the card: there is no CPU mode")
    if not torch.cuda.is_available():
        ap.error("no CUDA device")
    M = args.M if args.M is not None else args.tick // args.D
    if M < 1:
        ap.error("the launch has no output")
    rule = rule_plan(args.kernel, args.T, args.D, M, args.complex_taps)
    pairs = []
    for form in args.form:
        if form == "rule":
            pairs.append((rule.form, rule.tile))
        else:
            pairs.extend((form, tile) for tile in args.tile)
    if not pairs:
        ap.error("--form taps / phase needs --tile")
    try:
        lines = probe(args.kernel, args.T, args.D, M, args.complex_taps, pairs, args.chunk, args.input,
                      args.part, args.reps, args.seed, device,
                      emit=lambda line: print(json.dumps(line), flush=True))
    except ValueError as e:
        ap.error(str(e))
    return 0 if all(line.get("ok", True) for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
