#!/usr/bin/env python3
"""Drive the tpusdr_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     main path's shapes, with its time and the plain version's;
  3. the main path: fm_receiver(20 Msps, +2.5 MHz, WBFM), default front end
     (D-FIR kernel, history form) and use_fused=True (D-FIR kernel, prelude
     form), 16 ticks of 1,280,000 samples of a synthetic 1 kHz FM tone: the
     tone must decode (amplitude ~0.34, SNR > 60 dB), the two front ends
     must agree, and the first 2 ticks must match the port's CPU path;
  4. fm_receiver(2 Msps, +100 kHz, NBFM, use_fused=True) through the
     FM-fused kernel, against the CPU path;
  5. a JSON line of the kernels, the card line, and the result line.

Needs a CUDA device and nvcc; builds the kernels into build/tpusdr_torch/.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build"
KERNEL_TOL = 1e-5  # max |kernel - plain| / max |plain|: fp32 both, sum order differs
AUDIO_TOL_DB = -60.0  # chain audio error energy against the reference path
SNR_MIN_DB = 60.0
TONE_AMP = 0.375 * 0.905  # deviation/channel width x de-emphasis gain at 1 kHz
SPIN_CYCLES = 100_000_000  # ~50 ms at 2 GHz: covers enqueueing 20 timed calls


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def err_db(ref: np.ndarray, got: np.ndarray) -> float:
    return float(10 * np.log10(np.sum((ref - got) ** 2) / np.sum(ref**2)))


def tone_fit(x: np.ndarray, fs: float, f: float = 1000.0) -> tuple[float, float]:
    """Amplitude and SNR (dB) of a tone at f, after the first third."""
    x = x[len(x) // 3 :].astype(np.float64)
    t = np.arange(len(x)) / fs
    b = np.stack([np.sin(2 * np.pi * f * t), np.cos(2 * np.pi * f * t)], 1)
    c, *_ = np.linalg.lstsq(b, x, rcond=None)
    fit = b @ c
    r = x - fit - (x - fit).mean()
    return float(np.hypot(*c)), float(10 * np.log10((fit**2).mean() / (r**2).mean()))


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of fn() on CUDA events, after a warm-up.  A spin
    kernel queued first keeps the card busy while the host enqueues the
    timed calls, so the events see device time, not the Python wrapper's
    launch latency."""
    for _ in range(3):
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


def compare(torch, card, name, kernel_fn, plain_fn, counter):
    """Kernel against plain on the same inputs; times in turns
    (plain, kernel, kernel, plain).  Launches made here are not counted
    for the main path (counter is restored)."""
    saved = counter.launches
    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    check(counter.launches == saved + 1, f"{name}: kernel wrapper did not launch")
    diff = (got - ref).abs().max().item()
    peak = ref.abs().max().item()
    p1 = time_ms(torch, plain_fn)
    k1 = time_ms(torch, kernel_fn)
    k2 = time_ms(torch, kernel_fn)
    p2 = time_ms(torch, plain_fn)
    counter.launches = saved
    res = {
        "max_abs_err": diff,
        "rel_err": diff / peak,
        "ms": (k1 + k2) / 2,
        "plain_ms": (p1 + p2) / 2,
    }
    print(f"phase 2 {name} [{card}]: " + json.dumps(res), flush=True)
    check(diff <= KERNEL_TOL * peak, f"{name}: kernel vs plain {diff / peak:.3g} of peak")
    return res


def run_chain(torch, chain, ticks, device):
    """Stream the ticks through the chain; returns the concatenated audio."""
    state = chain.init_state(device=device)
    outs = []
    for x in ticks:
        state, y = chain.apply(state, x)
        outs.append(y)
    return torch.cat(outs).cpu().numpy()


def fm_signal(n: int, fs: float, offset: float, deviation: float, seed: int) -> np.ndarray:
    """One block of the synthetic FM tone at ``offset``, plus a little noise."""
    from tpusdr_torch.io.sources import SyntheticIqSource

    src = SyntheticIqSource.fm(n, fs, deviation=deviation, carrier_offset=offset, num_blocks=1)
    z = next(iter(src))
    rng = np.random.default_rng(seed)
    noise = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (z + noise).astype(np.complex64)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tpusdr_torch import kernels
    from tpusdr_torch.graph.blocks import FusedFmDemod
    from tpusdr_torch.kernels import build, fir_banded, fm_fused
    from tpusdr_torch.models import receiver
    from tpusdr_torch.ops import osc

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    report = {"card": card, "device": torch.cuda.get_device_name(0)}

    # -- phase 1: card and build ---------------------------------------------
    t0 = time.perf_counter()
    build.library()
    report["build_s"] = time.perf_counter() - t0
    print(f"phase 1: card {card!r}, device {report['device']!r}, "
          f"kernels built in {report['build_s']:.1f} s", flush=True)

    # -- phase 2: each kernel against its plain version ------------------------
    rng = np.random.default_rng(1)

    def crandn(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).to(dev)

    wb_chain, _ = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)
    shiftfir = wb_chain.get_block("shiftfir").to(dev)
    T, D = shiftfir.taps.shape[-1], shiftfir.decimation
    check((T, D) == (546, 50), f"WBFM 20 Msps stage is ({T}, {D}), expected (546, 50)")
    ctaps = shiftfir.mod_taps
    N = 1_280_000
    x = crandn(N)
    hist = crandn(T - 1)
    G, _ = fir_banded.prelude_plan(T, D)
    pre = crandn(8, G)
    cmp = {}
    cmp["hist"] = compare(
        torch, card, "D-FIR history form T=546 D=50 N=1280000",
        lambda: fir_banded.banded_fir(x, ctaps, D, history=hist),
        lambda: fir_banded.decim_fir_plain(hist, x, ctaps, D, 0, (T - 1 + N - (T - 1)) // D),
        fir_banded.banded_fir,
    )
    s0 = 8 * G - (T - 1)
    cmp["prelude"] = compare(
        torch, card, "D-FIR prelude form T=546 D=50 N=1280000",
        lambda: fir_banded.banded_fir_prelude(x, pre, ctaps, D),
        lambda: fir_banded.decim_fir_plain(pre.reshape(-1), x, ctaps, D, s0, N // D),
        fir_banded.banded_fir_prelude,
    )
    T3, D3 = 2500, 8
    G3, B3 = fir_banded.prelude_plan(T3, D3)
    check(B3 == 3, "multi-part case must have B=3")
    h3 = np.sinc(0.01 * (np.arange(T3) - (T3 - 1) / 2)) * np.hamming(T3) * 0.01
    t3 = torch.from_numpy(
        (h3 * np.exp(-2j * np.pi * 0.11 * np.arange(T3))).astype(np.complex64)
    ).to(dev)
    x3, pre3 = crandn(48 * G3), crandn(8, G3)
    compare(
        torch, card, "D-FIR prelude form B=3 T=2500 D=8 N=49152",
        lambda: fir_banded.banded_fir_prelude(x3, pre3, t3, D3),
        lambda: fir_banded.decim_fir_plain(pre3.reshape(-1), x3, t3, D3, 8 * G3 - (T3 - 1), x3.shape[0] // D3),
        fir_banded.banded_fir_prelude,
    )
    nb_chain, nb_spec = receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)
    front = nb_chain.get_block("frontend")
    check(isinstance(front, FusedFmDemod) and not front._rows_capable,
          "NBFM 2 Msps fused front end must take the FM-fused branch")
    ftaps = front.taps.to(dev)
    Tf, Df = ftaps.shape[-1], front.decimation
    check((Tf, Df) == (728, 66), f"NBFM stage is ({Tf}, {Df}), expected (728, 66)")
    nb_tick = nb_chain.granule * 160
    z_nb = fm_signal(nb_tick + (Tf - 1) + Df, 2e6, 100e3, 5e3, seed=2)
    ext = torch.from_numpy(z_nb).to(dev)
    ph0 = osc.init_phase(0.3)
    Mf = (ext.shape[0] - (Tf - 1)) // Df - 1
    cmp["fm"] = compare(
        torch, card, f"FM-fused T=728 D=66 M={Mf}",
        lambda: fm_fused.fused_fm_demod(ext, ftaps, Df, front.inc, ph0, front.gain),
        lambda: fm_fused.fused_fm_demod_plain(ext, ftaps, Df, front.inc, ph0, front.gain, Mf),
        fm_fused.fused_fm_demod,
    )
    del x, hist, pre, x3, pre3, ext

    # -- phase 3: the main path, WBFM 20 Msps ---------------------------------
    n_ticks = 16
    z = fm_signal(n_ticks * N, 20e6, 2.5e6, 75e3, seed=3)
    ticks_cpu = torch.from_numpy(z).reshape(n_ticks, N)
    ticks = ticks_cpu.to(dev)
    kernels.reset_launch_counts()
    audio = {}
    main_runs = {}
    for label, kw, wrapper in (
        ("default", {}, fir_banded.banded_fir),
        ("fused", {"use_fused": True}, fir_banded.banded_fir_prelude),
    ):
        chain, spec = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM, **kw)
        chain.to(dev)
        before = wrapper.launches
        audio[label] = run_chain(torch, chain, ticks, dev)
        torch.cuda.synchronize()
        check(wrapper.launches - before == n_ticks,
              f"WBFM {label}: {wrapper.__name__} launched {wrapper.launches - before} times, "
              f"expected {n_ticks}")
        amp, snr = tone_fit(audio[label], spec.audio_rate)
        # timed pass: the same 16 ticks again from a fresh state
        state = chain.init_state(device=dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        start.record()
        for i in range(n_ticks):
            state, _ = chain.apply(state, ticks[i])
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t_host
        ms = start.elapsed_time(end)
        cpu_chain, _ = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM, **kw)
        ref = run_chain(torch, cpu_chain, ticks_cpu[:2], "cpu")
        e_cpu = err_db(ref, audio[label][: len(ref)])
        main_runs[label] = {
            "amp": amp, "snr_db": snr, "gpu_vs_cpu_db": e_cpu,
            "msps": n_ticks * N / (ms * 1e3), "ms_per_tick": ms / n_ticks,
            "host_msps": n_ticks * N / host_s / 1e6,
        }
        print(f"phase 3 WBFM 20 Msps {label} [{card}]: " + json.dumps(main_runs[label]), flush=True)
        check(abs(amp - TONE_AMP) < 0.02, f"WBFM {label}: tone amplitude {amp:.4f}")
        check(snr > SNR_MIN_DB, f"WBFM {label}: tone SNR {snr:.1f} dB")
        check(e_cpu <= AUDIO_TOL_DB, f"WBFM {label}: GPU vs CPU {e_cpu:.1f} dB")
    e_ff = err_db(audio["default"], audio["fused"])
    print(f"phase 3 fused vs default audio: {e_ff:.1f} dB", flush=True)
    check(e_ff <= AUDIO_TOL_DB, f"fused vs default {e_ff:.1f} dB")
    del ticks

    # -- phase 4: NBFM 2 Msps through the FM-fused kernel ----------------------
    nb_ticks = 4
    z_nb = fm_signal(nb_ticks * nb_tick, 2e6, 100e3, 5e3, seed=4)
    nb_cpu = torch.from_numpy(z_nb).reshape(nb_ticks, nb_tick)
    nb_chain.to(dev)
    before = fm_fused.fused_fm_demod.launches
    t_host = time.perf_counter()
    nb_audio = run_chain(torch, nb_chain, nb_cpu.to(dev), dev)
    host_s = time.perf_counter() - t_host
    launched = fm_fused.fused_fm_demod.launches - before
    counts = {w.__name__: w.launches for w in kernels.WRAPPERS}
    check(launched == nb_ticks, f"NBFM: fused_fm_demod launched {launched} times")
    nb_ref_chain, _ = receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)
    nb_ref = run_chain(torch, nb_ref_chain, nb_cpu, "cpu")
    e_nb = err_db(nb_ref, nb_audio)
    main_runs["nbfm"] = {"gpu_vs_cpu_db": e_nb, "tick": nb_tick,
                         "host_msps": nb_ticks * nb_tick / host_s / 1e6}
    print(f"phase 4 NBFM 2 Msps fused [{card}]: " + json.dumps(main_runs["nbfm"]), flush=True)
    check(e_nb <= AUDIO_TOL_DB, f"NBFM: GPU vs CPU {e_nb:.1f} dB")
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched by the main path")

    # -- phase 5: report --------------------------------------------------------
    src = "tpusdr_torch/kernels/csrc/"
    kern = [
        {"name": "decim_fir (history form)", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
         "launches": counts["banded_fir"], **_nums(cmp["hist"])},
        {"name": "decim_fir (prelude form)", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:604",
         "launches": counts["banded_fir_prelude"], **_nums(cmp["prelude"])},
        {"name": "fm_fused", "route": "cuda", "source": src + "fm_fused.cu",
         "replaces": "tpusdr/kernels/fm_pallas.py:205",
         "launches": counts["fused_fm_demod"], **_nums(cmp["fm"])},
    ]
    report.update(kernels=kern, compare=cmp, main=main_runs)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_last.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kern}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _nums(res: dict) -> dict:
    return {k: res[k] for k in ("max_abs_err", "ms", "plain_ms")}


if __name__ == "__main__":
    sys.exit(main())
