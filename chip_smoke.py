#!/usr/bin/env python3
"""Drive the tpusdr_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints lines; any failure exits non-zero):
  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     main paths' shapes, with its time and the plain version's: D-FIR at
     the WBFM shape (history and prelude forms) and at the single-stage AM
     shape (6665, /500); FM-fused at NBFM 2 Msps and at the single-stage
     NBFM 20 Msps shape (9660, /666); K4 at the AM shapes (868, /250) on a
     20 Msps tick, (46, /2) and (6665, /500);
  3. the WBFM path: fm_receiver(20 Msps, +2.5 MHz, WBFM), default front end
     (D-FIR kernel, history form) and use_fused=True (D-FIR kernel, prelude
     form), 16 ticks of 1,280,000 samples of a synthetic 1 kHz FM tone: the
     tone must decode (amplitude ~0.34, SNR > 60 dB), the two front ends
     must agree, and the first 2 ticks must match the port's CPU path;
  4. fm_receiver(2 Msps, +100 kHz, NBFM, use_fused=True) through the
     FM-fused kernel, against the CPU path;
  5. the AM path from a HackRF-style int8 capture: 16 ticks of 1,280,000
     packed int8 words of the CLI's 700 Hz AM signal at +1.2 MHz, written
     to build/, then (a) the receive CLI on the card (default front end:
     D-FIR for shiftfir1 and rf_fir2) and (b) a StreamRunner over
     am_receiver(fir_mode='pallas', fold_shift=False) from a FileIqSource
     (K4 for both RF stages).  Both must decode the tone (amplitude 0.25,
     SNR > 60 dB), match the CPU path on the first 2 ticks and each other;
  6. a JSON line of the kernels, the card line, and the result line.

Each path runs with the launch counts set to 0 just before it and read
just after; every kernel the path goes through must have launched.
Needs a CUDA device and nvcc; builds the kernels into build/tpusdr_torch/.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
import wave
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build"
KERNEL_TOL = 1e-5  # max |kernel - plain| / max |plain|: fp32 both, sum order differs
AUDIO_TOL_DB = -60.0  # chain audio error energy against the reference path
SNR_MIN_DB = 60.0
TONE_AMP = 0.375 * 0.905  # deviation/channel width x de-emphasis gain at 1 kHz
AM_TONE_AMP = 0.25  # carrier 0.5 x depth 0.5, the DC block removes the carrier
SPIN_CYCLES = 100_000_000  # ~50 ms at 2 GHz: covers enqueueing 20 timed calls
TICK = 1_280_000
N_TICKS = 16


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


def read_wav(path: Path) -> tuple[np.ndarray, int]:
    with wave.open(str(path)) as w:
        fs = w.getframerate()
        x = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.float32) / 32767
    return x, fs


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
    for the main paths (counter is restored)."""
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


def path_counts(torch) -> dict:
    """Launch counts of every kernel wrapper since the last reset."""
    from tpusdr_torch import kernels

    torch.cuda.synchronize()
    return {w.__name__: w.launches for w in kernels.WRAPPERS}


def check_path(counts: dict, label: str, expected: dict) -> None:
    """Every kernel of the path launched, exactly as often as expected."""
    for name, n in expected.items():
        check(counts[name] == n, f"{label}: {name} launched {counts[name]} times, expected {n}")


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


def lowpass(T: int, cutoff: float) -> np.ndarray:
    """A windowed-sinc low-pass of T taps (cutoff in cycles per sample)."""
    n = np.arange(T) - (T - 1) / 2
    return (2 * cutoff * np.sinc(2 * cutoff * n) * np.hamming(T)).astype(np.float32)


def kernel_phase(torch, card, dev, am_chain) -> dict:
    """Phase 2: every kernel against its plain version."""
    from tpusdr_torch.graph.blocks import FusedFmDemod
    from tpusdr_torch.kernels import fir_banded, fir_poly, fm_fused
    from tpusdr_torch.models import receiver
    from tpusdr_torch.ops import osc

    rng = np.random.default_rng(1)

    def crandn(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).to(dev)

    cmp = {}
    wb_chain, _ = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)
    shiftfir = wb_chain.get_block("shiftfir").to(dev)
    T, D = shiftfir.taps.shape[-1], shiftfir.decimation
    check((T, D) == (546, 50), f"WBFM 20 Msps stage is ({T}, {D}), expected (546, 50)")
    check(fir_banded.decim_fir_plan(T, D, True) == (64, T), "the WBFM shape must keep its 64-output tile")
    ctaps = shiftfir.mod_taps
    x = crandn(TICK)
    hist = crandn(T - 1)
    G, _ = fir_banded.prelude_plan(T, D)
    pre = crandn(8, G)
    cmp["hist"] = compare(
        torch, card, "D-FIR history form T=546 D=50 N=1280000",
        lambda: fir_banded.banded_fir(x, ctaps, D, history=hist),
        lambda: fir_banded.decim_fir_plain(hist, x, ctaps, D, 0, TICK // D),
        fir_banded.banded_fir,
    )
    s0 = 8 * G - (T - 1)
    cmp["prelude"] = compare(
        torch, card, "D-FIR prelude form T=546 D=50 N=1280000",
        lambda: fir_banded.banded_fir_prelude(x, pre, ctaps, D),
        lambda: fir_banded.decim_fir_plain(pre.reshape(-1), x, ctaps, D, s0, TICK // D),
        fir_banded.banded_fir_prelude,
    )
    T3, D3 = 2500, 8
    G3, B3 = fir_banded.prelude_plan(T3, D3)
    check(B3 == 3, "multi-part case must have B=3")
    h3 = np.sinc(0.01 * (np.arange(T3) - (T3 - 1) / 2)) * np.hamming(T3) * 0.01
    t3 = torch.from_numpy((h3 * np.exp(-2j * np.pi * 0.11 * np.arange(T3))).astype(np.complex64)).to(dev)
    x3, pre3 = crandn(48 * G3), crandn(8, G3)
    compare(
        torch, card, "D-FIR prelude form B=3 T=2500 D=8 N=49152",
        lambda: fir_banded.banded_fir_prelude(x3, pre3, t3, D3),
        lambda: fir_banded.decim_fir_plain(pre3.reshape(-1), x3, t3, D3, 8 * G3 - (T3 - 1), x3.shape[0] // D3),
        fir_banded.banded_fir_prelude,
    )
    # F1: the single-stage AM shape at 20 Msps (tile 32 of 64)
    Ta, Da = 6665, 500
    ta = torch.from_numpy((lowpass(Ta, 0.0005) * np.exp(-2j * np.pi * 0.06 * np.arange(Ta))).astype(np.complex64)).to(dev)
    hist_a = crandn(Ta - 1)
    cmp["hist_f1"] = compare(
        torch, card, f"D-FIR history form T=6665 D=500 N=1280000 tile={fir_banded.decim_fir_plan(Ta, Da, True)}",
        lambda: fir_banded.banded_fir(x, ta, Da, history=hist_a),
        lambda: fir_banded.decim_fir_plain(hist_a, x, ta, Da, 0, TICK // Da),
        fir_banded.banded_fir,
    )

    nb_chain, _ = receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)
    front = nb_chain.get_block("frontend")
    check(isinstance(front, FusedFmDemod) and not front._rows_capable,
          "NBFM 2 Msps fused front end must take the FM-fused branch")
    ftaps = front.taps.to(dev)
    Tf, Df = ftaps.shape[-1], front.decimation
    check((Tf, Df) == (728, 66), f"NBFM stage is ({Tf}, {Df}), expected (728, 66)")
    nb_tick = nb_chain.granule * 160
    ext = torch.from_numpy(fm_signal(nb_tick + (Tf - 1) + Df, 2e6, 100e3, 5e3, seed=2)).to(dev)
    ph0 = osc.init_phase(0.3)
    Mf = (ext.shape[0] - (Tf - 1)) // Df - 1
    cmp["fm"] = compare(
        torch, card, f"FM-fused T=728 D=66 M={Mf}",
        lambda: fm_fused.fused_fm_demod(ext, ftaps, Df, front.inc, ph0, front.gain),
        lambda: fm_fused.fused_fm_demod_plain(ext, ftaps, Df, front.inc, ph0, front.gain, Mf),
        fm_fused.fused_fm_demod,
    )
    # F1: the single-stage NBFM 20 Msps shape (16 filtered samples a block)
    Tn, Dn, Mn = 9660, 666, 625  # 625 outputs: one 416,250-sample tick
    tn = torch.from_numpy(lowpass(Tn, 0.0004)).to(dev)
    ext_n = torch.from_numpy(fm_signal((Tn - 1) + (Mn + 1) * Dn, 20e6, 1e6, 5e3, seed=5)).to(dev)
    inc_n = osc.freq_to_inc_u32(-1e6, 20e6)
    cmp["fm_f1"] = compare(
        torch, card, f"FM-fused T=9660 D=666 M={Mn} plan={fm_fused.fm_fused_plan(Tn, Dn)}",
        lambda: fm_fused.fused_fm_demod(ext_n, tn, Dn, inc_n, ph0, 0.5),
        lambda: fm_fused.fused_fm_demod_plain(ext_n, tn, Dn, inc_n, ph0, 0.5, Mn),
        fm_fused.fused_fm_demod,
    )

    # K4 at the AM path's shapes, with the path's own taps
    for name, L in (("rf_fir1", TICK), ("rf_fir2", TICK // 250)):
        blk = am_chain.get_block(name)
        Tk, Dk = blk.taps.shape[-1], blk.decimation
        tk = blk.taps.to(dev)
        xk = crandn((Tk - 1) + L)
        cmp[f"k4_{Dk}"] = compare(
            torch, card, f"K4 fir_decim T={Tk} D={Dk} N={L}",
            lambda xk=xk, tk=tk, Dk=Dk: fir_poly.fir_decim(xk, tk, Dk),
            lambda xk=xk, tk=tk, Dk=Dk, Mk=L // Dk: fir_poly.fir_decim_plain(xk, tk, Dk, Mk),
            fir_poly.fir_decim,
        )
    tl = torch.from_numpy(lowpass(Ta, 0.0005)).to(dev)
    xl = crandn((Ta - 1) + TICK)
    cmp["k4_500"] = compare(
        torch, card, f"K4 fir_decim T={Ta} D={Da} N={TICK}",
        lambda: fir_poly.fir_decim(xl, tl, Da),
        lambda: fir_poly.fir_decim_plain(xl, tl, Da, TICK // Da),
        fir_poly.fir_decim,
    )
    return cmp


def wbfm_phase(torch, card, dev, kernels_used: dict) -> dict:
    """Phase 3: the WBFM path on both front ends."""
    from tpusdr_torch import kernels
    from tpusdr_torch.models import receiver

    z = fm_signal(N_TICKS * TICK, 20e6, 2.5e6, 75e3, seed=3)
    ticks_cpu = torch.from_numpy(z).reshape(N_TICKS, TICK)
    ticks = ticks_cpu.to(dev)
    audio, runs = {}, {}
    for label, kw, wrapper in (
        ("default", {}, "banded_fir"),
        ("fused", {"use_fused": True}, "banded_fir_prelude"),
    ):
        chain, spec = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM, **kw)
        cpu_chain = copy.deepcopy(chain)
        chain.to(dev)
        kernels.reset_launch_counts()
        audio[label] = run_chain(torch, chain, ticks, dev)
        counts = path_counts(torch)
        check_path(counts, f"WBFM {label}", {wrapper: N_TICKS})
        kernels_used[wrapper] = counts[wrapper]
        amp, snr = tone_fit(audio[label], spec.audio_rate)
        # timed pass: the same 16 ticks again from a fresh state
        state = chain.init_state(device=dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        start.record()
        for i in range(N_TICKS):
            state, _ = chain.apply(state, ticks[i])
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t_host
        ms = start.elapsed_time(end)
        ref = run_chain(torch, cpu_chain, ticks_cpu[:2], "cpu")
        e_cpu = err_db(ref, audio[label][: len(ref)])
        runs[label] = {
            "amp": amp, "snr_db": snr, "gpu_vs_cpu_db": e_cpu,
            "msps": N_TICKS * TICK / (ms * 1e3), "ms_per_tick": ms / N_TICKS,
            "host_msps": N_TICKS * TICK / host_s / 1e6, "launches": counts,
        }
        print(f"phase 3 WBFM 20 Msps {label} [{card}]: " + json.dumps(runs[label]), flush=True)
        check(abs(amp - TONE_AMP) < 0.02, f"WBFM {label}: tone amplitude {amp:.4f}")
        check(snr > SNR_MIN_DB, f"WBFM {label}: tone SNR {snr:.1f} dB")
        check(e_cpu <= AUDIO_TOL_DB, f"WBFM {label}: GPU vs CPU {e_cpu:.1f} dB")
    e_ff = err_db(audio["default"], audio["fused"])
    print(f"phase 3 fused vs default audio: {e_ff:.1f} dB", flush=True)
    check(e_ff <= AUDIO_TOL_DB, f"fused vs default {e_ff:.1f} dB")
    return runs


def nbfm_phase(torch, card, dev, kernels_used: dict) -> dict:
    """Phase 4: NBFM 2 Msps through the FM-fused kernel."""
    from tpusdr_torch import kernels
    from tpusdr_torch.models import receiver

    nb_chain, _ = receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)
    nb_ref_chain = copy.deepcopy(nb_chain)
    nb_tick, nb_ticks = nb_chain.granule * 160, 4
    nb_cpu = torch.from_numpy(fm_signal(nb_ticks * nb_tick, 2e6, 100e3, 5e3, seed=4)).reshape(nb_ticks, nb_tick)
    nb_chain.to(dev)
    nb_gpu = nb_cpu.to(dev)
    kernels.reset_launch_counts()
    t_host = time.perf_counter()
    nb_audio = run_chain(torch, nb_chain, nb_gpu, dev)
    host_s = time.perf_counter() - t_host
    counts = path_counts(torch)
    check_path(counts, "NBFM", {"fused_fm_demod": nb_ticks})
    kernels_used["fused_fm_demod"] = counts["fused_fm_demod"]
    e_nb = err_db(run_chain(torch, nb_ref_chain, nb_cpu, "cpu"), nb_audio)
    run = {"gpu_vs_cpu_db": e_nb, "tick": nb_tick, "host_msps": nb_ticks * nb_tick / host_s / 1e6,
           "launches": counts}
    print(f"phase 4 NBFM 2 Msps fused [{card}]: " + json.dumps(run), flush=True)
    check(e_nb <= AUDIO_TOL_DB, f"NBFM: GPU vs CPU {e_nb:.1f} dB")
    return run


def am_phase(torch, card, dev, pallas_chain, kernels_used: dict) -> dict:
    """Phase 5: AM at 20 Msps from an int8 capture, through the CLI (D-FIR)
    and through a StreamRunner over the K4 chain."""
    from tpusdr_torch import kernels
    from tpusdr_torch.apps import receive
    from tpusdr_torch.graph.runner import StreamRunner
    from tpusdr_torch.io.sinks import CollectSink
    from tpusdr_torch.io.sources import FileIqSource, SyntheticIqSource
    from tpusdr_torch.models import receiver

    fs, offset = 20e6, 1.2e6
    capture = OUT_DIR / "am_20msps_int8.iq"
    words = np.concatenate(list(SyntheticIqSource.am(TICK, fs, offset, "int8", num_blocks=N_TICKS)))
    words.tofile(capture)
    head = [torch.from_numpy(words[i * TICK : (i + 1) * TICK]) for i in range(2)]
    runs = {}

    # (a) the CLI, default front end
    wav = OUT_DIR / "am_20msps_cli.wav"
    kernels.reset_launch_counts()
    rc = receive.main([
        "--device", str(dev), "--mod", "am", "--format", "int8", "--input", str(capture),
        "--rf-rate", "20e6", "--offset", "1.2e6", "--tick", str(TICK),
        "--duration", str((N_TICKS + 0.5) * TICK / fs), "--audio", str(wav),
    ])
    counts = path_counts(torch)
    check(rc == 0, f"receive CLI exited {rc}")
    check_path(counts, "AM CLI", {"banded_fir": 2 * N_TICKS})
    audio_cli, wav_fs = read_wav(wav)
    cpu_default, _ = receiver.am_receiver(fs, offset, input_format="int8")
    ref = run_chain(torch, cpu_default, head, "cpu")
    amp, snr = tone_fit(audio_cli, wav_fs, 700.0)
    runs["cli"] = {"amp": amp, "snr_db": snr, "gpu_vs_cpu_db": err_db(ref, audio_cli[: len(ref)]),
                   "samples": len(audio_cli), "launches": counts}
    print(f"phase 5 AM 20 Msps int8 CLI [{card}]: " + json.dumps(runs["cli"]), flush=True)

    # (b) a StreamRunner over the K4 chain
    cpu_pallas = copy.deepcopy(pallas_chain)
    pallas_chain.to(dev)
    sink = CollectSink()
    runner = StreamRunner(pallas_chain, device=dev)
    kernels.reset_launch_counts()
    _, stats = runner.run(iter(FileIqSource(str(capture), TICK, "int8")), sink)
    counts = path_counts(torch)
    check_path(counts, "AM K4 runner", {"fir_decim": 2 * N_TICKS})
    kernels_used["fir_decim"] = counts["fir_decim"]
    audio_k4 = sink.result()
    ref_k4 = run_chain(torch, cpu_pallas, head, "cpu")
    amp, snr = tone_fit(audio_k4, 48000.0, 700.0)
    runs["k4_runner"] = {
        "amp": amp, "snr_db": snr, "gpu_vs_cpu_db": err_db(ref_k4, audio_k4[: len(ref_k4)]),
        "vs_cli_db": err_db(audio_k4, audio_cli), "samples": len(audio_k4),
        "runstats_msps_in": stats.msps_in, "wall_s": stats.wall_seconds, "launches": counts,
    }
    print(f"phase 5 AM 20 Msps int8 K4 StreamRunner [{card}]: " + json.dumps(runs["k4_runner"]), flush=True)
    for label, r in runs.items():
        check(abs(r["amp"] - AM_TONE_AMP) < 0.02, f"AM {label}: tone amplitude {r['amp']:.4f}")
        check(r["snr_db"] > SNR_MIN_DB, f"AM {label}: tone SNR {r['snr_db']:.1f} dB")
        check(r["gpu_vs_cpu_db"] <= AUDIO_TOL_DB, f"AM {label}: GPU vs CPU {r['gpu_vs_cpu_db']:.1f} dB")
    n_audio = N_TICKS * TICK * pallas_chain.up // pallas_chain.down
    check(len(audio_cli) == len(audio_k4) == n_audio, f"AM: audio lengths {len(audio_cli)}, {len(audio_k4)}")
    check(runs["k4_runner"]["vs_cli_db"] <= AUDIO_TOL_DB, "AM: K4 runner vs CLI audio")
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tpusdr_torch.kernels import build
    from tpusdr_torch.models import receiver

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    report = {"card": card, "device": torch.cuda.get_device_name(0)}
    OUT_DIR.mkdir(exist_ok=True)

    # -- phase 1: card and build ---------------------------------------------
    t0 = time.perf_counter()
    build.library()
    report["build_s"] = time.perf_counter() - t0
    print(f"phase 1: card {card!r}, device {report['device']!r}, "
          f"kernels built in {report['build_s']:.1f} s", flush=True)

    am_pallas, _ = receiver.am_receiver(20e6, 1.2e6, input_format="int8", fir_mode="pallas", fold_shift=False)
    cmp = kernel_phase(torch, card, dev, am_pallas)  # phase 2
    used: dict = {}
    main_runs = {
        "wbfm": wbfm_phase(torch, card, dev, used),  # phase 3
        "nbfm": nbfm_phase(torch, card, dev, used),  # phase 4
        "am": am_phase(torch, card, dev, am_pallas, used),  # phase 5
    }

    # -- phase 6: report --------------------------------------------------------
    src = "tpusdr_torch/kernels/csrc/"
    kern = [
        {"name": "decim_fir (history form)", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
         "launches": used["banded_fir"], **_nums(cmp["hist"])},
        {"name": "decim_fir (prelude form)", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:604",
         "launches": used["banded_fir_prelude"], **_nums(cmp["prelude"])},
        {"name": "fm_fused", "route": "cuda", "source": src + "fm_fused.cu",
         "replaces": "tpusdr/kernels/fm_pallas.py:205",
         "launches": used["fused_fm_demod"], **_nums(cmp["fm"])},
        {"name": "fir_decim", "route": "cuda", "source": src + "fir_poly.cu",
         "replaces": "tpusdr/kernels/fir_pallas.py:119",
         "launches": used["fir_decim"], **_nums(cmp["k4_250"])},
    ]
    report.update(kernels=kern, compare=cmp, main=main_runs)
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
