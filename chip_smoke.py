#!/usr/bin/env python3
"""Drive the tpusdr_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints lines; any failure exits non-zero):
  1. the card (nvidia-smi name and power limit), the kernel build time and
     the host library's (``tpusdr_torch/io/csrc/host_ring.cpp``);
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     main paths' shapes, with its time and the plain version's: D-FIR at
     the WBFM shape (history and prelude forms), at the single-stage AM
     shape (6665, /500), at the AM CLI's two stages (868, /250) and (46, /2)
     and at the digital app's (728, /12); FM-fused at NBFM 2 Msps, in its
     channel form at the ``nbfm.capture`` cell's shape (the 57 marine
     channels on one 1,278,750-sample tick at (728, /66), M = 19,375, with
     random carried phases: one launch, 57 channel rows, the bound from
     ``sdrbench/fm_fused_work.py``) and at the single-stage
     NBFM 20 Msps shape (9660, /666), each with the plan its rule picks; the
     batched resampler ``resample_poly`` at every shape a main path
     launches it (the capture cells' 33/125 over 57 rows of 19,375, 6/25
     over 100 rows of 12,800 and 3/25 over one row of 25,600, the live
     cell's 3/25 over one row of 2,625, NBFM 2 Msps's 198/125 over one row
     of 20,000; one launch and the rows counted, the carry bit for bit, the
     bound from ``sdrbench/resampler_work.py``); K4 at the AM shapes (868, /250) on a
     20 Msps tick, (46, /2) and (6665, /500) and at the JSON graph's
     (546, /50), each through the streaming call (the carried T-1 samples
     through the second pointer) with the plan its rule picks, timed on a
     fixed tick and on ticks that rotate past the L2 cache; the copy floor K5 at ticks of 1,280,000 and 2,048,000
     samples, n_split 1 and the best of 2/5/10, with the plan
     ``copy_floor_plan`` picks (checked: one block on every SM, resident,
     each block's span in flight at once), on ticks that rotate
     past the L2 cache and on one fixed tick, beside a read yardstick
     (``torch.sum`` over the same rotating ticks viewed as float32); the
     staging probes K6-K8 at the probes' shapes on random
     data, each also with the plan its rule picks (``staging_plan`` for K6
     and K7, ``shift_sum_plan`` for K8, which prints the busiest block's
     staged bytes; checked: one block on every SM) from device memory (128
     MiB of inputs in rotation), beside ``add``, ``mul`` and ``conv2d`` on
     the same inputs and the timer's trivial launch.  Each row also gets
     its bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s,
     whichever is longer) and, where one
     PyTorch call computes the same function (``conv1d`` for the FIR
     kernels, a contiguous slice, ``add``, ``mul``, ``conv2d`` with a
     column of ones for K5-K8), that call's time (a yardstick: the port
     never calls it);
  3. the WBFM path: fm_receiver(20 Msps, +2.5 MHz, WBFM), default front end
     (D-FIR kernel, history form) and use_fused=True (D-FIR kernel, prelude
     form), 16 ticks of 1,280,000 samples of a synthetic 1 kHz FM tone: the
     tone must decode (amplitude ~0.34, SNR > 60 dB), the two front ends
     must agree, and the first 2 ticks must match the port's CPU path;
     the RF kernel and ``resample_poly`` once a tick;
  4. fm_receiver(2 Msps, +100 kHz, NBFM, use_fused=True) through the
     FM-fused kernel, against the CPU path, it and ``resample_poly`` once
     a tick; one tick under the profiler must show no concatenation of the
     tick in front of the kernel; then two ticks each of the
     ``nbfm.capture`` chain (57 rows), the ``bank100.capture`` chain (100
     rows) and the WBFM receiver on ``wbfm.live``'s 131,250-sample blocks:
     ``resample_poly`` once a tick over every row;
  5. the AM path from a HackRF-style int8 capture: 16 ticks of 1,280,000
     packed int8 words of the CLI's 700 Hz AM signal at +1.2 MHz, written
     to build/, then (a) the receive CLI on the card (default front end:
     D-FIR for shiftfir1 and rf_fir2) and (b) a StreamRunner over
     am_receiver(fir_mode='pallas', fold_shift=False) from a FileIqSource
     (K4 for both RF stages).  Both must decode the tone (amplitude 0.25,
     SNR > 60 dB), match the CPU path on the first 2 ticks and each other;
     one more tick of the K4 chain under the profiler must concatenate no
     operand as long as a K4 stage's input;
  6. the floor probe (``tpusdr_torch.benchmarks.kernel_floor_probe``)
     in-process at the 1,280,000-sample tick: K5 at four n_split, K2
     streaming and on one fixed tick, K1 in its three history forms;
  7. a reference-schema JSON graph of the WBFM receiver at 20 Msps
     (Synth -> Cosine x Multiply -> Fir 546 taps /50 in mode "pallas" ->
     QuadDemod -> Deemphasis -> Resampler 3/25 -> WavWriter) through
     ``compile_app(...).run()`` on a named queue: the tone must decode, the
     audio must match phase 3's and the same app on the CPU, K4 must launch
     once a tick; one more graph tick under the profiler, as it runs and
     with the Fir block as it was (the tick concatenated behind its carry
     in front of the kernel), must show one launch fewer and no tick-sized
     concatenation, and the Fir stage's two calling forms are timed; a checkpoint after 8 ticks resumed must give the same
     audio bit for bit; two such graphs on two queues through
     ``MergedRunner`` must match their single runs, with captured steps and
     with eager ones (wall time a tick on two queues and on one, both ways);
  8. the digital-voice app ``tpusdr_torch.apps.digital`` on its synthetic
     source (1 Msps, 8 ticks of 1,048,560 samples): the 500 Hz line must
     dominate the audio, which must match the CPU run;
  9. the FM channel bank, fm_channel_bank(20.48 Msps, 64 channels, 16 kHz),
     the JAX package's config 4, on 16 ticks of 2,096,640 samples of two FM
     stations (700 Hz on channel 2, 1,200 Hz on channel 61, 75 kHz
     deviation): both must decode at SNR > 30 dB over the second half with
     cross-talk under a tenth, the stations' audio must match the CPU path
     on the first 2 ticks and the channelizer's output its CPU output; no
     kernel may launch (the bank's stages are plain ops, and a batch must
     not reach a single-stream kernel).  Printed: chain Msps on CUDA
     events, RunStats Msps through a StreamRunner, one tick under the
     profiler (launches, device time), its device time on CUDA events and
     so its busy share, and its stages' device times on CUDA events and
     launches (branch filter, FFT, discriminator, IIR, resampler).  Then the
     channels app on the card at its defaults (16 channels, 5.12 Msps,
     2 s) writing channels 2 and 13, whose WAVs must decode;
 10. the runner's compiled step (one captured CUDA graph a tick): WBFM 20
     Msps default (K1) and fused (K2), NBFM 2 Msps fused (K3, its phase read
     through the pointer), the AM 20 Msps K4 runner and the 64-channel bank,
     each through a StreamRunner eagerly and captured on the same 16 ticks
     and a short last block, and the WBFM JSON graph through
     ``compile_app(...).run()`` both ways: the audio bit for bit, the
     launch counts equal (a replay counts its kernels), the short block
     trimmed, the decode bars of phases 3-5, 7 and 9 held; WBFM with a new
     offset halfway through must recapture and equal the eager run with the
     same update.  Printed for each, eager and captured: ms a tick and Msps
     on CUDA events, the tick's device time (CUDA events behind a spin
     kernel) and busy share, the host's launch calls a tick and the device
     records (a graph's kernels), RunStats Msps;
 11. every phase 2 row's bound at K5's best rate in this run (the floor
     probe's ceiling) beside its bound at peak, a JSON line of the kernels
     (with ``resample_poly`` at phase 2's shapes, phase 12's shard shapes, phase 13's two paths as
     ``native:banded_fir`` and ``shim:banded_fir``, and phase 14's K1 rows),
     the card line, and the result line (printed after phase 14);
 12. the sharded streams (``tpusdr_torch.parallel``) on a ``LocalMesh`` on
     the card, each captured (one CUDA graph a tick) and eager on the same
     ticks: the WBFM 20 Msps receiver over 8 shards of phase 3's 16 ticks,
     stagewise and chain-wide (K1 8 times a tick), use_fused=True over 2
     shards of 8 ticks of 2,560,000 (K2 twice a tick), NBFM 2 Msps fused
     over 8 shards of phase 4's ticks (K3 8 times, a phase each), the WBFM
     JSON graph chain-wide over 8 (K4 8 times), and the 64-channel bank
     over 4 and 5 shards (65 channels, one dead) on phase 9's 16 ticks (no
     kernel).  Checked: captured equals eager bit for bit, one graph, the
     launches; the audio within -100 dB of the unsharded chain on the same
     ticks (phase 3's audio for WBFM; the bank's stations within -60 dB),
     the tones as in phases 3, 4 and 9 (NBFM: the unsharded run's amplitude,
     SNR > 45 dB).  Printed: ms a tick, device time and busy share both
     ways, the unsharded captured tick's, and the sharded over unsharded
     device time.  Then a ``DistMesh`` over NCCL at world size 1 in this
     process (a FileStore under build/): one WBFM tick equals a
     ``LocalMesh(1)``'s bit for bit.  Then K1 (both halos), K2, K3 and K4
     at the shard shapes those paths launch, against their plain versions,
     with the plan each rule picks.
 13. host IO into the WBFM 20 Msps receiver (K1 at (546, /50) once a tick):
     (a) the receive CLI in-process on an int8 capture of phase 3's tone
     written to build/ (16 ticks of 1,280,000 and a 300,000-sample tail),
     with ``--native`` (``io/native.NativeFileStream``, the host library
     built from ``tpusdr_torch/io/csrc/`` with the host compiler) and without:
     the WAVs equal byte for byte, tail included, the tone at phase 3's
     amplitude and SNR > 60 dB; printed: RunStats Msps both ways and the
     NativeFileStream's own rate over the file with no chain behind it;
     (b) the radio loop: an in-process ``RfShim`` over ``FakeSdrDriver``
     (one FM station at 100.1 MHz, 1 kHz, 75 kHz deviation, not paced) ->
     ``SocketIqSource`` -> ``fm_receiver(20e6, 2.5e6, WBFM, int8)`` on a
     captured StreamRunner, centre 97.6 MHz for 8 ticks, then
     ``SdrReceiverControl.tune_radio(98.6e6)`` and 8 more: the tone at both
     sides (the first tick after the retune skipped), old-centre blocks
     flushed, none dropped, the runner recaptured to one graph, K1 once a
     tick; printed: ticks a second through the (host-bound) loop.
 14. the measurement layer: (a) ``tpusdr_torch.apps.bench_scaling.main``
     with ``--mode time`` at 20 Msps on ticks of 1,280,000 over 1, 2, 4 and
     8 shards of a ``LocalMesh`` on the card, chain-wide and
     ``--stagewise`` (K1 once a shard a step), and ``--mode channels`` over
     8 shards of the 64-channel bank at 20.48 Msps on ticks of 2,096,640
     (no kernel), 20 timed steps a mesh size: each size's launches counted
     alone, captured, its last output within -100 dB (time) or -60 dB
     (channels) of the unsharded chain stepped as often on the same tick;
     printed: the app's lines and JSON line (Msps and scaling efficiency a
     size); then K1 at each shard shape against its plain version.  (b)
     ``utils/profiling.scan_marginal`` over ``captured_run`` of the WBFM 20
     Msps tick (arms of 16, 96, 176 and 256 replays x 12 rounds, 4 ticks of
     phase 3's signal tiled on the card): K1 once a replay, ``per_tick``
     within 25% of the CUDA-event ms a tick of 256 replays, printed beside
     it and phase 10's captured ms a tick.  (c) F8: a ``StreamRunner`` over
     a chain without buffers, no device named, on the card and captured
     (one graph), within 1e-5 of the CPU; ``MergedRunner`` and a queue spec
     without ``queueType`` on the card too.

Phases 5, 7, 8, 9, 10, 13 and 14 run StreamRunner, which replays one captured CUDA
graph a tick on the card.  Each path runs with the launch counts set to 0
just before it and read just after (a replay adds the launches its graph
recorded); every kernel the path goes through must have launched.
Needs a CUDA device, nvcc and a host C++ compiler; builds the kernels and
the host library (phase 1) into build/tpusdr_torch/.
"""

from __future__ import annotations

import copy
import itertools
import json
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
BANK_SNR_MIN_DB = 30.0  # a station in the channel bank (tests/test_models_e2e.py's bar)
TONE_AMP = 0.375 * 0.905  # deviation/channel width x de-emphasis gain at 1 kHz
AM_TONE_AMP = 0.25  # carrier 0.5 x depth 0.5, the DC block removes the carrier
TICK = 1_280_000
N_TICKS = 16
FM_F1_TILE = 8  # filtered samples a block of FM-fused at (9660, /666), M = 625: 90 blocks where 16 gave 42


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def err_db(ref: np.ndarray, got: np.ndarray) -> float:
    return float(10 * np.log10(np.sum((ref - got) ** 2) / np.sum(ref**2)))


def tone_fit(x: np.ndarray, fs: float, f: float = 1000.0, skip: int = 3) -> tuple[float, float]:
    """Amplitude and SNR (dB) of a tone at f, after the first 1/skip."""
    x = x[len(x) // skip :].astype(np.float64)
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


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes moved once over the memory
    rate or operations over the fp32 rate, whichever is longer."""
    from tpusdr_torch.utils.profiling import H100_PEAK_FP32_TFLOPS, H100_PEAK_GBPS

    t_b, t_o = n_bytes / (H100_PEAK_GBPS * 1e6), n_ops / (H100_PEAK_FP32_TFLOPS * 1e9)
    return {"bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": n_bytes, "operations": n_ops}


def fir_cost(n_in, n_taps, n_out, complex_taps):
    """(bytes, operations) of a decimating FIR on complex64 data: every
    input sample, tap and output moved once; 8 (complex taps) or 4 (real
    taps) operations per tap and output."""
    per_tap = 8 if complex_taps else 4
    return (n_in + n_out) * 8 + n_taps * per_tap, n_out * n_taps * per_tap


def compare(torch, card, name, kernel_fn, plain_fn, counter, n_bytes, n_ops,
            library_fn=None, library_view=None, timed_fn=None, exact=False, phase="phase 2"):
    """Kernel against plain on the same inputs; times in turns
    (plain, kernel, kernel, plain).  ``timed_fn`` replaces ``kernel_fn`` in
    the timed loops (rotating inputs).  ``library_fn`` is one PyTorch call
    computing the same function (``library_view`` turns its result into
    the plain version's layout): timed and held to the plain version, used
    nowhere else.  Launches made here are not counted for the main paths
    (counter is restored)."""
    from tpusdr_torch.utils.profiling import device_ms

    saved = counter.launches
    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    check(counter.launches == saved + 1, f"{name}: kernel wrapper did not launch")
    diff = (got - ref).abs().max().item()
    peak = ref.abs().max().item()
    timed_fn = timed_fn or kernel_fn
    p1 = device_ms(plain_fn)
    k1 = device_ms(timed_fn)
    k2 = device_ms(timed_fn)
    p2 = device_ms(plain_fn)
    counter.launches = saved
    res = {
        "max_abs_err": diff,
        "rel_err": diff / peak,
        "ms": (k1 + k2) / 2,
        "plain_ms": (p1 + p2) / 2,
        **bound(n_bytes, n_ops),
        "library_ms": None,
    }
    if library_fn is not None:
        lib = library_view(library_fn())
        res["library_rel_err"] = ((lib - ref).abs().max() / peak).item()
        res["library_ms"] = device_ms(library_fn)
    print(f"{phase} {name} [{card}]: " + json.dumps(res), flush=True)
    tol = 0.0 if exact else KERNEL_TOL * peak
    check(diff <= tol, f"{name}: kernel vs plain {diff / peak:.3g} of peak")
    if library_fn is not None:
        check(res["library_rel_err"] <= 1e-4, f"{name}: library call vs plain {res['library_rel_err']:.3g}")
    return res


def conv1d_fir(torch, s, taps, D, M):
    """The library yardstick of a decimating FIR: one ``conv1d`` call with
    stride D over the real view of ``s`` (planar, made outside the timed
    call), two input channels; complex taps give two output channels that
    carry the complex product, real taps ``groups=2``.  Returns the call
    and the view of its (1, 2, M) result as complex (M,)."""
    F = torch.nn.functional
    T = taps.shape[-1]
    planes = torch.view_as_real(s[: (T - 1) + M * D]).T.contiguous().unsqueeze(0)  # (1, 2, L)
    h = torch.flip(taps, [-1])
    if taps.is_complex():
        w = torch.stack([torch.stack([h.real, -h.imag]), torch.stack([h.imag, h.real])]).contiguous()
        groups = 1
    else:
        w = h.reshape(1, 1, T).repeat(2, 1, 1).contiguous()
        groups = 2

    return {
        "library_fn": lambda: F.conv1d(planes, w, stride=D, groups=groups),
        "library_view": lambda y: torch.complex(y[0, 0], y[0, 1]),
    }


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
    """Stream the ticks through the chain; returns the audio joined along
    its time axis."""
    state = chain.init_state(device=device)
    outs = []
    for x in ticks:
        state, y = chain.apply(state, x)
        outs.append(y)
    return torch.cat(outs, dim=-1).cpu().numpy()


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
    from tpusdr_torch.benchmarks import plan_probe
    from tpusdr_torch.benchmarks import staging_probes as probes
    from tpusdr_torch.graph.blocks import FusedFmDemod
    from tpusdr_torch.kernels import build, copy_floor, fir_banded, fir_poly, fm_fused, staging_probes
    from tpusdr_torch.models import receiver
    from tpusdr_torch.ops import osc
    from tpusdr_torch.utils.profiling import H100_PEAK_GBPS, device_ms

    rng = np.random.default_rng(1)

    def fm_cost(n_in, n_taps, n_out):
        """FM-fused: the mix (6 operations a sample), the real-tap FIR over
        n_out + 1 filtered samples, float32 audio out."""
        return n_in * 8 + n_taps * 4 + n_out * 4, n_in * 6 + (n_out + 1) * n_taps * 4

    def crandn(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(z.astype(np.complex64)).to(dev)

    cmp = {}
    wb_chain, _ = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)
    shiftfir = wb_chain.get_block("shiftfir").to(dev)
    T, D = shiftfir.taps.shape[-1], shiftfir.decimation
    check((T, D) == (546, 50), f"WBFM 20 Msps stage is ({T}, {D}), expected (546, 50)")
    wb_plan = fir_banded.decim_fir_plan(T, D, True, TICK // D)
    print(f"phase 2 D-FIR plan at (546, /50), M={TICK // D}: {wb_plan}", flush=True)
    check(wb_plan == fir_banded.DecimFirPlan("phase", fir_banded.PHASE_TILE, T)
          and -(-TICK // D // wb_plan.tile) >= fir_banded.PHASE_MIN_BLOCKS,
          f"the WBFM shape takes the phase-major form, 224 outputs a block, all taps in one pass, 115 blocks: {wb_plan}")
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
        *fir_cost(TICK + T - 1, T, TICK // D, True),
        **conv1d_fir(torch, torch.cat([hist, x]), ctaps, D, TICK // D),
    )
    s0 = 8 * G - (T - 1)
    cmp["prelude"] = compare(
        torch, card, "D-FIR prelude form T=546 D=50 N=1280000",
        lambda: fir_banded.banded_fir_prelude(x, pre, ctaps, D),
        lambda: fir_banded.decim_fir_plain(pre.reshape(-1), x, ctaps, D, s0, TICK // D),
        fir_banded.banded_fir_prelude,
        *fir_cost(TICK + 8 * G, T, TICK // D, True),
        **conv1d_fir(torch, torch.cat([pre.reshape(-1), x])[s0:], ctaps, D, TICK // D),
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
        *fir_cost(x3.shape[0] + 8 * G3, T3, x3.shape[0] // D3, True),
    )
    # F1: the single-stage AM shape at 20 Msps (tile 32 of 64)
    Ta, Da = 6665, 500
    ta = torch.from_numpy((lowpass(Ta, 0.0005) * np.exp(-2j * np.pi * 0.06 * np.arange(Ta))).astype(np.complex64)).to(dev)
    hist_a = crandn(Ta - 1)
    cmp["hist_f1"] = compare(
        torch, card, f"D-FIR history form T=6665 D=500 N=1280000 {fir_banded.decim_fir_plan(Ta, Da, True, TICK // Da)}",
        lambda: fir_banded.banded_fir(x, ta, Da, history=hist_a),
        lambda: fir_banded.decim_fir_plain(hist_a, x, ta, Da, 0, TICK // Da),
        fir_banded.banded_fir,
        *fir_cost(TICK + Ta - 1, Ta, TICK // Da, True),
    )
    # the other D-FIR launches of the receiver paths, with the paths' own taps:
    # the AM CLI's two stages (beside K4's rows at the same shapes) and the
    # digital app's stage
    am_default, _ = receiver.am_receiver(20e6, 1.2e6, input_format="int8")
    dg_chain, _ = receiver.digital_receiver()
    dg_tick = (1 << 20) // dg_chain.granule * dg_chain.granule
    for key, blk, L in (("am1", am_default.get_block("shiftfir1"), TICK),
                        ("am2", am_default.get_block("rf_fir2"), TICK // 250),
                        ("digital", dg_chain.get_block("shiftfir"), dg_tick)):
        cplx = hasattr(blk, "mod_taps")
        tb = (blk.mod_taps if cplx else blk.taps).to(dev)
        Tb, Db = tb.shape[-1], blk.decimation
        hb, xb = crandn(Tb - 1), crandn(L)
        plan_b = fir_banded.decim_fir_plan(Tb, Db, cplx, L // Db)
        if key == "am1":
            check((Tb, Db) == (868, 250) and plan_b.form == "taps" and L // Db // plan_b.tile >= fir_banded.MIN_BLOCKS,
                  f"AM stage 1 is ({Tb}, {Db}) with plan {plan_b}: fewer than {fir_banded.MIN_BLOCKS} blocks")
        if key == "digital":
            check((Tb, Db) == (728, 12) and plan_b.form == "phase", f"the digital stage is ({Tb}, {Db}) with plan {plan_b}")
        cmp[f"hist_{key}"] = compare(
            torch, card, f"D-FIR history form T={Tb} D={Db} N={L} {'complex' if cplx else 'real'} taps {plan_b}",
            lambda xb=xb, tb=tb, Db=Db, hb=hb: fir_banded.banded_fir(xb, tb, Db, history=hb),
            lambda xb=xb, tb=tb, Db=Db, hb=hb, Mb=L // Db: fir_banded.decim_fir_plain(hb, xb, tb, Db, 0, Mb),
            fir_banded.banded_fir,
            *fir_cost(L + Tb - 1, Tb, L // Db, cplx),
            **conv1d_fir(torch, torch.cat([hb, xb]), tb, Db, L // Db),
        )

    nb_chain, _ = receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)
    front = nb_chain.get_block("frontend")
    check(isinstance(front, FusedFmDemod) and not front._rows_capable,
          "NBFM 2 Msps fused front end must take the FM-fused branch")
    ftaps = front.taps.to(dev)
    Tf, Df = ftaps.shape[-1], front.decimation
    check((Tf, Df) == (728, 66), f"NBFM stage is ({Tf}, {Df}), expected (728, 66)")
    nb_tick = nb_chain.granule * 160
    # the streaming call: the carried (T-1) + D samples through the second
    # pointer, then the tick
    Hf = (Tf - 1) + Df
    ext = torch.from_numpy(fm_signal(Hf + nb_tick, 2e6, 100e3, 5e3, seed=2)).to(dev)
    ph0 = osc.init_phase(0.3, dev)  # the carried phase: the kernel reads it through its pointer
    Mf = (ext.shape[0] - (Tf - 1)) // Df - 1
    fm_plan = fm_fused.fm_fused_plan(Tf, Df, Mf)
    fm_blocks = fm_fused.fm_fused_blocks(Mf, fm_plan)
    print(f"phase 2 FM-fused plan at (728, /66), M={Mf}: {fm_plan}, {fm_blocks} blocks of "
          f"{fm_fused.fm_fused_smem(Tf, Df, fm_plan)} B", flush=True)
    check(Mf == 20_000 and fm_plan == fm_fused.FmFusedPlan("phase", fm_fused.PHASE_TILE, Tf) and fm_blocks == 126,
          f"the NBFM 2 Msps tick takes the phase-major form, 160 filtered samples a block, 126 blocks: {fm_plan}, {fm_blocks}")
    cmp["fm"] = compare(
        torch, card, f"FM-fused T=728 D=66 M={Mf} {fm_plan}",
        lambda: fm_fused.fused_fm_demod(ext[Hf:], ftaps, Df, front.inc, ph0, front.gain, history=ext[:Hf]),
        lambda: fm_fused.fused_fm_demod_plain(ext, ftaps, Df, front.inc, ph0, front.gain, Mf),
        fm_fused.fused_fm_demod,
        *fm_cost(ext.shape[0], Tf, Mf),
    )
    # the channel form at the nbfm.capture cell's shape: the 57 marine
    # channels every 25 kHz from -700 to +700 kHz, a station on each, on one
    # tick behind its carried (T-1) + D samples, each channel's carried
    # phase at random; the launch and channel-row counts from 0
    from sdrbench.fm_fused_work import fm_fused_work
    from tpusdr_torch import kernels

    offsets_c, tick_c = [25e3 * k for k in range(-28, 29)], 1_278_750
    Cc = len(offsets_c)
    zc = sum(fm_signal(Hf + tick_c, 2e6, f, 5e3, seed=20 + j) for j, f in enumerate(offsets_c)) / Cc
    ext_c = torch.from_numpy(zc.astype(np.complex64)).to(dev)
    incs_c = torch.tensor([osc.freq_to_inc_u32(-f, 2e6) for f in offsets_c], dtype=torch.int64, device=dev)
    ph_c = osc.as_phases(rng.integers(0, 2**32, Cc).tolist(), dev)
    Mc = (ext_c.shape[0] - (Tf - 1)) // Df - 1
    fc_plan = fm_fused.fm_fused_plan(Tf, Df, Mc, Cc)
    fc_blocks = Cc * fm_fused.fm_fused_blocks(Mc, fc_plan)
    print(f"phase 2 FM-fused channel form at (728, /66), C={Cc}, M={Mc}: {fc_plan}, {fc_blocks} blocks",
          flush=True)
    check(Mc == 19_375 and fc_plan == fm_fused.FmFusedPlan("phase", fm_fused.PHASE_TILE, Tf),
          f"the nbfm.capture tick takes the phase-major form over {Cc} channels: M={Mc}, {fc_plan}")

    def channels_kernel():
        return fm_fused.fused_fm_demod(ext_c[Hf:], ftaps, Df, incs_c, ph_c, front.gain, history=ext_c[:Hf])

    kernels.reset_launch_counts()
    got_c = channels_kernel()
    torch.cuda.synchronize()
    counts_c = (fm_fused.fused_fm_demod.launches, fm_fused.fused_fm_demod.channel_rows)
    check(counts_c == (1, Cc) and got_c.shape == (Cc, Mc),
          f"the channel form: (launches, channel rows) {counts_c} and {tuple(got_c.shape)}, expected (1, {Cc})")
    cmp["fm_channels"] = compare(
        torch, card, f"FM-fused channel form T=728 D=66 C={Cc} M={Mc} {fc_plan}",
        channels_kernel,
        lambda: fm_fused.fused_fm_demod_plain(ext_c, ftaps, Df, incs_c, ph_c, front.gain, Mc),
        fm_fused.fused_fm_demod,
        *fm_fused_work(ext_c.shape[0], Tf, Mc, Cc),
    )
    cmp["fm_channels"]["launches"], cmp["fm_channels"]["channel_rows"] = counts_c
    b_c = cmp["fm_channels"]
    print(f"phase 2 FM-fused channel form C={Cc} M={Mc}: launches {counts_c[0]}, channel rows {counts_c[1]}, "
          f"{b_c['ms'] * 1e3:.2f} us against a bound of {b_c['bound_ms'] * 1e3:.2f} us ({b_c['bound_by']}: "
          f"{b_c['bytes']} B, {b_c['operations']} operations), plain {b_c['plain_ms'] * 1e3:.2f} us", flush=True)
    # F1: the single-stage NBFM 20 Msps shape
    Tn, Dn, Mn = 9660, 666, 625  # 625 outputs: one 416,250-sample tick
    Hn = (Tn - 1) + Dn
    tn = torch.from_numpy(lowpass(Tn, 0.0004)).to(dev)
    ext_n = torch.from_numpy(fm_signal((Tn - 1) + (Mn + 1) * Dn, 20e6, 1e6, 5e3, seed=5)).to(dev)
    inc_n = osc.freq_to_inc_u32(-1e6, 20e6)
    fn_plan = fm_fused.fm_fused_plan(Tn, Dn, Mn)
    fn_blocks = fm_fused.fm_fused_blocks(Mn, fn_plan)
    print(f"phase 2 FM-fused plan at (9660, /666), M={Mn}: {fn_plan}, {fn_blocks} blocks of "
          f"{fm_fused.fm_fused_smem(Tn, Dn, fn_plan)} B", flush=True)
    check(fn_plan == fm_fused.FmFusedPlan("taps", FM_F1_TILE, Tn) and fn_blocks == -(-Mn // (FM_F1_TILE - 1)),
          f"the single-stage NBFM 20 Msps tick takes lanes across taps, {FM_F1_TILE} filtered samples a block: {fn_plan}")
    cmp["fm_f1"] = compare(
        torch, card, f"FM-fused T=9660 D=666 M={Mn} {fn_plan}",
        lambda: fm_fused.fused_fm_demod(ext_n[Hn:], tn, Dn, inc_n, ph0, 0.5, history=ext_n[:Hn]),
        lambda: fm_fused.fused_fm_demod_plain(ext_n, tn, Dn, inc_n, ph0, 0.5, Mn),
        fm_fused.fused_fm_demod,
        *fm_cost(ext_n.shape[0], Tn, Mn),
    )
    b_n = cmp["fm_f1"]
    print(f"phase 2 FM-fused (9660, /666) M={Mn}: {b_n['ms'] * 1e3:.2f} us against a bound of "
          f"{b_n['bound_ms'] * 1e3:.2f} us ({b_n['bound_by']}: {b_n['bytes']} B, {b_n['operations']} operations)", flush=True)

    # K4 at its four shapes with the paths' own taps (the single-stage AM
    # stage with a low-pass of its width), through the streaming call: the
    # carried T-1 samples through the second pointer, then the tick
    k4_shapes = [(f"k4_{blk.decimation}", blk.taps.to(dev), blk.decimation, L)
                 for blk, L in ((am_chain.get_block("rf_fir1"), TICK), (am_chain.get_block("rf_fir2"), TICK // 250))]
    k4_shapes += [("k4_500", torch.from_numpy(lowpass(Ta, 0.0005)).to(dev), Da, TICK),
                  ("k4_graph", shiftfir.taps.to(dev), D, TICK)]  # the JSON graph's stage: the WBFM taps unfolded
    for key, tk, Dk, L in k4_shapes:
        Tk, Mk = tk.shape[-1], L // Dk
        hk, xk = crandn(Tk - 1), crandn(L)
        plan = fir_poly.fir_decim_plan(Tk, Dk, Mk)
        print(f"phase 2 K4 plan at ({Tk}, /{Dk}), M={Mk}: {plan}, {fir_poly.fir_decim_blocks(Mk, plan)} blocks of "
              f"{fir_poly.fir_decim_smem(Tk, Dk, plan)} B", flush=True)
        cmp[key] = compare(
            torch, card, f"K4 fir_decim T={Tk} D={Dk} N={L} {plan}",
            lambda xk=xk, tk=tk, Dk=Dk, hk=hk: fir_poly.fir_decim(xk, tk, Dk, history=hk),
            lambda xk=xk, tk=tk, Dk=Dk, hk=hk, Mk=Mk: fir_poly.fir_decim_plain(xk, tk, Dk, Mk, hk),
            fir_poly.fir_decim,
            *fir_cost(L + Tk - 1, Tk, Mk, False),
            **conv1d_fir(torch, torch.cat([hk, xk]), tk, Dk, Mk),
        )
        # the same plan on ticks that rotate past the L2 cache (the timing
        # probe's launches, which no wrapper counts)
        rot = plan_probe.probe("fir_decim", Tk, Dk, Mk, False, [(plan.form, plan.tile)], input_mode="rotate",
                               device=dev)[0]
        check(rot["ok"] and rot["is_rule_plan"], f"K4 ({Tk}, /{Dk}) from device memory: {rot}")
        cmp[key]["device_memory_ms"] = rot["us"] / 1e3
        print(f"phase 2 K4 ({Tk}, /{Dk}) M={Mk}: {cmp[key]['ms'] * 1e3:.2f} us on a fixed tick, "
              f"{rot['us']:.2f} from device memory ({rot['n_unique']} ticks in rotation)", flush=True)
    check(fir_poly.fir_decim_plan(T, D, TICK // D) == fir_poly.FirDecimPlan("phase", 224, T),
          "the JSON graph's K4 stage takes the phase-major form, 7 outputs a lane")

    cmp.update(resample_rows(torch, card, dev))

    # K5: the copy floor at both ticks; the timed calls rotate through
    # ticks that together exceed the L2 cache, so every byte comes from
    # device memory and a rate above the card's peak means dropped loads.
    # Beside each row: its time on one fixed tick (from the L2) and the read
    # yardstick, torch.sum over the same rotating ticks viewed as float32
    # (one call that reads the same bytes once; the port never calls it)
    Gc, sms = 6400, copy_floor.sm_count(dev.index)
    resident = build.library().tpusdr_copy_floor_resident
    for tick in (TICK, 2_048_000):
        rows = tick // Gc
        ticks = [crandn(rows, Gc) for _ in range(8)]
        turn = itertools.cycle(ticks)
        quick = {ns: device_ms(lambda ns=ns: copy_floor.copy_floor(next(turn), ns)) for ns in (2, 5, 10)}
        best = min(quick, key=quick.get)
        for ns in (1, best):
            plan = copy_floor.copy_floor_plan(rows, Gc, ns, sms)
            smem = copy_floor.copy_floor_smem(plan)
            per_sm = resident(smem, dev.index)
            print(f"phase 2 K5 plan at ({rows}, {Gc}) n_split={ns}: {plan}, {smem} B a block, "
                  f"{per_sm} blocks of it resident an SM", flush=True)
            unit, n_bytes = copy_floor.ALIGN * ns, rows * Gc * 8
            longest = -(-(n_bytes // unit) // plan.blocks) * unit + n_bytes % unit  # the longest span
            check(plan.per_sm == copy_floor.PER_SM <= per_sm and plan.blocks == sms * plan.per_sm
                  and plan.unit == unit and plan.piece <= copy_floor.PIECE_BYTES
                  and plan.stages * plan.piece >= longest,
                  f"K5 ({rows}, {Gc}): {copy_floor.PER_SM} block on every SM, spans in 128-byte units, "
                  f"each span in flight at once: {plan}")
            r = compare(
                torch, card, f"K5 copy_floor tick={tick} n_split={ns}",
                lambda ns=ns: copy_floor.copy_floor(ticks[0], ns),
                lambda: copy_floor.copy_floor_plain(ticks[0]),
                copy_floor.copy_floor,
                copy_floor.moved_bytes(rows, Gc), 0,
                timed_fn=lambda ns=ns: copy_floor.copy_floor(next(turn), ns),
                exact=True,
                library_fn=lambda: ticks[0][:, : copy_floor.OUT_COLS].contiguous(), library_view=lambda y: y,
            )
            r["n_split"], r["plan"], r["gbps_in"] = ns, plan._asdict(), tick * 8 / (r["ms"] * 1e6)
            r["gbps_moved"] = copy_floor.moved_bytes(rows, Gc) / (r["ms"] * 1e6)
            r["fixed_tick_ms"] = device_ms(lambda ns=ns, plan=plan: copy_floor.launch(ticks[0], ns, plan))
            r["read_yardstick_ms"] = device_ms(lambda: next(turn).view(torch.float32).sum())
            print(f"phase 2 K5 tick={tick} n_split={ns}: {r['ms'] * 1e3:.2f} us from device memory "
                  f"({r['gbps_in']:.1f} GB/s in, {r['gbps_moved']:.1f} GB/s moved, peak {H100_PEAK_GBPS:.0f}), "
                  f"{r['fixed_tick_ms'] * 1e3:.2f} us on one fixed tick; read yardstick (torch.sum, rotating) "
                  f"{r['read_yardstick_ms'] * 1e3:.2f} us; slice {r['library_ms'] * 1e3:.2f} us; "
                  f"bound {r['bound_ms'] * 1e3:.2f} us", flush=True)
            check(r["gbps_moved"] <= H100_PEAK_GBPS,
                  f"K5 tick={tick} n_split={ns}: {r['gbps_moved']:.0f} GB/s is over the card's peak: loads were dropped")
            cmp[f"k5_{tick}_{'1' if ns == 1 else 'best'}"] = r
        del ticks, turn

    # K6-K8 at the probes' shapes, random data, exact
    Bp, Pp, Wp = 1024, 11, 128
    xp = torch.from_numpy(rng.standard_normal((4 * Bp + Pp - 1, Wp)).astype(np.float32)).to(dev)
    x6, x8 = xp[: 4 * Bp], xp[: Bp + Pp - 1]
    ones = torch.ones(1, 1, Pp, 1, device=dev)
    cmp["k6"] = compare(
        torch, card, "K6 staged_add_one (4096, 128) B=1024",
        lambda: staging_probes.staged_add_one(x6, Bp), lambda: staging_probes.staged_add_one_plain(x6),
        staging_probes.staged_add_one, 2 * x6.numel() * 4, x6.numel(), exact=True,
        library_fn=lambda: torch.add(x6, 1.0), library_view=lambda y: y,
    )
    cmp["k7"] = compare(
        torch, card, "K7 staged_window_double (4106, 128) B=1024 P=11",
        lambda: staging_probes.staged_window_double(xp, Bp, Pp),
        lambda: staging_probes.staged_window_double_plain(xp, Pp),
        staging_probes.staged_window_double, 2 * x6.numel() * 4, x6.numel(), exact=True,
        library_fn=lambda: torch.mul(x6, 2.0), library_view=lambda y: y,
    )
    cmp["k8"] = compare(
        torch, card, "K8 staged_shift_sum (1034, 128) P=11",
        lambda: staging_probes.staged_shift_sum(x8, Pp), lambda: staging_probes.staged_shift_sum_plain(x8, Pp),
        staging_probes.staged_shift_sum, (x8.numel() + Bp * Wp) * 4, Bp * Wp * (Pp - 1), exact=True,
        library_fn=lambda: torch.nn.functional.conv2d(x8.view(1, 1, Bp + Pp - 1, Wp), ones),
        library_view=lambda y: y[0, 0],
    )
    # K6-K8 also with the plan their rule picks, from device memory (128 MiB
    # of inputs in rotation), beside the library call on the same inputs and
    # the timer's trivial launch
    for key, which, library in (("k6", "W4", "torch.add"), ("k7", "X1", "torch.mul"), ("k8", "X2", "conv2d")):
        rot = probes.time_probe(which, dev, input_mode="rotate")[0]
        check(rot["ok"] and rot["is_rule_plan"] and rot["blocks"] == copy_floor.sm_count(dev.index),
              f"{which} from device memory: one block on every SM, exact: {rot}")
        cmp[key].update(plan=rot["plan"], smem=rot["smem"], staged_bytes=rot["staged_bytes"],
                        device_memory_ms=rot["us"] / 1e3,
                        device_memory_library_ms=rot["library_us"] / 1e3, launch_floor_ms=rot["launch_floor_us"] / 1e3,
                        busiest_bytes=rot.get("busiest_bytes"))
        busiest = f", the busiest block {rot['busiest_bytes']} B" if key == "k8" else ""
        print(f"phase 2 {key.upper()} ({which}) plan {rot['plan']}, {rot['smem']} B a block, "
              f"{rot['staged_bytes']} B staged{busiest}: "
              f"{cmp[key]['ms'] * 1e3:.2f} us on a fixed input ({library} {cmp[key]['library_ms'] * 1e3:.2f}), "
              f"{rot['us']:.2f} from device memory ({library} {rot['library_us']:.2f}); "
              f"trivial launch {rot['launch_floor_us']:.2f} us; bound {cmp[key]['bound_ms'] * 1e3:.2f} us", flush=True)
    return cmp


#: the resampler shapes of the main paths: (key, where it runs, U, D, rows,
#: tick a row, the ``kernels_used`` entry of that path's launches)
RESAMPLE_CELLS = [
    ("resample_nbfm", "nbfm.capture", 33, 125, 57, 19_375, "nbfm_capture:resample_poly"),
    ("resample_bank100", "bank100.capture", 6, 25, 100, 12_800, "bank100:resample_poly"),
    ("resample_wbfm", "wbfm.capture and phase 3", 3, 25, 1, 25_600, "wbfm:resample_poly"),
    ("resample_live", "wbfm.live", 3, 25, 1, 2_625, "live:resample_poly"),
    ("resample_nbfm2", "phase 4 NBFM 2 Msps", 198, 125, 1, 20_000, "nbfm:resample_poly"),
]


def resample_rows(torch, card, dev) -> dict:
    """Phase 2's rows of the batched resampler: ``resample_poly`` against
    its plain version (``ops.resample._resample_real`` behind the ``cat``)
    at every shape of ``RESAMPLE_CELLS``, random rows and carry, with the
    plan its rule picks; one launch and ``rows`` rows counted from 0; the
    carry bit for bit; the bound from ``sdrbench/resampler_work.py``."""
    from sdrbench.resampler_work import resampler_work
    from tpusdr_torch import kernels
    from tpusdr_torch.kernels import resample_poly as rp
    from tpusdr_torch.ops import resample as rs

    rng = np.random.default_rng(21)
    out = {}
    for key, label, U, D, rows, N, _used in RESAMPLE_CELLS:
        taps = rs.design_resampler_taps(U, D)
        plan = rs.make_plan(taps, U, D, N)
        ftaps, frame = rs.plan_taps(plan, dev), torch.from_numpy(plan.frame_taps).to(dev)
        P, M = plan.taps_per_phase, plan.block_out
        state = torch.from_numpy(rng.standard_normal((rows, P - 1)).astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((rows, N)).astype(np.float32)).to(dev)
        pplan = rp.resample_plan(U, D, P, rows, M)
        print(f"phase 2 resample_poly plan at {U}/{D} (P={P}), {rows} rows of {N}: {pplan}, "
              f"{rp.resample_blocks(U, rows, M, pplan)} blocks of {rp.resample_threads(pplan)} threads and "
              f"{rp.resample_smem(U, D, rp.group_len(U, D, P), pplan.tile, pplan.groups)} B", flush=True)
        kernels.reset_launch_counts()
        carry, _ = rp.resample_poly(state, x, plan, ftaps)
        torch.cuda.synchronize()
        counts = (rp.resample_poly.launches, rp.resample_poly.rows)
        check(counts == (1, rows), f"resample_poly {label}: (launches, rows) {counts}, expected (1, {rows})")
        check(torch.equal(carry, torch.cat([state, x], -1)[:, -(P - 1):]), f"resample_poly {label}: the carry differs")
        out[key] = compare(
            torch, card, f"resample_poly {label} U={U} D={D} P={P} rows={rows} N={N} {tuple(pplan)}",
            lambda state=state, x=x, plan=plan, ftaps=ftaps: rp.resample_poly(state, x, plan, ftaps)[1],
            lambda state=state, x=x, plan=plan, frame=frame: rp.resample_poly_plain(state, x, plan, frame)[1],
            rp.resample_poly, *resampler_work(rows, N, M, U, len(taps)),
        )
        out[key]["launches"], out[key]["rows"] = counts
        b = out[key]
        print(f"phase 2 resample_poly {label}: {b['ms'] * 1e3:.2f} us against a bound of {b['bound_ms'] * 1e3:.2f} us "
              f"({b['bound_by']}: {b['bytes']} B, {b['operations']} operations), plain {b['plain_ms'] * 1e3:.2f} us, "
              f"{b['rel_err']:.2g} of peak", flush=True)
    return out


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
        check_path(counts, f"WBFM {label}", {wrapper: N_TICKS, "resample_poly": N_TICKS})
        kernels_used[wrapper] = counts[wrapper]
        kernels_used["wbfm:resample_poly"] = counts["resample_poly"]
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
    return runs, audio["default"]


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
    check_path(counts, "NBFM", {"fused_fm_demod": nb_ticks, "resample_poly": nb_ticks})
    kernels_used["fused_fm_demod"] = counts["fused_fm_demod"]
    kernels_used["nbfm:resample_poly"] = counts["resample_poly"]
    e_nb = err_db(run_chain(torch, nb_ref_chain, nb_cpu, "cpu"), nb_audio)
    run = {"gpu_vs_cpu_db": e_nb, "tick": nb_tick, "host_msps": nb_ticks * nb_tick / host_s / 1e6,
           "launches": counts}
    run.update(nbfm_tick_profile(torch, nb_chain, nb_gpu, dev))
    print(f"phase 4 NBFM 2 Msps fused [{card}]: " + json.dumps(run), flush=True)
    check(e_nb <= AUDIO_TOL_DB, f"NBFM: GPU vs CPU {e_nb:.1f} dB")
    check(not run["tick_sized_cats"], f"NBFM: the tick is concatenated in front of the kernel: {run['tick_sized_cats']}")
    return run


def resampler_paths(torch, card, dev, kernels_used: dict) -> dict:
    """Phase 4's main paths of the batched resampler that phases 3 and 4
    do not run: the ``nbfm.capture`` chain (``nbfm_channels`` over the 57
    marine offsets), the ``bank100.capture`` chain (``fm_channel_bank`` of
    100 channels at 20 Msps, 48 kHz) and the WBFM receiver on
    ``wbfm.live``'s blocks of 131,250, two ticks each of complex noise:
    ``resample_poly`` once a tick over every row, the audio finite."""
    from tpusdr_torch import kernels
    from tpusdr_torch.kernels import resample_poly as rp
    from tpusdr_torch.models import multichannel, receiver

    rng = np.random.default_rng(5)
    paths = (
        ("nbfm_capture", lambda: multichannel.nbfm_channels(2e6, [25e3 * k for k in range(-28, 29)])[0],
         1_278_750, 57),
        ("bank100", lambda: multichannel.fm_channel_bank(20e6, 100, 48000.0)[0], 1_280_000, 100),
        ("live", lambda: receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)[0], 131_250, 1),
    )
    runs = {}
    for name, build, tick, rows in paths:
        chain = build()
        chain.to(dev)
        z = (rng.standard_normal((2, tick)) + 1j * rng.standard_normal((2, tick))) * 0.1
        kernels.reset_launch_counts()
        audio = run_chain(torch, chain, torch.from_numpy(z.astype(np.complex64)).to(dev), dev)
        counts = path_counts(torch)
        runs[name] = {"tick": tick, "rows": rp.resample_poly.rows, "audio_shape": list(audio.shape),
                      "launches": counts}
        print(f"phase 4 resampler path {name} [{card}]: " + json.dumps(runs[name]), flush=True)
        check_path(counts, f"{name} chain", {"resample_poly": 2})
        check(rp.resample_poly.rows == 2 * rows, f"{name} chain: {rp.resample_poly.rows} resampled rows, expected {2 * rows}")
        check(bool(np.isfinite(audio).all()), f"{name} chain: audio not finite")
        kernels_used[f"{name}:resample_poly"] = counts["resample_poly"]
    return runs


def profile_tick(torch, step, min_len: int) -> dict:
    """One warm tick, ``step()``, under ``torch.profiler``: its launches and
    device time, and, through a wrapper around ``torch.cat`` for that tick,
    every concatenation with an operand of at least ``min_len`` samples (a
    kernel that reads [history, tick] through two pointers needs none).
    ``step`` leaves no trace but its result, so it runs in three sessions
    and the one that saw the most device records counts: a session can see
    none (it happens on a later session of a process) or miss one (one of
    four runs on an H100 saw a graph tick one launch short), never add
    one."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cats, real_cat = [], torch.cat

    def spy_cat(tensors, *args, **kw):
        lengths = [t.shape[-1] for t in tensors if t.dim()]
        if max(lengths, default=0) >= min_len:
            cats.append(lengths)
        return real_cat(tensors, *args, **kw)

    on_card = []
    for _ in range(3):
        cats.clear()
        torch.cat = spy_cat
        try:
            with torch.profiler.profile(activities=acts) as prof:
                step()
                torch.cuda.synchronize()
        finally:
            torch.cat = real_cat
        seen = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(seen) > len(on_card):
            on_card = seen
    return {
        "tick_launches": len(on_card) or None,  # None: the profiler saw no device activity here
        "tick_device_us": sum(e.device_time for e in on_card) or None,
        "tick_sized_cats": cats,
    }


def nbfm_tick_profile(torch, chain, ticks, dev) -> dict:
    """One more warm NBFM tick under ``profile_tick``: no operand as long as
    the tick may be concatenated.  Beside it the front end's two calling
    forms on that tick, timed in turns: the tick concatenated behind its
    history and handed over as one tensor, as before the second pointer,
    and the pair handed over as it lies."""
    from tpusdr_torch.kernels import fm_fused
    from tpusdr_torch.utils.profiling import device_ms

    state = chain.init_state(device=dev)
    for x in ticks[:2]:
        state, _ = chain.apply(state, x)
    out = profile_tick(torch, lambda: chain.apply(state, ticks[2]), ticks.shape[-1])
    front = chain.get_block("frontend")
    tail = state["frontend"]["tail"][-front.history:]
    x, taps = ticks[2], front.taps
    saved = fm_fused.fused_fm_demod.launches

    def one_tensor():
        return fm_fused.fused_fm_demod(torch.cat([tail, x]), taps, front.decimation, front.inc, 0, front.gain)

    def two_pointers():
        return fm_fused.fused_fm_demod(x, taps, front.decimation, front.inc, 0, front.gain, history=tail)

    check(bool(torch.equal(one_tensor(), two_pointers())), "NBFM: [history, tick] through two pointers differs from one tensor")
    a1, b1, b2, a2 = device_ms(one_tensor), device_ms(two_pointers), device_ms(two_pointers), device_ms(one_tensor)
    fm_fused.fused_fm_demod.launches = saved
    out.update(front_cat_then_kernel_us=(a1 + a2) * 500, front_two_pointers_us=(b1 + b2) * 500)
    return out


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
    kernels_used["am:banded_fir"] = counts["banded_fir"] // 2  # a stage
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
    # one more warm tick of the K4 chain: no operand as long as the input of
    # its second K4 stage (TICK // 250 samples) may be concatenated
    state = pallas_chain.init_state(device=dev)
    warm = [torch.from_numpy(words[i * TICK : (i + 1) * TICK]).to(dev) for i in range(3)]
    for x in warm[:2]:
        state, _ = pallas_chain.apply(state, x)
    saved = kernels.fir_decim.launches
    runs["k4_runner"].update(profile_tick(torch, lambda: pallas_chain.apply(state, warm[2]),
                                          TICK // pallas_chain.get_block("rf_fir1").decimation))
    kernels.fir_decim.launches = saved
    print(f"phase 5 AM 20 Msps int8 K4 StreamRunner [{card}]: " + json.dumps(runs["k4_runner"]), flush=True)
    for label, r in runs.items():
        check(abs(r["amp"] - AM_TONE_AMP) < 0.02, f"AM {label}: tone amplitude {r['amp']:.4f}")
        check(r["snr_db"] > SNR_MIN_DB, f"AM {label}: tone SNR {r['snr_db']:.1f} dB")
        check(r["gpu_vs_cpu_db"] <= AUDIO_TOL_DB, f"AM {label}: GPU vs CPU {r['gpu_vs_cpu_db']:.1f} dB")
    n_audio = N_TICKS * TICK * pallas_chain.up // pallas_chain.down
    check(len(audio_cli) == len(audio_k4) == n_audio, f"AM: audio lengths {len(audio_cli)}, {len(audio_k4)}")
    check(runs["k4_runner"]["vs_cli_db"] <= AUDIO_TOL_DB, "AM: K4 runner vs CLI audio")
    check(not runs["k4_runner"]["tick_sized_cats"],
          f"AM K4 runner: a K4 stage's input is concatenated: {runs['k4_runner']['tick_sized_cats']}")
    return runs


def floor_phase(torch, card, dev, kernels_used: dict) -> list:
    """Phase 6: the floor probe's arms at the 1,280,000-sample tick."""
    from tpusdr_torch import kernels
    from tpusdr_torch.benchmarks import kernel_floor_probe as probe

    reps = 20
    kernels.reset_launch_counts()
    lines = probe.floor_probe(dev, TICK, reps, "all",
                              emit=lambda kw: print(f"phase 6 floor probe [{card}]: " + json.dumps(kw), flush=True))
    counts = path_counts(torch)
    expected = probe.launches_expected(reps)
    check_path(counts, "floor probe", expected)
    for name in expected:
        kernels_used[f"probe:{name}"] = counts[name]
    for line in lines:
        check(line.get("ok", True), f"floor probe: {line}")
    metrics = {line["metric"] for line in lines if "metric" in line}
    want = {f"dma_floor_split{n}_msps" for n in probe.N_SPLITS} | {
        "kernel_prelude_msps", "kernel_hist1copy_msps", "kernel_nohist_msps",
        "kernel_concat2copy_msps", "kernel_prelude_noslice_msps"}
    check(metrics == want, f"floor probe printed {sorted(metrics)}")
    return lines


def staging_phase(torch, card, dev, kernels_used: dict) -> list:
    """Phase 6, second part: the staging probes W4, X1 and X2 through
    their entry point (each checks its whole output on random data, then
    prints the ones case)."""
    from tpusdr_torch import kernels
    from tpusdr_torch.benchmarks import staging_probes as probes

    kernels.reset_launch_counts()
    lines = []
    for which, v in (("W4", 2.0), ("X1", 2.0), ("X2", 11.0)):
        line = probes.run_probe(which, dev)
        print(f"phase 6 staging probe [{card}]: " + json.dumps(line), flush=True)
        check(line["ok"] and line["v"] == v, f"staging probe {which}: {line}")
        lines.append(line)
    counts = path_counts(torch)
    expected = {"staged_add_one": 2, "staged_window_double": 2, "staged_shift_sum": 2}
    check_path(counts, "staging probes", expected)
    for name in expected:
        kernels_used[name] = counts[name]
    return lines


def wbfm_graph_spec(taps, wav_path, num_blocks: int, audio_hz: float = 1000.0) -> dict:
    """The WBFM receiver at 20 Msps as a reference-schema JSON app: the
    shift as a Cosine -> Multiply pair, the RF stage as a real-tap Fir in
    mode "pallas" (kernel K4)."""
    return {
        "nodes": {
            "src": {"type": "Synth", "kind": "fm", "sampleRate": 20e6, "audioHz": audio_hz,
                    "deviation": 75e3, "carrierOffset": 2.5e6, "numBlocks": num_blocks},
            "osc": {"type": "Cosine", "sampleRate": 20e6, "frequency": -2.5e6,
                    "sampleType": "FloatComplex", "commandQueueId": "smoke_q0"},
            "mix": {"type": "Multiply"},
            "rf.fir": {"type": "Fir", "taps": taps, "decimation": 50, "mode": "pallas"},
            "dem": {"type": "QuadDemod", "modulation": "Fm", "sampleRate": 400e3, "fskDeviation": 200e3},
            "de": {"type": "Deemphasis", "sampleRate": 400e3, "tau": 75e-6},
            "rs": {"type": "Resampler", "up": 3, "down": 25},
            "wav": {"type": "WavWriter", "path": str(wav_path), "sampleRate": 48000},
        },
        "connections": [
            {"source": "src", "sink": "mix"},
            {"source": "osc", "sink": "mix", "sinkPort": 1},
            {"source": "mix", "sink": "rf.fir"},
            {"source": "rf.fir", "sink": "dem"},
            {"source": "dem", "sink": "de"},
            {"source": "de", "sink": "rs"},
            {"source": "rs", "sink": "wav"},
        ],
    }


def graph_phase(torch, card, dev, wbfm_audio, kernels_used: dict) -> dict:
    """Phase 7: the JSON graph at full width on a named queue, its
    checkpoint and two graphs on two queues."""
    from tpusdr_torch import kernels
    from tpusdr_torch.graph.app import compile_app
    from tpusdr_torch.graph.checkpoint import load_state, save_state
    from tpusdr_torch.graph.queues import MergedRunner, get_queue_registry
    from tpusdr_torch.io.sources import SyntheticIqSource
    from tpusdr_torch.models import receiver

    chain, _ = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)
    taps = chain.get_block("shiftfir").taps.tolist()
    reg = get_queue_registry()
    q0 = reg.create("smoke_q0", {"queueType": "cuda", "cudaDevice": dev.index})
    q1 = reg.create("smoke_q1", {"queueType": "cuda", "cudaDevice": dev.index})
    run = {}

    # (a) the whole app on a named queue
    wav = OUT_DIR / "wbfm_graph.wav"
    app = compile_app(wbfm_graph_spec(taps, wav, N_TICKS), tick=TICK, queue="smoke_q0")
    check(app.tick == TICK and app.graph.granule == 1250, f"graph tick {app.tick}, granule {app.graph.granule}")
    kernels.reset_launch_counts()
    stats = app.run()
    counts = path_counts(torch)
    check_path(counts, "JSON graph", {"fir_decim": N_TICKS, "resample_poly": N_TICKS})
    kernels_used["graph:fir_decim"] = counts["fir_decim"]
    audio, fs = read_wav(wav)
    amp, snr = tone_fit(audio, fs)
    # the app's host-side source alone, no graph: what it allows the app
    t0 = time.perf_counter()
    n_src = sum(len(b) for b in app.source_factory(app.tick))
    source_msps = n_src / (time.perf_counter() - t0) / 1e6
    cpu_wav = OUT_DIR / "wbfm_graph_cpu.wav"
    compile_app(wbfm_graph_spec(taps, cpu_wav, 2), tick=TICK, device="cpu").run()
    ref, _ = read_wav(cpu_wav)
    quant = np.clip(np.round(wbfm_audio * 32767.0), -32768, 32767).astype(np.float32) / 32767
    run["app"] = {
        "amp": amp, "snr_db": snr, "samples": len(audio), "blocks": stats.blocks,
        "gpu_vs_cpu_db": err_db(ref, audio[: len(ref)]), "vs_fm_receiver_db": err_db(quant, audio),
        "runstats_msps_in": stats.msps_in, "source_alone_msps": source_msps,
        "wall_s": stats.wall_seconds, "launches": counts,
    }
    print(f"phase 7 JSON graph WBFM 20 Msps on queue smoke_q0 [{card}]: " + json.dumps(run["app"]), flush=True)
    check(n_src == N_TICKS * TICK, f"JSON graph: the source alone gave {n_src} samples")
    check(stats.blocks == N_TICKS and len(audio) == len(wbfm_audio), f"JSON graph: {stats.blocks} blocks, {len(audio)} samples")
    check(abs(amp - TONE_AMP) < 0.02, f"JSON graph: tone amplitude {amp:.4f}")
    check(snr > SNR_MIN_DB, f"JSON graph: tone SNR {snr:.1f} dB")
    check(run["app"]["gpu_vs_cpu_db"] <= AUDIO_TOL_DB, f"JSON graph: GPU vs CPU {run['app']['gpu_vs_cpu_db']:.1f} dB")
    check(run["app"]["vs_fm_receiver_db"] <= AUDIO_TOL_DB, f"JSON graph vs fm_receiver {run['app']['vs_fm_receiver_db']:.1f} dB")
    run["tick"] = graph_tick_profile(torch, app, dev)
    print(f"phase 7 JSON graph tick, the Fir stage as it runs and as it was [{card}]: " + json.dumps(run["tick"]),
          flush=True)
    after, before = run["tick"]["two_pointers"], run["tick"]["cat_then_kernel"]
    check(not after["tick_sized_cats"] and len(before["tick_sized_cats"]) == 1,
          f"JSON graph: tick-sized concatenations {after['tick_sized_cats']}, before {before['tick_sized_cats']}")
    if after["tick_launches"] is not None and before["tick_launches"] is not None:
        check(after["tick_launches"] == before["tick_launches"] - 1,
              f"JSON graph: {after['tick_launches']} launches a tick, {before['tick_launches']} before")

    # (b) a checkpoint after 8 ticks, resumed by a fresh app
    half = N_TICKS // 2
    first = compile_app(wbfm_graph_spec(taps, OUT_DIR / "wbfm_graph_a.wav", N_TICKS), tick=TICK, queue="smoke_q0")
    first.run(max_blocks=half)
    ckpt = OUT_DIR / "wbfm_graph_state.npz"
    save_state(str(ckpt), first.state)
    second = compile_app(wbfm_graph_spec(taps, OUT_DIR / "wbfm_graph_b.wav", N_TICKS), tick=TICK, queue="smoke_q0")
    whole_source = second.source_factory
    second.source_factory = lambda tick: itertools.islice(iter(whole_source(tick)), half, None)
    second.run(state=load_state(str(ckpt), second.runner.init_state()))
    joined = np.concatenate([read_wav(OUT_DIR / "wbfm_graph_a.wav")[0], read_wav(OUT_DIR / "wbfm_graph_b.wav")[0]])
    run["resume_bit_exact"] = bool(np.array_equal(joined, audio))
    print(f"phase 7 checkpoint after {half} ticks, resumed: bit exact {run['resume_bit_exact']}", flush=True)
    check(run["resume_bit_exact"], "JSON graph: resumed audio differs from the uninterrupted run")

    # (c) two graphs on two queues through MergedRunner against single runs
    graphs = {
        name: compile_app(wbfm_graph_spec(taps, OUT_DIR / f"unused_{name}.wav", 1), tick=TICK, queue=q).graph
        for name, q in (("a", "smoke_q0"), ("b", "smoke_q1"))
    }
    inputs = {
        name: [torch.from_numpy(b).to(dev) for b in SyntheticIqSource.fm(TICK, 20e6, hz, 75e3, 2.5e6, num_blocks=half)]
        for name, hz in (("a", 1000.0), ("b", 500.0))
    }
    torch.cuda.synchronize()

    def drive(runner, names):
        """Two passes of ``half`` ticks; the second (captures and plans
        built) is timed.  A captured step's outputs are its graph's static
        buffers, so each is cloned on its queue's stream before the next
        replay there."""
        outs = {n: [] for n in names}
        for _ in range(2):
            states = runner.init_state()
            for n in names:
                outs[n].clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(half):
                states, ys = runner.step(states, {n: inputs[n][i] for n in names})
                for n in names:
                    with runner.queues[n].activate():
                        outs[n].append(ys[n].clone())
            runner.synchronize()
            wall = time.perf_counter() - t0
        return {n: torch.cat(outs[n]) for n in names}, wall

    single, walls = {}, {}
    for name, q in (("a", q0), ("b", q1)):
        out, walls[f"single_{name}_s"] = drive(MergedRunner({name: graphs[name]}, queue=q), [name])
        single[name] = out[name]
    kernels.reset_launch_counts()
    two, walls["merged_two_queues_s"] = drive(MergedRunner(graphs, queue={"a": q0, "b": q1}), ["a", "b"])
    check_path(path_counts(torch), "MergedRunner", {"fir_decim": 2 * 2 * half, "resample_poly": 2 * 2 * half})
    one, walls["merged_one_queue_s"] = drive(MergedRunner(graphs, queue=q0), ["a", "b"])
    # the same two readings with eager steps (capture=False), as before the
    # captured step
    two_e, walls["merged_two_queues_eager_s"] = drive(MergedRunner(graphs, queue={"a": q0, "b": q1}, capture=False),
                                                      ["a", "b"])
    one_e, walls["merged_one_queue_eager_s"] = drive(MergedRunner(graphs, queue=q0, capture=False), ["a", "b"])
    run["merged"] = {
        **walls, "ticks": half,
        **{k[:-2] + "_ms_per_tick": v * 1e3 / half for k, v in walls.items()},
        "two_queues_equal_single": all(bool(torch.equal(two[n], single[n])) for n in graphs),
        "one_queue_equal_single": all(bool(torch.equal(one[n], single[n])) for n in graphs),
        "eager_equal_captured": all(bool(torch.equal(two_e[n], two[n])) and bool(torch.equal(one_e[n], two[n]))
                                    for n in graphs),
    }
    print(f"phase 7 MergedRunner, two graphs, {half} ticks each [{card}]: " + json.dumps(run["merged"]), flush=True)
    check(run["merged"]["two_queues_equal_single"], "MergedRunner on two queues differs from the single runs")
    check(run["merged"]["one_queue_equal_single"], "MergedRunner on one queue differs from the single runs")
    check(run["merged"]["eager_equal_captured"], "MergedRunner: eager steps differ from captured ones")
    return run


def graph_tick_profile(torch, app, dev) -> dict:
    """One more warm tick of the JSON graph under ``profile_tick``, twice: as
    it runs (K4 reads [carry, tick] through two pointers) and with the Fir
    block as it was before the second pointer (the tick concatenated behind
    its carry, then the kernel); beside them the Fir stage's two calling
    forms on that tick, timed in turns.  No launch here is counted."""
    import types

    from tpusdr_torch.kernels import fir_poly
    from tpusdr_torch.utils.profiling import device_ms

    graph, saved = app.graph, fir_poly.fir_decim.launches
    source = iter(app.source_factory(app.tick))
    ticks = [torch.from_numpy(next(source)).to(dev) for _ in range(3)]
    state = graph.init_state(device=dev)
    for x in ticks[:2]:
        state, _ = graph.apply(state, x)
    fir = graph.get_block("rf.fir")
    T, D = fir.taps.shape[-1], fir.decimation

    def cat_then_kernel(self, carry, x):
        ext = torch.cat([carry, x])
        return ext[ext.shape[-1] - (T - 1) :].clone(), fir_poly.fir_decim(ext, self.taps, self.decimation)

    out = {"two_pointers": profile_tick(torch, lambda: graph.apply(state, ticks[2]), app.tick)}
    fir._apply_pallas = types.MethodType(cat_then_kernel, fir)
    try:
        out["cat_then_kernel"] = profile_tick(torch, lambda: graph.apply(state, ticks[2]), app.tick)
    finally:
        del fir._apply_pallas
    carry, x = state["rf.fir"], ticks[2]

    def one_tensor():
        return fir_poly.fir_decim(torch.cat([carry, x]), fir.taps, D)

    def two_pointers():
        return fir_poly.fir_decim(x, fir.taps, D, history=carry)

    check(bool(torch.equal(one_tensor(), two_pointers())), "JSON graph: K4 through two pointers differs from one tensor")
    a1, b1, b2, a2 = device_ms(one_tensor), device_ms(two_pointers), device_ms(two_pointers), device_ms(one_tensor)
    fir_poly.fir_decim.launches = saved
    out.update(fir_cat_then_kernel_us=(a1 + a2) * 500, fir_two_pointers_us=(b1 + b2) * 500)
    return out


def digital_phase(torch, card, dev, kernels_used: dict) -> dict:
    """Phase 8: the digital-voice app on its synthetic source."""
    from tpusdr_torch import kernels
    from tpusdr_torch.apps import digital

    n_blocks, tick = 8, (1 << 20) // 120 * 120
    wav, cpu_wav = OUT_DIR / "digital.wav", OUT_DIR / "digital_cpu.wav"
    kernels.reset_launch_counts()
    rc = digital.main(["--device", str(dev), "--duration", str((n_blocks + 0.4) * tick / 1e6), "--audio", str(wav)])
    counts = path_counts(torch)
    check(rc == 0, f"digital app exited {rc}")
    check_path(counts, "digital app", {"banded_fir": n_blocks})
    kernels_used["digital:banded_fir"] = counts["banded_fir"]
    rc = digital.main(["--device", "cpu", "--duration", str(2.4 * tick / 1e6), "--audio", str(cpu_wav)])
    check(rc == 0, f"digital app on the CPU exited {rc}")
    audio, fs = read_wav(wav)
    ref, _ = read_wav(cpu_wav)
    x = audio[len(audio) // 3 :].astype(np.float64)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 120 / 1e6)  # the true audio rate, 1e6 / 120
    k = int(spec.argmax())
    run = {
        "samples": len(audio), "peak_hz": float(freqs[k]),
        "peak_share": float(spec[max(0, k - 3) : k + 4].sum() / spec.sum()),
        "gpu_vs_cpu_db": err_db(ref, audio[: len(ref)]), "wav_rate": fs, "launches": counts,
    }
    print(f"phase 8 digital app 1 Msps, {n_blocks} ticks of {tick} [{card}]: " + json.dumps(run), flush=True)
    check(len(audio) == n_blocks * tick // 120, f"digital: {len(audio)} audio samples")
    check(abs(run["peak_hz"] - 500.0) < 2.0, f"digital: spectral peak at {run['peak_hz']:.1f} Hz, expected 500")
    check(run["peak_share"] > 0.5, f"digital: the 500 Hz line holds {run['peak_share']:.2f} of the energy")
    check(run["gpu_vs_cpu_db"] <= AUDIO_TOL_DB, f"digital: GPU vs CPU {run['gpu_vs_cpu_db']:.1f} dB")
    return run


def bank_signal(torch, dev, n: int, fs: float, m: int, deviation: float):
    """The channels app's two stations (``apps/channels.py``,
    ``two_stations``) as one continuous capture of n samples, made on the
    card in float64: 700 Hz on channel 2 and 1,200 Hz on channel M-3."""
    t = torch.arange(n, dtype=torch.float64, device=dev) / fs
    z = torch.zeros(n, dtype=torch.complex128, device=dev)
    for k, fa in ((2, 700.0), (m - 3, 1200.0)):
        audio = torch.sin(2 * np.pi * fa * t)
        ph = 2 * np.pi * (k * fs / m) * t + 2 * np.pi * deviation * torch.cumsum(audio, 0) / fs
        z += 0.5 * torch.polar(torch.ones_like(ph), ph)
    return z.to(torch.complex64)


def bank_phase(torch, card, dev) -> dict:
    """Phase 9: fm_channel_bank(20.48 Msps, 64 channels, 16 kHz) on ticks of
    2,096,640 samples, and the channels app at its defaults."""
    from tpusdr_torch import kernels
    from tpusdr_torch.graph.runner import StreamRunner
    from tpusdr_torch.io.sinks import CollectSink
    from tpusdr_torch.models import multichannel
    from tpusdr_torch.ops import channelizer as chanops

    fs, m, stations = 20.48e6, 64, ((2, 700.0), (61, 1200.0))
    chain, info = multichannel.fm_channel_bank(fs, m, 16000.0)
    cpu_chain = copy.deepcopy(chain)
    chain.to(dev)
    tick = chain.granule * ((1 << 21) // chain.granule)
    check((chain.granule, tick) == (1280, 2_096_640), f"bank: granule {chain.granule}, tick {tick}")
    deviation = min(75e3, info["channel_rate"] / 4)
    ticks = bank_signal(torch, dev, N_TICKS * tick, fs, m, deviation).reshape(N_TICKS, tick)
    rows = [k for k, _ in stations]

    def run(chain, ticks, device):
        state, outs = chain.init_state(device=device), []
        for x in ticks:
            state, y = chain.apply(state, x)
            outs.append(y)
        return torch.cat(outs, dim=-1).cpu().numpy()

    kernels.reset_launch_counts()
    audio = run(chain, ticks, dev)
    counts = path_counts(torch)
    check(audio.shape == (m, N_TICKS * tick // 1280), f"bank: audio shape {audio.shape}")
    check(bool(np.isfinite(audio).all()), "bank: audio not finite")
    run_ = {"tick": tick, "launches": counts}
    for k, fa in stations:
        run_[f"ch{k}_amp"], run_[f"ch{k}_snr_db"] = tone_fit(audio[k], info["audio_rate"], fa, skip=2)
    a_cross, _ = tone_fit(audio[61], info["audio_rate"], 700.0, skip=2)
    run_["cross_amp"] = a_cross
    # the CPU path over the first 2 ticks: the channelizer's output in every
    # channel, and the audio of the stations' channels (a channel with no
    # station holds only the prototype's leakage, whose phase is rounding:
    # its audio differs by rounding between any two float32 paths)
    head = ticks[:2].cpu()
    ref = run(cpu_chain, head, "cpu")
    run_["gpu_vs_cpu_db"] = err_db(ref[rows], audio[rows, : ref.shape[-1]])
    run_["gpu_vs_cpu_all_channels_db"] = err_db(ref, audio[:, : ref.shape[-1]])
    chan, cpu_chan = chain.get_block("channelizer"), cpu_chain.get_block("channelizer")
    _, y_gpu = chan.apply(chan.init_state(device=dev), ticks[0])
    _, y_cpu = cpu_chan.apply(cpu_chan.init_state(), head[0])
    run_["channelizer_rel_err"] = ((y_gpu.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()

    # chain Msps on CUDA events over the 16 ticks, from a fresh state
    state = chain.init_state(device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(N_TICKS):
        state, _ = chain.apply(state, ticks[i])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    run_.update(msps=N_TICKS * tick / (ms * 1e3), ms_per_tick=ms / N_TICKS)

    # RunStats through a StreamRunner from host ticks
    host = [x.numpy() for x in ticks.cpu()]
    sink = CollectSink()
    kernels.reset_launch_counts()
    _, stats = StreamRunner(chain, device=dev).run(iter(host), sink)
    run_["runner_launches"] = path_counts(torch)
    run_["runstats_msps_in"] = stats.msps_in
    run_["runner_vs_chain_db"] = err_db(audio[rows], sink.result()[rows])

    # one warm tick under the profiler (launches, device time), and its
    # device time on CUDA events behind a spin kernel, whole and stage by
    # stage: the busy share and the split come from the events, because a
    # late profiler session in this process can miss records (the stages'
    # launches below, from the profiler, may count short)
    from tpusdr_torch.utils.profiling import device_ms

    state = chain.init_state(device=dev)
    for x in ticks[:2]:
        state, _ = chain.apply(state, x)
    tick_fn = lambda: chain.apply(state, ticks[2])  # noqa: E731
    run_.update(profile_tick(torch, tick_fn, tick))
    run_["tick_device_us_events"] = device_ms(tick_fn) * 1e3
    run_["busy_share"] = run_["tick_device_us_events"] / (run_["ms_per_tick"] * 1e3)
    plan = chanops.make_plan(chan.taps.cpu().numpy(), m, tick)
    h_cm, phase = chanops.plan_tensors(plan, dev)
    _, v = chanops.branch_filter(state["channelizer"], ticks[2], plan, h_cm)
    y = chanops.branch_dft(v, phase)
    stages = {"branch_filter": lambda: chanops.branch_filter(state["channelizer"], ticks[2], plan, h_cm),
              "fft": lambda: chanops.branch_dft(v, phase)}
    x_stage = y
    for name, label in (("demod", "discriminator"), ("deemph", "iir"), ("audio", "resampler")):
        blk, carry, x_in = chain.get_block(name), state[name], x_stage
        stages[label] = (lambda blk=blk, carry=carry, x_in=x_in: blk.apply(carry, x_in))
        _, x_stage = blk.apply(carry, x_in)
    run_["stage_device_us"] = {k: device_ms(f) * 1e3 for k, f in stages.items()}
    run_["stage_launches"] = {k: profile_tick(torch, f, tick)["tick_launches"] for k, f in stages.items()}
    print(f"phase 9 FM channel bank 20.48 Msps, 64 channels [{card}]: " + json.dumps(run_), flush=True)

    check_path(run_["launches"], "bank", {w: 0 for w in run_["launches"]})
    check_path(run_["runner_launches"], "bank runner", {w: 0 for w in run_["runner_launches"]})
    for k, _ in stations:
        check(run_[f"ch{k}_snr_db"] > BANK_SNR_MIN_DB, f"bank: channel {k} SNR {run_[f'ch{k}_snr_db']:.1f} dB")
    check(a_cross < 0.1 * run_["ch61_amp"], f"bank: cross-talk {a_cross:.4f} against {run_['ch61_amp']:.4f}")
    check(run_["gpu_vs_cpu_db"] <= AUDIO_TOL_DB, f"bank: GPU vs CPU {run_['gpu_vs_cpu_db']:.1f} dB")
    check(run_["channelizer_rel_err"] <= KERNEL_TOL, f"bank: channelizer GPU vs CPU {run_['channelizer_rel_err']:.3g}")
    check(run_["runner_vs_chain_db"] <= AUDIO_TOL_DB, f"bank: runner vs chain {run_['runner_vs_chain_db']:.1f} dB")
    return {"bank": run_, "app": channels_app_phase(torch, card, dev)}


def channels_app_phase(torch, card, dev) -> dict:
    """The channels app on the card at its defaults (16 channels, 5.12
    Msps, 2 s) writing channels 2 and 13; both WAVs must decode."""
    from tpusdr_torch import kernels
    from tpusdr_torch.apps import channels

    out_dir = OUT_DIR / "channels"
    kernels.reset_launch_counts()
    rc = channels.main(["--device", str(dev), "--write", "2,13", "--out-dir", str(out_dir)])
    counts = path_counts(torch)
    check(rc == 0, f"channels app exited {rc}")
    check_path(counts, "channels app", {w: 0 for w in counts})
    run = {"launches": counts}
    for k, fa, other in ((2, 700.0, 1200.0), (13, 1200.0, 700.0)):
        x, fs = read_wav(out_dir / f"ch{k:03d}.wav")
        amp, snr = tone_fit(x, fs, fa, skip=2)
        cross, _ = tone_fit(x, fs, other, skip=2)
        run[f"ch{k}"] = {"samples": len(x), "wav_rate": fs, "amp": amp, "snr_db": snr, "cross_amp": cross}
    print(f"phase 9 channels app 5.12 Msps, 16 channels [{card}]: " + json.dumps(run), flush=True)
    for k in (2, 13):
        r = run[f"ch{k}"]
        check(r["snr_db"] > BANK_SNR_MIN_DB, f"channels app: channel {k} SNR {r['snr_db']:.1f} dB")
        check(r["cross_amp"] < 0.1 * r["amp"], f"channels app: channel {k} cross-talk {r['cross_amp']:.4f}")
    return run


LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
})


def profile_launches(torch, step) -> dict:
    """One call of ``step()`` under ``torch.profiler``: the launches the host
    issued (the `cudaLaunchKernel` / `cuLaunchKernel`, copy and graph-launch calls) and the
    device records (kernels, copies; a graph's kernels each), in the
    fullest of three sessions (``profile_tick``'s rule)."""
    import collections

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    best = ([], [])
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            step()
            torch.cuda.synchronize()
        events = prof.events()
        host = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.name in LAUNCH_CALLS]
        dev_rec = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(dev_rec) > len(best[1]):
            best = (host, dev_rec)
    return {"host_launches": len(best[0]), "host_launch_calls": dict(collections.Counter(best[0])),
            "device_records": len(best[1]) or None, "profiler_device_us": sum(e.device_time for e in best[1]) or None}


def step_timing(torch, dev, block, ticks, capture: bool) -> dict:
    """The step alone on device-resident ticks (``tick_timing``), eager
    (``block.apply``) or captured (``CapturedStep``)."""
    from tpusdr_torch.graph.runner import CapturedStep

    step = CapturedStep(block) if capture else block.apply
    # 10 calls: an eager tick's ~60 launches each are enqueued well inside
    # the spin kernel, so the events see the card's pace
    out = tick_timing(torch, step, block.init_state(device=dev), ticks, reps=10)
    if capture:
        out["graphs"] = len(step._graphs)
    return out


def tick_timing(torch, step, state, ticks, reps: int) -> dict:
    """``step(state, x) -> (state, y)`` on device-resident ticks: 2 warm
    ticks (eager, then the capture), then ms a tick on CUDA events over the
    ticks, the tick's device time on CUDA events behind a spin kernel
    (``device_ms`` over ``reps`` calls, which the spin must outlast) and so
    the busy share, and one tick's launches under the profiler.  Launches
    made here are not counted for the paths."""
    from tpusdr_torch import kernels
    from tpusdr_torch.utils.profiling import device_ms

    saved = {w: w.launches for w in kernels.WRAPPERS}
    for x in ticks[:2]:
        state, _ = step(state, x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for x in ticks:
        state, _ = step(state, x)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / len(ticks)
    tick_fn = lambda: step(state, ticks[2])  # noqa: E731
    device_us = device_ms(tick_fn, reps=reps) * 1e3
    out = {"ms_per_tick": ms, "msps": ticks[0].shape[-1] / (ms * 1e3), "tick_device_us": device_us,
           "busy_share": device_us / (ms * 1e3), **profile_launches(torch, tick_fn)}
    for w, n in saved.items():
        w.launches = n
    return out


def captured_phase(torch, card, dev) -> dict:
    """Phase 10: the runner's compiled step.  Each configuration runs
    through a StreamRunner eagerly (``capture=False``) and captured (one CUDA
    graph replay a tick) on the same host ticks and a short last block:
    the audio must be equal bit for bit, the kernel launch counts equal
    (replays count), the short block trimmed as before, and the decode bars
    of the earlier phases must hold.  Then each step alone on the card,
    eager and captured: ms a tick and Msps on CUDA events, the tick's
    device time and busy share, host launches a tick and device records.
    WBFM default also takes a new offset halfway through the run, which
    must recapture and equal an eager run with the same update."""
    from tpusdr_torch import kernels
    from tpusdr_torch.graph.app import compile_app
    from tpusdr_torch.graph.runner import StreamRunner
    from tpusdr_torch.io.sinks import CollectSink
    from tpusdr_torch.io.sources import SyntheticIqSource
    from tpusdr_torch.models import multichannel, receiver

    def runner_pass(block, ticks, capture):
        sink = CollectSink()
        runner = StreamRunner(block, device=dev, capture=capture)
        kernels.reset_launch_counts()
        _, stats = runner.run(iter(ticks), sink)
        return sink.result(), stats, path_counts(torch), runner

    def fm_ticks(fs, offset, deviation, tick, seed):
        z = fm_signal(N_TICKS * tick, fs, offset, deviation, seed=seed)
        return [z[i * tick : (i + 1) * tick] for i in range(N_TICKS)]

    wb = fm_ticks(20e6, 2.5e6, 75e3, TICK, 3)
    bank, bank_info = multichannel.fm_channel_bank(20.48e6, 64, 16000.0)
    bank_tick = 2_096_640
    bank_dev = bank_signal(torch, dev, N_TICKS * bank_tick, 20.48e6, 64, min(75e3, bank_info["channel_rate"] / 4))
    words = np.concatenate(list(SyntheticIqSource.am(TICK, 20e6, 1.2e6, "int8", num_blocks=N_TICKS)))
    nb_chain, _ = receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)
    nb_tick = nb_chain.granule * 160
    configs = {
        "wbfm_default": (receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)[0], wb, "banded_fir"),
        "wbfm_fused": (receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM, use_fused=True)[0], wb, "banded_fir_prelude"),
        "nbfm_fused": (nb_chain, fm_ticks(2e6, 100e3, 5e3, nb_tick, 4), "fused_fm_demod"),
        "am_k4_runner": (receiver.am_receiver(20e6, 1.2e6, input_format="int8", fir_mode="pallas", fold_shift=False)[0],
                         [words[i * TICK : (i + 1) * TICK] for i in range(N_TICKS)], "fir_decim"),
        "bank": (bank, list(bank_dev.reshape(N_TICKS, bank_tick).cpu().numpy()), None),
    }
    runs = {}
    for label, (block, ticks, wrapper) in configs.items():
        cpu_block = copy.deepcopy(block)
        block.to(dev)
        ticks = ticks + [ticks[0][: len(ticks[0]) // 2 // block.granule * block.granule + 7]]  # a short last block
        eager, e_stats, e_counts, _ = runner_pass(block, ticks, False)
        captured, c_stats, c_counts, runner = runner_pass(block, ticks, None)
        n_in = sum(t.shape[-1] for t in ticks)
        r = {"eager_runstats_msps_in": e_stats.msps_in, "captured_runstats_msps_in": c_stats.msps_in,
             "bit_exact": bool(captured.shape == eager.shape and np.array_equal(captured, eager)),
             "rel_diff": float(np.abs(captured - eager).max() / np.abs(eager).max()) if captured.shape == eager.shape else None,
             "samples": captured.shape[-1], "samples_owed": n_in * block.up // block.down,
             "graphs": len(runner._step._graphs), "launches": c_counts, "eager_launches": e_counts}
        check(r["bit_exact"], f"captured {label}: audio differs from eager by {r['rel_diff']} of peak")
        check(c_counts == e_counts, f"captured {label}: launches {c_counts}, eager {e_counts}")
        check(wrapper is None or c_counts[wrapper] == len(ticks) * (2 if label == "am_k4_runner" else 1),
              f"captured {label}: {wrapper} launched {c_counts.get(wrapper)} times for {len(ticks)} ticks")
        check(wrapper is not None or not any(c_counts.values()), f"captured {label}: a kernel launched: {c_counts}")
        check(r["samples"] == r["samples_owed"] and r["graphs"] == 1,
              f"captured {label}: {r['samples']} samples of {r['samples_owed']}, {r['graphs']} graphs")
        # the decode bars of phases 3-5 and 9 on the captured audio of the
        # 16 continuous ticks (the short block repeats the first tick's head)
        whole = captured[..., : N_TICKS * ticks[0].shape[-1] * block.up // block.down]
        if label.startswith("wbfm"):
            r["amp"], r["snr_db"] = tone_fit(whole, 48000.0)
            check(abs(r["amp"] - TONE_AMP) < 0.02 and r["snr_db"] > SNR_MIN_DB,
                  f"captured {label}: tone {r['amp']:.4f}, {r['snr_db']:.1f} dB")
        elif label == "am_k4_runner":
            r["amp"], r["snr_db"] = tone_fit(whole, 48000.0, 700.0)
            check(abs(r["amp"] - AM_TONE_AMP) < 0.02 and r["snr_db"] > SNR_MIN_DB,
                  f"captured {label}: tone {r['amp']:.4f}, {r['snr_db']:.1f} dB")
        elif label == "bank":
            for k, fa in ((2, 700.0), (61, 1200.0)):
                r[f"ch{k}_amp"], r[f"ch{k}_snr_db"] = tone_fit(whole[k], bank_info["audio_rate"], fa, skip=2)
                check(r[f"ch{k}_snr_db"] > BANK_SNR_MIN_DB, f"captured bank: channel {k} at {r[f'ch{k}_snr_db']:.1f} dB")
        if label != "bank":
            head = [torch.from_numpy(t) for t in ticks[:2]]
            ref = run_chain(torch, cpu_block, head, "cpu")
            r["gpu_vs_cpu_db"] = err_db(ref, captured[: len(ref)])
            check(r["gpu_vs_cpu_db"] <= AUDIO_TOL_DB, f"captured {label}: GPU vs CPU {r['gpu_vs_cpu_db']:.1f} dB")
        dev_ticks = [torch.from_numpy(t).to(dev) for t in ticks[:N_TICKS]]
        r["eager"] = step_timing(torch, dev, block, dev_ticks, False)
        r["captured"] = step_timing(torch, dev, block, dev_ticks, True)
        del dev_ticks
        runs[label] = r
        print(f"phase 10 captured step {label} [{card}]: " + json.dumps(r), flush=True)

    # WBFM default: a new offset halfway through recaptures (the chain is
    # shared with the JSON graph below, so the offset is put back after)
    chain = configs["wbfm_default"][0]
    outs = {}
    for capture in (False, None):
        sink = CollectSink()
        runner = StreamRunner(chain, device=dev, capture=capture)
        state, _ = runner.run(iter(wb[: N_TICKS // 2]), sink)
        first = runner._step
        runner.update_parameters("shiftfir", frequency=-2.51e6)
        runner.run(iter(wb[N_TICKS // 2 :]), sink, state=state)
        outs[capture] = (sink.result(), runner._step is not first, getattr(runner._step, "_graphs", None))
        runner.update_parameters("shiftfir", frequency=-2.5e6)
    upd = {"bit_exact": bool(np.array_equal(outs[None][0], outs[False][0])), "recaptured": outs[None][1],
           "graphs_after": len(outs[None][2])}
    print(f"phase 10 captured step, WBFM with a new offset after {N_TICKS // 2} ticks [{card}]: " + json.dumps(upd),
          flush=True)
    check(upd["bit_exact"] and upd["recaptured"] and upd["graphs_after"] == 1,
          f"captured WBFM with an update: {upd}")
    runs["wbfm_update"] = upd

    # the JSON graph through compile_app(...).run(), eager against captured
    spec_taps = configs["wbfm_default"][0].get_block("shiftfir").taps.tolist()
    apps = {}
    for capture in (False, None):
        raw = OUT_DIR / f"wbfm_graph_captured_{capture}.f32"
        spec = wbfm_graph_spec(spec_taps, raw, N_TICKS)
        spec["nodes"]["wav"] = {"type": "RawWriter", "path": str(raw), "dtype": "float32"}
        app = compile_app(spec, tick=TICK, device=dev)
        if capture is False:
            app.runner = StreamRunner(app.graph, device=dev, capture=False)
        kernels.reset_launch_counts()
        stats = app.run()
        apps[capture] = (np.fromfile(raw, np.float32), stats, path_counts(torch), app)
    audio, stats, counts, app = apps[None]
    r = {"bit_exact": bool(np.array_equal(audio, apps[False][0])), "samples": len(audio),
         "eager_runstats_msps_in": apps[False][1].msps_in, "captured_runstats_msps_in": stats.msps_in,
         "graphs": len(app.runner._step._graphs), "launches": counts}
    r["amp"], r["snr_db"] = tone_fit(audio, 48000.0)
    check(r["bit_exact"], "captured JSON graph: audio differs from eager")
    check(counts == apps[False][2] and counts["fir_decim"] == N_TICKS, f"captured JSON graph: launches {counts}")
    check(abs(r["amp"] - TONE_AMP) < 0.02 and r["snr_db"] > SNR_MIN_DB,
          f"captured JSON graph: tone {r['amp']:.4f}, {r['snr_db']:.1f} dB")
    source = iter(app.source_factory(app.tick))
    dev_ticks = [torch.from_numpy(next(source)).to(dev) for _ in range(N_TICKS)]
    r["eager"] = step_timing(torch, dev, app.graph, dev_ticks, False)
    r["captured"] = step_timing(torch, dev, app.graph, dev_ticks, True)
    runs["json_graph"] = r
    print(f"phase 10 captured step json_graph [{card}]: " + json.dumps(r), flush=True)
    for label, r in runs.items():
        if "captured" in r:
            check(r["captured"]["graphs"] == 1, f"captured {label}: {r['captured']['graphs']} graphs")
    return runs


SHARD_DB = -100.0  # sharded audio against the unsharded chain's (JAX's bar, tests/test_parallel.py:44-57)
NBFM_SNR_MIN_DB = 45.0  # NBFM 2 Msps on phase 4's signal: 50.5 dB unsharded on the CPU (its noise sets it)


def wbfm_graph_input_spec(taps) -> dict:
    """Phase 7's WBFM JSON graph without its source and writer: the tick
    enters the mixer through an exposed port, the resampler's output is the
    graph's (and the oscillator is on no named queue)."""
    spec = wbfm_graph_spec(taps, OUT_DIR / "unused.wav", 1)
    nodes = {k: v for k, v in spec["nodes"].items() if k not in ("src", "wav")}
    nodes["osc"] = {k: v for k, v in nodes["osc"].items() if k != "commandQueueId"}
    conns = [c for c in spec["connections"] if c["source"] != "src" and c["sink"] != "wav"]
    return {"nodes": nodes, "connections": conns,
            "inputPorts": [{"exposedPort": 0, "mapped": {"node": "mix", "port": 0}}], "outputPort": "rs"}


def exact_or_db(ref: np.ndarray, got: np.ndarray) -> float | None:
    """None where ``got`` equals ``ref`` bit for bit, else ``err_db``."""
    return None if np.array_equal(ref, got) else err_db(ref, got)


def sharded_run(torch, obj, ticks):
    """The ticks through ``obj.step`` (a TimeShardedStream or a
    ChannelShardedBank), each output cloned on the step's stream before the
    next step (a captured step's outputs are its graph's buffers)."""
    carry, outs = obj.init_carry(), []
    for x in ticks:
        carry, y = obj.step(carry, x)
        outs.append(y.clone())
    return torch.cat(outs, dim=-1).cpu().numpy()


def sharded_phase(torch, card, dev, wbfm_audio, used: dict) -> tuple[dict, dict]:
    """Phase 12: the sharded streams on one card.  Each configuration runs
    captured (one CUDA graph a tick on a LocalMesh) and eager on the same
    ticks; the audio against the unsharded chain's, the tone, the launches
    a tick and the readings; then a DistMesh over NCCL at world size 1, and
    each kernel at the shard shapes the paths launch against its plain
    version.  Returns (runs, kernel comparisons)."""
    import torch.distributed as dist

    from tpusdr_torch import kernels
    from tpusdr_torch.graph.chain import Chain
    from tpusdr_torch.graph.graph import build_graph
    from tpusdr_torch.kernels import fir_banded, fir_poly, fm_fused
    from tpusdr_torch.models import multichannel, receiver
    from tpusdr_torch.ops import osc
    from tpusdr_torch.parallel import ChannelShardedBank, TimeShardedStream, make_mesh
    from tpusdr_torch.parallel.mesh import DistMesh, LocalMesh

    t_phase = time.perf_counter()
    wb = torch.from_numpy(fm_signal(N_TICKS * TICK, 20e6, 2.5e6, 75e3, seed=3)).to(dev)  # phase 3's signal
    wb_ticks = wb.reshape(N_TICKS, TICK)
    wb_long = wb.reshape(N_TICKS // 2, 2 * TICK)  # K2's granule: ticks of 2,560,000 over 2 shards
    nb_chain, _ = receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)
    nb_chain.to(dev)
    nb_tick = nb_chain.granule * 160
    nb_ticks = torch.from_numpy(fm_signal(4 * nb_tick, 2e6, 100e3, 5e3, seed=4)).to(dev).reshape(4, nb_tick)
    fs_b, m = 20.48e6, 64
    bank_chain, info = multichannel.fm_channel_bank(fs_b, m, 16000.0)
    bank_chain.to(dev)
    bank_tick = 2_096_640
    bank_ticks = bank_signal(torch, dev, N_TICKS * bank_tick, fs_b, m, min(75e3, info["channel_rate"] / 4))
    bank_ticks = bank_ticks.reshape(N_TICKS, bank_tick)  # phase 9's signal
    wb_chain = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)[0].to(dev)
    fused_chain = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM, use_fused=True)[0].to(dev)
    graph = build_graph(wbfm_graph_input_spec(wb_chain.get_block("shiftfir").taps.tolist())).to(dev)

    def tss(block, shards, **kw):
        return lambda capture: TimeShardedStream(block, make_mesh(shards), capture=capture, **kw)

    def bank(shards):
        chan, demod = bank_chain.blocks[0][1], Chain(bank_chain.blocks[1:])
        return lambda capture: ChannelShardedBank(chan, demod, make_mesh(shards), capture=capture)

    ref_nb = run_chain(torch, nb_chain, nb_ticks, dev)
    nb_amp, _ = tone_fit(ref_nb, 48000.0)
    refs = {"wbfm": (wb_chain, wb_ticks, wbfm_audio),
            "fused": (fused_chain, wb_long, run_chain(torch, fused_chain, wb_long, dev)),
            "nbfm": (nb_chain, nb_ticks, ref_nb), "graph": (graph, wb_ticks, run_chain(torch, graph, wb_ticks, dev)),
            "bank": (bank_chain, bank_ticks, run_chain(torch, bank_chain, bank_ticks, dev))}
    # (label, make, reference, the path's kernel, its launches a tick)
    configs = [
        ("wbfm_stagewise_s8", tss(wb_chain, 8, stagewise=True), "wbfm", "banded_fir", 8),
        ("wbfm_chainwide_s8", tss(wb_chain, 8, stagewise=False), "wbfm", "banded_fir", 8),
        ("wbfm_fused_stagewise_s2", tss(fused_chain, 2, stagewise=True), "fused", "banded_fir_prelude", 2),
        ("nbfm_fused_stagewise_s8", tss(nb_chain, 8), "nbfm", "fused_fm_demod", 8),
        ("json_graph_chainwide_s8", tss(graph, 8), "graph", "fir_decim", 8),
        ("bank_s4", bank(4), "bank", None, 0),
        ("bank_s5", bank(5), "bank", None, 0),
    ]
    unsharded_times = {key: step_timing(torch, dev, blk, ticks, True) for key, (blk, ticks, _) in refs.items()}
    runs = {}
    for label, make, key, wrapper, per_tick in configs:
        _, ticks, ref = refs[key]
        audio, counts, timing, objs = {}, {}, {}, {}
        for mode, capture in (("captured", None), ("eager", False)):
            obj = objs[mode] = make(capture)
            kernels.reset_launch_counts()
            audio[mode] = sharded_run(torch, obj, ticks)
            counts[mode] = path_counts(torch)
            # one call of an eager sharded tick (250-600 launches, 10-20 ms of
            # the host's time) for its device time: 10 would outlast the spin
            timing[mode] = tick_timing(torch, obj.step, obj.init_carry(), ticks, reps=10 if obj.capture else 1)
        got = audio["captured"]
        r = {"shards": obj.shards, "per_shard": ticks.shape[-1] // obj.shards, "ticks": len(ticks),
             "captured_equals_eager": bool(np.array_equal(got, audio["eager"])),
             "launches": counts["captured"], "eager_launches": counts["eager"], **timing,
             "unsharded_captured": unsharded_times[key],
             # the sharded tick's device time over the unsharded tick's:
             # the halo's redundant compute and S times as many launches
             "device_time_ratio": timing["captured"]["tick_device_us"] / unsharded_times[key]["tick_device_us"]}
        if isinstance(obj, TimeShardedStream):
            r.update(form="stagewise" if obj.stagewise else "chain-wide", halo=obj.halo,
                     stage_halos={n: h for n, _b, h, _s, _bs in obj._stages} if obj.stagewise else None)
            # the input samples a shard computes again for its halo, over its own
            first = obj._stages[0][2] if obj.stagewise else obj.halo
            r["halo_input_share"] = first / r["per_shard"]
            r["vs_unsharded_db"] = exact_or_db(ref, got)
            r["bit_exact_vs_unsharded"] = r["vs_unsharded_db"] is None
            r["amp"], r["snr_db"] = tone_fit(got, 48000.0)
        else:
            rows = [2, 61]
            r.update(m_pad=obj.m_pad, halo=obj.halo, stations_vs_unsharded_db=exact_or_db(ref[rows], got[rows]),
                     all_channels_vs_unsharded_db=exact_or_db(ref, got), bit_exact_vs_unsharded=bool(np.array_equal(ref, got)))
            for k, fa in ((2, 700.0), (61, 1200.0)):
                r[f"ch{k}_amp"], r[f"ch{k}_snr_db"] = tone_fit(got[k], info["audio_rate"], fa, skip=2)
            r["cross_amp"] = tone_fit(got[61], info["audio_rate"], 700.0, skip=2)[0]
        runs[label] = r
        print(f"phase 12 {label} [{card}]: " + json.dumps(r), flush=True)
        check(r["captured_equals_eager"], f"sharded {label}: captured audio differs from eager")
        expected = {w: 0 for w in counts["captured"]}
        if wrapper is not None:  # a time-sharded receiver: its RF kernel and its resampler's, once a shard
            expected[wrapper] = expected["resample_poly"] = per_tick * len(ticks)
        check_path(counts["captured"], f"sharded {label} captured", expected)
        check_path(counts["eager"], f"sharded {label} eager", expected)
        captured = objs["captured"]
        check(captured.capture and len(next(iter(captured._step_cache.values()))._graphs) == 1,
              f"sharded {label}: not one captured graph")
        if isinstance(obj, TimeShardedStream):
            check(r["bit_exact_vs_unsharded"] or r["vs_unsharded_db"] <= SHARD_DB,
                  f"sharded {label}: {r['vs_unsharded_db']} dB from unsharded")
            if key == "nbfm":
                check(abs(r["amp"] - nb_amp) < 0.02 and r["snr_db"] > NBFM_SNR_MIN_DB,
                      f"sharded {label}: tone {r['amp']:.4f}, {r['snr_db']:.1f} dB")
            else:
                check(abs(r["amp"] - TONE_AMP) < 0.02 and r["snr_db"] > SNR_MIN_DB,
                      f"sharded {label}: tone {r['amp']:.4f}, {r['snr_db']:.1f} dB")
        else:
            for k in (2, 61):
                check(r[f"ch{k}_snr_db"] > BANK_SNR_MIN_DB, f"sharded {label}: channel {k} at {r[f'ch{k}_snr_db']:.1f} dB")
            check(r["cross_amp"] < 0.1 * r["ch61_amp"], f"sharded {label}: cross-talk {r['cross_amp']:.4f}")
            check(r["stations_vs_unsharded_db"] is None or r["stations_vs_unsharded_db"] <= AUDIO_TOL_DB,
                  f"sharded {label}: stations {r['stations_vs_unsharded_db']} dB from unsharded")
    used["shard:banded_fir"] = runs["wbfm_stagewise_s8"]["launches"]["banded_fir"]
    used["shard:banded_fir_chainwide"] = runs["wbfm_chainwide_s8"]["launches"]["banded_fir"]
    used["shard:banded_fir_prelude"] = runs["wbfm_fused_stagewise_s2"]["launches"]["banded_fir_prelude"]
    used["shard:fused_fm_demod"] = runs["nbfm_fused_stagewise_s8"]["launches"]["fused_fm_demod"]
    used["shard:fir_decim"] = runs["json_graph_chainwide_s8"]["launches"]["fir_decim"]

    # a DistMesh over NCCL at world size 1 in this process, meeting through
    # a FileStore (no port): one WBFM tick equals a LocalMesh(1)'s
    local = TimeShardedStream(wb_chain, LocalMesh({"dev": 1}, dev), capture=False)
    want = local.step(local.init_carry(), wb_ticks[0])[1].cpu().numpy()
    store = OUT_DIR / "nccl_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        dist_stream = TimeShardedStream(wb_chain, mesh)
        kernels.reset_launch_counts()
        got = dist_stream.step(dist_stream.init_carry(), wb_ticks[0])[1].cpu().numpy()
        nccl = {"mesh": repr(mesh), "backend": str(dist.get_backend()), "world_size": mesh.world_size,
                "bit_exact_vs_local": bool(np.array_equal(got, want)), "launches": path_counts(torch),
                "captured": dist_stream.capture}
    finally:
        dist.destroy_process_group()
    runs["nccl_world_1"] = nccl
    print(f"phase 12 DistMesh over NCCL at world size 1 [{card}]: " + json.dumps(nccl), flush=True)
    check(isinstance(mesh, DistMesh) and nccl["backend"] == "nccl" and nccl["bit_exact_vs_local"],
          f"DistMesh over NCCL: {nccl}")
    check(nccl["launches"]["banded_fir"] == 1, f"DistMesh over NCCL: launches {nccl['launches']}")

    # each kernel at the shard shapes the paths above launch, against its
    # plain version; the shard's halo and tick through the streaming call
    rng = np.random.default_rng(12)

    def crandn(n):
        return torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)).to(dev)

    cmp = {}
    shiftfir = wb_chain.get_block("shiftfir")
    ctaps, T, D = shiftfir.mod_taps, shiftfir.taps.shape[-1], shiftfir.decimation
    stage_h = runs["wbfm_stagewise_s8"]["stage_halos"]["shiftfir"]
    per = TICK // 8
    for key, n in (("k1_stagewise", per + stage_h), ("k1_chainwide", per + runs["wbfm_chainwide_s8"]["halo"])):
        x, hist, M = crandn(n), crandn(T - 1), n // D
        plan = fir_banded.decim_fir_plan(T, D, True, M)
        print(f"phase 12 D-FIR plan at ({T}, /{D}), shard M={M}: {plan}", flush=True)
        cmp[key] = compare(
            torch, card, f"D-FIR history form T={T} D={D} N={n} (a shard of 8) {plan}",
            lambda x=x, hist=hist: fir_banded.banded_fir(x, ctaps, D, history=hist),
            lambda x=x, hist=hist, M=M: fir_banded.decim_fir_plain(hist, x, ctaps, D, 0, M),
            fir_banded.banded_fir, *fir_cost(n + T - 1, T, M, True),
            **conv1d_fir(torch, torch.cat([hist, x]), ctaps, D, M), phase="phase 12")
    front = fused_chain.get_block("frontend")
    G, _ = fir_banded.prelude_plan(T, D)
    n2 = TICK + runs["wbfm_fused_stagewise_s2"]["stage_halos"]["frontend"]
    x2, pre = crandn(n2), crandn(8 * G).reshape(8, G)
    cmp["k2_shard"] = compare(
        torch, card, f"D-FIR prelude form T={T} D={D} N={n2} (a shard of 2)",
        lambda: fir_banded.banded_fir_prelude(x2, pre, front.mod_taps, D),
        lambda: fir_banded.decim_fir_plain(pre.reshape(-1), x2, front.mod_taps, D, 8 * G - (T - 1), n2 // D),
        fir_banded.banded_fir_prelude, *fir_cost(n2 + 8 * G, T, n2 // D, True),
        **conv1d_fir(torch, torch.cat([pre.reshape(-1), x2])[8 * G - (T - 1):], front.mod_taps, D, n2 // D),
        phase="phase 12")
    nb_front = nb_chain.get_block("frontend")
    Tf, Df = nb_front.taps.shape[-1], nb_front.decimation
    Hf = (Tf - 1) + Df
    n3 = nb_tick // 8 + runs["nbfm_fused_stagewise_s8"]["stage_halos"]["frontend"]
    ext = torch.from_numpy(fm_signal(Hf + n3, 2e6, 100e3, 5e3, seed=12)).to(dev)
    ph = osc.as_phase(0xFFFFFF00, dev)  # a shard's phase, just short of the wrap
    M3 = (ext.shape[0] - (Tf - 1)) // Df - 1
    plan3 = fm_fused.fm_fused_plan(Tf, Df, M3)
    print(f"phase 12 FM-fused plan at ({Tf}, /{Df}), shard M={M3}: {plan3}, {fm_fused.fm_fused_blocks(M3, plan3)} blocks",
          flush=True)
    cmp["k3_shard"] = compare(
        torch, card, f"FM-fused T={Tf} D={Df} M={M3} (a shard of 8) {plan3}",
        lambda: fm_fused.fused_fm_demod(ext[Hf:], nb_front.taps, Df, nb_front.inc, ph, nb_front.gain, history=ext[:Hf]),
        lambda: fm_fused.fused_fm_demod_plain(ext, nb_front.taps, Df, nb_front.inc, ph, nb_front.gain, M3),
        fm_fused.fused_fm_demod, ext.shape[0] * 8 + Tf * 4 + M3 * 4, ext.shape[0] * 6 + (M3 + 1) * Tf * 4,
        phase="phase 12")
    rtaps = graph.nodes["rf.fir"].taps
    n4 = per + runs["json_graph_chainwide_s8"]["halo"]
    x4, h4, M4 = crandn(n4), crandn(T - 1), n4 // D
    plan4 = fir_poly.fir_decim_plan(T, D, M4)
    print(f"phase 12 K4 plan at ({T}, /{D}), shard M={M4}: {plan4}, {fir_poly.fir_decim_blocks(M4, plan4)} blocks",
          flush=True)
    cmp["k4_shard"] = compare(
        torch, card, f"K4 fir_decim T={T} D={D} N={n4} (a shard of 8) {plan4}",
        lambda: fir_poly.fir_decim(x4, rtaps, D, history=h4),
        lambda: fir_poly.fir_decim_plain(x4, rtaps, D, M4, h4),
        fir_poly.fir_decim, *fir_cost(n4 + T - 1, T, M4, False),
        **conv1d_fir(torch, torch.cat([h4, x4]), rtaps, D, M4), phase="phase 12")
    runs["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 12 took {runs['wall_s']:.1f} s", flush=True)
    return runs, cmp


HOST_IO_TAIL = 300_000  # samples after phase 13's whole ticks: a short last block, not a multiple of the tick


def int8_words(z: np.ndarray) -> np.ndarray:
    """Complex samples -> HackRF int8 IQ (full scale 127) as packed int16
    words, the port's block contract."""
    inter = np.empty(2 * len(z), np.float32)
    inter[0::2], inter[1::2] = z.real, z.imag
    return np.clip(np.round(inter * 127.0), -128, 127).astype(np.int8).view(np.int16)


def host_io_phase(torch, card, dev, used: dict) -> dict:
    """Phase 13: host IO into the WBFM 20 Msps receiver on the card.

    (a) The receive CLI in-process on an int8 capture of phase 3's tone
    (16 ticks and a 300,000-sample tail), with ``--native`` (the
    host library's read-ahead ring) and without (``FileIqSource``): the
    WAVs equal byte for byte, the tail included, the tone decodes, K1 once
    a block; then the NativeFileStream alone over the file.  (b) The radio
    loop: ``RfShim`` over ``FakeSdrDriver`` (one FM station at 100.1 MHz,
    not paced) -> ``SocketIqSource`` -> a captured ``StreamRunner``, centre
    97.6 MHz for 8 ticks, then ``SdrReceiverControl.tune_radio``
    to 98.6 MHz and as many more: the tone decodes on both sides (the first
    tick after the retune skipped), blocks at the old centre were flushed,
    none dropped, the runner recaptured once, K1 once a tick."""
    import contextlib
    import io
    import re

    from tpusdr_torch import kernels
    from tpusdr_torch.apps import receive
    from tpusdr_torch.graph.runner import StreamRunner
    from tpusdr_torch.io.control import SdrControlClient, SdrReceiverControl
    from tpusdr_torch.io.native import NativeFileStream
    from tpusdr_torch.io.shim import FakeSdrDriver, RfShim, Station
    from tpusdr_torch.io.sinks import CollectSink
    from tpusdr_torch.io.sources import SocketIqSource
    from tpusdr_torch.models import receiver

    t_phase = time.perf_counter()
    fs = 20e6
    runs: dict = {}

    # (a) --native against the plain file path, the same capture feeding both
    capture = OUT_DIR / "wbfm_20msps_int8.iq"
    n_in = N_TICKS * TICK + HOST_IO_TAIL
    int8_words(fm_signal(n_in, fs, 2.5e6, 75e3, seed=3)).tofile(capture)
    n_blocks = N_TICKS + 1
    wavs = {}
    for label, extra in (("native", ["--native"]), ("plain", [])):
        wavs[label] = OUT_DIR / f"wbfm_20msps_{label}.wav"
        out = io.StringIO()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            rc = receive.main([
                "--device", str(dev), "--mod", "wbfm", "--format", "int8", "--input", str(capture),
                "--rf-rate", "20e6", "--offset", "2.5e6", "--tick", str(TICK),
                "--duration", str((n_blocks + 0.5) * TICK / fs), "--audio", str(wavs[label]), *extra,
            ])
        counts = path_counts(torch)
        check(rc == 0, f"receive CLI {label} exited {rc}")
        said = re.search(r"\(([0-9.]+) Msps\)", out.getvalue())
        audio, wav_fs = read_wav(wavs[label])
        amp, snr = tone_fit(audio, wav_fs)
        runs[label] = {"amp": amp, "snr_db": snr, "samples": len(audio),
                       "runstats_msps_in": float(said.group(1)) if said else None, "launches": counts}
        print(f"phase 13 WBFM 20 Msps int8 CLI, {label} file path [{card}]: " + json.dumps(runs[label]), flush=True)
        check_path(counts, f"CLI {label}", {"banded_fir": n_blocks, "resample_poly": n_blocks})
        check(abs(amp - TONE_AMP) < 0.02 and snr > SNR_MIN_DB, f"CLI {label}: tone {amp:.4f}, {snr:.1f} dB")
        # 20 Msps -> 48 kHz is 3 / 1250: the tail's audio is owed too
        check(len(audio) == n_in * 3 // 1250, f"CLI {label}: {len(audio)} audio samples for {n_in} in")
    runs["native_equals_plain"] = wavs["native"].read_bytes() == wavs["plain"].read_bytes()
    used["native:banded_fir"] = runs["native"]["launches"]["banded_fir"]
    t0 = time.perf_counter()
    n_read = 0
    with NativeFileStream(str(capture), TICK, "int8") as stream:
        for words in stream:
            n_read += len(words)
    runs["stream_host_msps"] = n_read / (time.perf_counter() - t0) / 1e6
    print(f"phase 13 --native WAV equals the plain path's: {runs['native_equals_plain']}; NativeFileStream alone "
          f"over the file: {runs['stream_host_msps']:.1f} Msps", flush=True)
    check(runs["native_equals_plain"], "--native audio differs from the plain file path's")
    check(n_read == n_in, f"NativeFileStream read {n_read} of {n_in} samples")

    # (b) the radio loop: fake radio -> shim -> socket -> captured runner
    half = N_TICKS // 2
    chain, spec = receiver.fm_receiver(fs, 2.5e6, receiver.WBFM, input_format="int8")
    runner = StreamRunner(chain.to(dev), device=dev)
    driver = FakeSdrDriver([Station(100.1e6, "fm", audio_hz=1000.0, deviation=75e3)], block_samples=TICK)
    sinks = (CollectSink(), CollectSink())
    with RfShim(driver) as shim, SdrControlClient("127.0.0.1", shim.control_port, timeout_s=60.0) as client:
        client.select_device(index=0)
        client.set_sample_rate(fs)
        client.set_frequency(97.6e6)  # the station at +2.5 MHz
        src = SocketIqSource("127.0.0.1", shim.data_port, TICK, "int8", pool_blocks=4 * N_TICKS, timeout_s=60.0)
        ctl = SdrReceiverControl(client, runner, 97.6e6, 100.1e6, source=src)
        client.start()
        try:
            blocks = iter(src)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            state, _ = runner.run(blocks, sinks[0], max_blocks=half)
            first = runner._step
            # blocks captured at the old centre must be in flight at the retune
            deadline = time.time() + 60.0
            while shim.bytes_sent < (half + 2) * 2 * TICK and time.time() < deadline:
                time.sleep(0.01)
            ctl.tune_radio(98.6e6)  # the station at +1.5 MHz
            runner.run(blocks, sinks[1], state=state, max_blocks=half)
            loop_s = time.perf_counter() - t0
            counts = path_counts(torch)
            loop = {"flushed_blocks": src.flushed_blocks, "dropped_blocks": src.dropped_blocks,
                    "recaptured": runner._step is not first, "graphs_after": len(getattr(runner._step, "_graphs", ())),
                    "shift_hz": chain.get_block("shiftfir").frequency, "ticks_per_s": 2 * half / loop_s,
                    "launches": counts}
        finally:
            src.close()
            client.stop()
    before, after = sinks[0].result(), sinks[1].result()
    loop["amp_before"], loop["snr_db_before"] = tone_fit(before, spec.audio_rate)
    loop["amp_after"], loop["snr_db_after"] = tone_fit(after, spec.audio_rate, skip=half)  # the first tick skipped
    runs["shim_loop"] = loop
    used["shim:banded_fir"] = counts["banded_fir"]
    runs["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 13 shim loop, WBFM 20 Msps, retune 97.6 -> 98.6 MHz after {half} ticks [{card}]: "
          + json.dumps(loop), flush=True)
    print(f"phase 13 took {runs['phase_s']:.1f} s", flush=True)
    check(loop["flushed_blocks"] > 0 and loop["dropped_blocks"] == 0,
          f"shim loop: {loop['flushed_blocks']} blocks flushed, {loop['dropped_blocks']} dropped")
    check(loop["recaptured"] and loop["graphs_after"] == 1, f"shim loop: {loop}")
    check(abs(loop["shift_hz"] + 1.5e6) < 1.0, f"shim loop: the NCO at {loop['shift_hz']} Hz after the retune")
    check_path(counts, "shim loop", {"banded_fir": 2 * half, "resample_poly": 2 * half})
    for side in ("before", "after"):
        amp, snr = loop[f"amp_{side}"], loop[f"snr_db_{side}"]
        check(abs(amp - TONE_AMP) < 0.02 and snr > SNR_MIN_DB, f"shim loop {side} the retune: {amp:.4f}, {snr:.1f} dB")
    return runs


SCALING_SHARDS = (1, 2, 4, 8)
SCAN_KS = (16, 96, 176, 256)  # the JAX package's bench arms (bench.py)
SCAN_REPS = 12
SCAN_TOL = 0.25  # scan_marginal's per_tick against the CUDA-event ms a tick of the same replays


def scaling_phase(torch, card, dev, wbfm_captured_ms: float, used: dict) -> tuple[dict, dict]:
    """Phase 14: the measurement layer on the card, and F8.

    (a) ``apps/bench_scaling.main`` as a user runs it: ``--mode time`` at
    20 Msps on ticks of 1,280,000 over 1, 2, 4 and 8 shards, chain-wide and
    ``--stagewise`` (K1 once a shard a step), and ``--mode channels`` over 8
    shards of the 64-channel bank at 20.48 Msps on ticks of 2,096,640 (no
    kernel).  Each mesh size runs with the counts set to 0 just before it
    and read just after; its last output against the unsharded chain
    stepped as often on the same tick.  Then K1 at each shard shape against
    its plain version.  (b) ``scan_marginal`` over ``captured_run`` of the
    WBFM 20 Msps tick (arms of 16-256 replays of 4 unique ticks tiled on
    the card), beside the CUDA-event ms a tick of the same replays and
    phase 10's.  (c) F8: a runner over a chain without buffers, no device
    named, is on the card and captures.  Returns (runs, kernel
    comparisons)."""
    import contextlib
    import io

    from tpusdr_torch import kernels
    from tpusdr_torch.apps import bench_scaling
    from tpusdr_torch.graph import blocks as B
    from tpusdr_torch.graph import queues
    from tpusdr_torch.graph.chain import Chain
    from tpusdr_torch.graph.runner import StreamRunner
    from tpusdr_torch.io.sinks import CollectSink
    from tpusdr_torch.kernels import fir_banded
    from tpusdr_torch.models import receiver
    from tpusdr_torch.parallel import TimeShardedStream
    from tpusdr_torch.utils import profiling

    t_phase = time.perf_counter()
    runs: dict = {}
    meshes: list = []
    orig_run_mesh = bench_scaling.run_mesh

    def counted_run_mesh(*args, **kw):
        """``run_mesh`` with this mesh size's launches counted alone, and its
        last output held to the unsharded chain on the same tick."""
        kernels.reset_launch_counts()
        r = orig_run_mesh(*args, **kw)
        counts = path_counts(torch)
        obj = r.sharded
        if isinstance(obj, TimeShardedStream):
            chain = obj.full_chain
            first_halo = obj._stages[0][2] if obj.stagewise else obj.halo
        else:
            chain = Chain([("channelizer", obj.channelizer), *obj.demod_chain.blocks])
            first_halo = obj.halo
        saved = {w: w.launches for w in kernels.WRAPPERS}
        state = chain.init_state(device=dev)
        for _ in range(r.steps):
            state, y = chain.apply(state, r.x)
        for w, n in saved.items():
            w.launches = n
        meshes.append({"devices": r.devices, "tick": r.tick, "steps": r.steps, "msps": r.msps,
                       "ms_per_tick": r.seconds_per_tick * 1e3, "captured": obj.capture, "halo": first_halo,
                       "per_shard": r.tick // r.devices, "launches": counts,
                       "vs_unsharded_db": exact_or_db(y.cpu().numpy(), r.y.cpu().numpy())})
        return r

    args = {
        "time_chainwide": ["--mode", "time", "--rf-rate", "20e6", "--tick", str(TICK)],
        "time_stagewise": ["--mode", "time", "--stagewise", "--rf-rate", "20e6", "--tick", str(TICK)],
        "channels_s8": ["--mode", "channels", "--rf-rate", "20.48e6", "--tick", "2096640"],
    }
    bench_scaling.run_mesh = counted_run_mesh
    try:
        for label, extra in args.items():
            shards = "8" if label.startswith("channels") else ",".join(map(str, SCALING_SHARDS))
            meshes.clear()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = bench_scaling.main(["--devices", shards, "--iters", "20", *extra])
            check(rc == 0, f"bench_scaling {label} exited {rc}")
            lines = out.getvalue().strip().splitlines()
            table = json.loads(lines[-1])
            r = {"lines": lines[:-1], "table": table, "meshes": list(meshes)}
            runs[label] = r
            print(f"phase 14 bench_scaling {label} [{card}]: " + json.dumps(r), flush=True)
            check(lines[0] == f"card: {card}", f"bench_scaling {label}: first line {lines[0]!r}")
            check([m["devices"] for m in meshes] == [e["devices"] for e in table["results"]],
                  f"bench_scaling {label}: meshes {meshes}")
            for m in meshes:
                check(m["captured"], f"bench_scaling {label} S={m['devices']}: not captured")
                if label.startswith("time"):
                    check(m["tick"] == TICK, f"bench_scaling {label}: tick {m['tick']}")
                    check(m["vs_unsharded_db"] is None or m["vs_unsharded_db"] <= SHARD_DB,
                          f"bench_scaling {label} S={m['devices']}: {m['vs_unsharded_db']} dB from unsharded")
                    expected = {w: 0 for w in m["launches"]}
                    expected["banded_fir"] = expected["resample_poly"] = m["devices"] * m["steps"]
                else:
                    check(m["tick"] == 2_096_640, f"bench_scaling {label}: tick {m['tick']}")
                    check(m["vs_unsharded_db"] is None or m["vs_unsharded_db"] <= AUDIO_TOL_DB,
                          f"bench_scaling {label}: {m['vs_unsharded_db']} dB from unsharded")
                    expected = {w: 0 for w in m["launches"]}
                check_path(m["launches"], f"bench_scaling {label} S={m['devices']}", expected)
    finally:
        bench_scaling.run_mesh = orig_run_mesh

    # K1 at every shard shape the time mode launched, against its plain version
    rng = np.random.default_rng(14)

    def crandn(n):
        return torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)).to(dev)

    shiftfir = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)[0].to(dev).get_block("shiftfir")
    ctaps, T, D = shiftfir.mod_taps, shiftfir.taps.shape[-1], shiftfir.decimation
    cmp = {}
    for label in ("time_chainwide", "time_stagewise"):
        for m in runs[label]["meshes"]:
            n = m["per_shard"] + m["halo"]
            x, hist, M = crandn(n), crandn(T - 1), n // D
            plan = fir_banded.decim_fir_plan(T, D, True, M)
            key = f"{label}_s{m['devices']}"
            cmp[key] = compare(
                torch, card, f"D-FIR history form T={T} D={D} N={n} (bench_scaling {label}, S={m['devices']}) {plan}",
                lambda x=x, hist=hist: fir_banded.banded_fir(x, ctaps, D, history=hist),
                lambda x=x, hist=hist, M=M: fir_banded.decim_fir_plain(hist, x, ctaps, D, 0, M),
                fir_banded.banded_fir, *fir_cost(n + T - 1, T, M, True),
                **conv1d_fir(torch, torch.cat([hist, x]), ctaps, D, M), phase="phase 14")
            cmp[key]["M"] = M
            used[f"scaling:{key}"] = m["launches"]["banded_fir"]

    # (b) scan_marginal over the captured WBFM tick
    chain = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)[0].to(dev)
    unique = fm_signal(4 * TICK, 20e6, 2.5e6, 75e3, seed=3).reshape(4, TICK)  # phase 3's signal
    xs = profiling.tile_ticks(unique, max(SCAN_KS), dev)
    run = profiling.captured_run(chain, dev)
    state0 = chain.init_state(device=dev)
    kernels.reset_launch_counts()
    m = profiling.scan_marginal(run, state0, xs, ks=SCAN_KS, reps=SCAN_REPS)
    counts = path_counts(torch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    saved = kernels.banded_fir.launches
    start.record()
    run(state0, xs)
    end.record()
    torch.cuda.synchronize()
    kernels.banded_fir.launches = saved
    events_ms = start.elapsed_time(end) / len(xs)
    scan = {"per_tick_ms": m["per_tick"] * 1e3, "spread": m["spread"], "pair_spread": m["pair_spread"],
            "times_s": {str(k): v for k, v in m["times"].items()}, "n_points": m["n_points"],
            "msps": TICK / m["per_tick"] / 1e6, "events_ms_per_tick": events_ms,
            "phase10_captured_ms_per_tick": wbfm_captured_ms, "per_tick_over_events": m["per_tick"] * 1e3 / events_ms,
            "per_tick_over_phase10": m["per_tick"] * 1e3 / wbfm_captured_ms, "launches": counts}
    runs["scan_marginal"] = scan
    used["scan:banded_fir"] = counts["banded_fir"]
    print(f"phase 14 scan_marginal over the captured WBFM 20 Msps tick, arms {SCAN_KS} x {SCAN_REPS} [{card}]: "
          + json.dumps(scan), flush=True)
    # every arm warmed once, then SCAN_REPS rounds; the first two ticks of the
    # shape (eager, then the capture) count as launches too
    replays = sum(SCAN_KS) * (SCAN_REPS + 1)  # the WBFM tick: K1 and the resampler's kernel once each
    check_path(counts, "scan_marginal", {**{w: 0 for w in counts}, "banded_fir": replays, "resample_poly": replays})
    check(m["n_points"] == len(SCAN_KS) * SCAN_REPS and abs(scan["per_tick_over_events"] - 1) < SCAN_TOL,
          f"scan_marginal: {scan['per_tick_ms']:.4f} ms a tick against {events_ms:.4f} on CUDA events")
    del xs

    # (c) F8: a runner over a chain without buffers, no device named
    bare = Chain([("d", B.QuadFmDemod(gain=1.0))])
    runner = StreamRunner(bare)
    ticks = [fm_signal(TICK, 20e6, 0.0, 75e3, seed=20 + i) for i in range(4)]
    sink = CollectSink()
    runner.run(iter(ticks), sink)
    ref = run_chain(torch, bare, [torch.from_numpy(t) for t in ticks], "cpu")
    f8 = {"buffers": len(list(bare.buffers())), "runner_device": str(runner.device), "capture": runner.capture,
          "graphs": len(runner._step._graphs), "merged_device": str(queues.MergedRunner({"a": bare}).devices["a"]),
          "queue_spec_device": str(queues._resolve_device({})),
          "max_abs_err_vs_cpu": float(np.abs(sink.result() - ref).max())}
    runs["f8"] = f8
    print(f"phase 14 F8, a chain without buffers [{card}]: " + json.dumps(f8), flush=True)
    check(f8["buffers"] == 0 and runner.device.type == "cuda" and f8["capture"] and f8["graphs"] == 1
          and f8["merged_device"].startswith("cuda") and f8["queue_spec_device"].startswith("cuda"), f"F8: {f8}")
    check(f8["max_abs_err_vs_cpu"] <= 1e-5, f"F8: {f8['max_abs_err_vs_cpu']} from the CPU")
    runs["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14 took {runs['phase_s']:.1f} s", flush=True)
    return runs, cmp


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tpusdr_torch.io import native
    from tpusdr_torch.kernels import build
    from tpusdr_torch.models import receiver
    from tpusdr_torch.utils.profiling import card_line

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
    t0 = time.perf_counter()
    native.get_lib()
    report["host_build_s"] = time.perf_counter() - t0
    print(f"phase 1: card {card!r}, device {report['device']!r}, "
          f"kernels built in {report['build_s']:.1f} s, the host library in {report['host_build_s']:.1f} s",
          flush=True)

    am_pallas, _ = receiver.am_receiver(20e6, 1.2e6, input_format="int8", fir_mode="pallas", fold_shift=False)
    cmp = kernel_phase(torch, card, dev, am_pallas)  # phase 2
    used: dict = {}
    wbfm_runs, wbfm_audio = wbfm_phase(torch, card, dev, used)  # phase 3
    main_runs = {
        "wbfm": wbfm_runs,
        "nbfm": nbfm_phase(torch, card, dev, used),  # phase 4
        "resampler_paths": resampler_paths(torch, card, dev, used),
        "am": am_phase(torch, card, dev, am_pallas, used),  # phase 5
        "floor_probe": floor_phase(torch, card, dev, used),  # phase 6
        "staging_probes": staging_phase(torch, card, dev, used),
        "graph": graph_phase(torch, card, dev, wbfm_audio, used),  # phase 7
        "digital": digital_phase(torch, card, dev, used),  # phase 8
        "channel_bank": bank_phase(torch, card, dev),  # phase 9
        "captured_step": captured_phase(torch, card, dev),  # phase 10
    }
    main_runs["sharded"], shard_cmp = sharded_phase(torch, card, dev, wbfm_audio, used)  # phase 12
    main_runs["host_io"] = host_io_phase(torch, card, dev, used)  # phase 13
    main_runs["scaling"], scaling_cmp = scaling_phase(  # phase 14
        torch, card, dev, main_runs["captured_step"]["wbfm_default"]["captured"]["ms_per_tick"], used)

    # -- phase 11: report -------------------------------------------------------
    # launches: the count of the main path that runs the kernel at the row's
    # shape (K1 WBFM default, the AM CLI, the digital app and phase 13's two
    # host IO paths; K2 WBFM fused, K3 NBFM, K4 the JSON graph and a stage of
    # the AM K4 runner, K5-K8 the probes' entry points)
    src = "tpusdr_torch/kernels/csrc/"
    kern = [
        {"name": "decim_fir (history form)", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
         "launches": used["banded_fir"], **_nums(cmp["hist"])},
        {"name": "decim_fir (prelude form)", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:604",
         "launches": used["banded_fir_prelude"], **_nums(cmp["prelude"])},
        {"name": "decim_fir (history form, WBFM CLI --native)", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
         "launches": used["native:banded_fir"], **_nums(cmp["hist"])},
        {"name": "decim_fir (history form, WBFM shim loop)", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
         "launches": used["shim:banded_fir"], **_nums(cmp["hist"])},
        {"name": "decim_fir (history form, AM stage 1 (868, /250))", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
         "launches": used["am:banded_fir"], **_nums(cmp["hist_am1"])},
        {"name": "decim_fir (history form, AM stage 2 (46, /2))", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
         "launches": used["am:banded_fir"], **_nums(cmp["hist_am2"])},
        {"name": "decim_fir (history form, digital stage (728, /12))", "route": "cuda", "source": src + "decim_fir.cu",
         "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
         "launches": used["digital:banded_fir"], **_nums(cmp["hist_digital"])},
        {"name": "fm_fused", "route": "cuda", "source": src + "fm_fused.cu",
         "replaces": "tpusdr/kernels/fm_pallas.py:205",
         "launches": used["fused_fm_demod"], **_nums(cmp["fm"])},
        {"name": "fir_decim", "route": "cuda", "source": src + "fir_poly.cu",
         "replaces": "tpusdr/kernels/fir_pallas.py:119",
         "launches": used["graph:fir_decim"], **_nums(cmp["k4_graph"])},
        {"name": "fir_decim (AM K4 runner stage 1 (868, /250))", "route": "cuda", "source": src + "fir_poly.cu",
         "replaces": "tpusdr/kernels/fir_pallas.py:119",
         "launches": used["fir_decim"] // 2, **_nums(cmp["k4_250"])},
        {"name": "fir_decim (AM K4 runner stage 2 (46, /2))", "route": "cuda", "source": src + "fir_poly.cu",
         "replaces": "tpusdr/kernels/fir_pallas.py:119",
         "launches": used["fir_decim"] // 2, **_nums(cmp["k4_2"])},
        {"name": "copy_floor", "route": "cuda", "source": src + "copy_floor.cu",
         "replaces": "benchmarks/kernel_floor_probe.py:336",
         "launches": used["probe:copy_floor"], **_nums(cmp[f"k5_{TICK}_best"])},
        {"name": "staged_add_one", "route": "cuda", "source": src + "staging_probes.cu",
         "replaces": "benchmarks/pallas_mosaic_probes.py:55",
         "launches": used["staged_add_one"], **_nums(cmp["k6"])},
        {"name": "staged_window_double", "route": "cuda", "source": src + "staging_probes.cu",
         "replaces": "benchmarks/pallas_mosaic_probes.py:76",
         "launches": used["staged_window_double"], **_nums(cmp["k7"])},
        {"name": "staged_shift_sum", "route": "cuda", "source": src + "staging_probes.cu",
         "replaces": "benchmarks/pallas_mosaic_probes.py:96",
         "launches": used["staged_shift_sum"], **_nums(cmp["k8"])},
        # phase 12: the kernels at the shard shapes of the sharded paths
        {"name": "decim_fir (history form, WBFM a shard of 8 stagewise, M=3,211)", "route": "cuda",
         "source": src + "decim_fir.cu", "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
         "launches": used["shard:banded_fir"], **_nums(shard_cmp["k1_stagewise"])},
        {"name": "decim_fir (history form, WBFM a shard of 8 chain-wide, M=4,000)", "route": "cuda",
         "source": src + "decim_fir.cu", "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
         "launches": used["shard:banded_fir_chainwide"], **_nums(shard_cmp["k1_chainwide"])},
        {"name": "decim_fir (prelude form, WBFM fused a shard of 2, M=26,624)", "route": "cuda",
         "source": src + "decim_fir.cu", "replaces": "tpusdr/kernels/fir_banded_pallas.py:604",
         "launches": used["shard:banded_fir_prelude"], **_nums(shard_cmp["k2_shard"])},
        {"name": "fm_fused (channel form, nbfm.capture C=57, M=19,375)", "route": "cuda",
         "source": src + "fm_fused.cu", "replaces": "tpusdr/kernels/fm_pallas.py:205",
         "launches": cmp["fm_channels"]["launches"], **_nums(cmp["fm_channels"])},
        {"name": "fm_fused (NBFM a shard of 8, M=2,513)", "route": "cuda", "source": src + "fm_fused.cu",
         "replaces": "tpusdr/kernels/fm_pallas.py:205",
         "launches": used["shard:fused_fm_demod"], **_nums(shard_cmp["k3_shard"])},
        {"name": "fir_decim (JSON graph a shard of 8 chain-wide, M=4,000)", "route": "cuda", "source": src + "fir_poly.cu",
         "replaces": "tpusdr/kernels/fir_pallas.py:119",
         "launches": used["shard:fir_decim"], **_nums(shard_cmp["k4_shard"])},
    ]
    # the batched resampler at each phase 2 shape, with the launches of the
    # main path that runs it there (phases 3 and 4, and the paths phase 4
    # adds for the capture cells' chains and the live block)
    for key, label, U, D, rows, N, use in RESAMPLE_CELLS:
        kern.append({"name": f"resample_poly ({label}, {U}/{D}, {rows} rows of {N:,})", "route": "cuda",
                     "source": src + "resample_poly.cu",
                     "replaces": "none: port only (plain version tpusdr_torch/ops/resample.py _resample_real)",
                     "launches": used[use], **_nums(cmp[key])})
    # phase 14: K1 on bench_scaling's time mode at each shard shape, and
    # once a replay under scan_marginal at the whole tick's
    for key, r in scaling_cmp.items():
        form, shards = key.rsplit("_s", 1)
        kern.append({"name": f"decim_fir (history form, bench_scaling --mode time {form[5:]}, S={shards}, "
                             f"M={r['M']:,})", "route": "cuda", "source": src + "decim_fir.cu",
                     "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
                     "launches": used[f"scaling:{key}"], **_nums(r)})
    kern.append({"name": "decim_fir (history form, scan_marginal over the captured WBFM tick)", "route": "cuda",
                 "source": src + "decim_fir.cu", "replaces": "tpusdr/kernels/fir_banded_pallas.py:243",
                 "launches": used["scan:banded_fir"], **_nums(cmp["hist"])})
    for row in kern:
        check(row["launches"] > 0, f"{row['name']}: not launched on its main path")
    # every phase 2 row's bound at K5's best rate in this run (the floor
    # probe's ceiling at the 1,280,000-sample tick) beside its bound at peak
    k5_gbps = max(line["dma_gbps"] for line in main_runs["floor_probe"] if "dma_gbps" in line and line["ok"])
    report["bounds_at_k5_rate"] = {
        key: {"kernel_us": r["ms"] * 1e3, "bound_peak_us": r["bound_ms"] * 1e3,
              "bound_k5_us": r["bytes"] / (k5_gbps * 1e3), "bound_by": r["bound_by"]}
        for key, r in cmp.items()
    }
    print(f"phase 11 bounds at K5's rate ({k5_gbps:.1f} GB/s in): " + json.dumps(report["bounds_at_k5_rate"]), flush=True)
    report.update(kernels=kern, compare=cmp, shard_compare=shard_cmp, scaling_compare=scaling_cmp, main=main_runs)
    (OUT_DIR / "chip_smoke_last.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kern}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _nums(res: dict) -> dict:
    return {k: res[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}


if __name__ == "__main__":
    sys.exit(main())
