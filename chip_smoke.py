#!/usr/bin/env python3
"""Write the kernel table of tpusdr_torch on one NVIDIA GPU: each CUDA
kernel against its plain PyTorch version, with its time and its bound.

    python3 chip_smoke.py

The card tests hold the paths on the card (each receiver, app, runner and
sharded stream against the CPU, and each kernel's launches a tick on its
main paths):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This script measures the kernels alone.  Its phases keep the numbers they
had when it also drove the paths, which the card tests now hold (each
prints lines; any failure exits non-zero):

  1. the card (nvidia-smi name and power limit), the kernel build time and
     the host library's (``tpusdr_torch/io/csrc/host_ring.cpp``);
  2. each kernel at the main paths' shapes, with the plan its rule picks:
     K1 (history form) at the WBFM (546, /50), the single-stage AM (6665,
     /500), the AM CLI's two stages (868, /250) and (46, /2) and the
     digital app's (728, /12); K2 (prelude form) at (546, /50) and a
     three-part (2500, /8); K3 at NBFM 2 Msps (728, /66), in its channel
     form at the ``nbfm.capture`` cell's shape (57 channels, M = 19,375,
     random carried phases: one launch in the shared form, 57 rows) and at the single-stage
     NBFM 20 Msps (9660, /666); K4 through the streaming call at the AM
     shapes, (6665, /500) and the JSON graph's (546, /50), also on ticks
     that rotate past the L2 cache; R1 (``resample_poly``) at every shape
     a main path launches it (``RESAMPLE_CELLS``: one launch, the rows
     counted, the carry bit for bit); K5 at ticks of 1,280,000 and
     2,048,000 samples, n_split 1 and the best of 2/5/10 (checked: one
     block on every SM, resident, each span in flight at once, under the
     card's peak), from device memory and on one fixed tick, beside a read
     yardstick (``torch.sum`` over the same rotating ticks); K6-K8 at the
     probes' shapes, also with the plan their rule picks from device
     memory, beside the timer's trivial launch;
  6. the floor probe (``benchmarks.kernel_floor_probe``) at the
     1,280,000-sample tick and the staging probes W4, X1 and X2 through
     their entry points, their launches counted;
 12. K1, K2, K3 and K4 at the shard shapes of the sharded paths
     (``tpusdr_torch.parallel``): K1 at a shard of 1, 2, 4 and 8 of the
     20 Msps tick, chain-wide and stagewise (``bench_scaling --mode
     time``; the sharded WBFM receiver at 8), K2 at a shard of 2 of the
     fused receiver's 2,560,000-sample tick, K3 at a shard of 8 of the NBFM
     2 Msps tick and K4 at a shard of 8 chain-wide (the JSON graph);
 11. every phase 2 row's bound at K5's best rate in this run (the floor
     probe's ceiling) beside its bound at the peak, a JSON line of the
     kernels, the card line and the result line (printed last).

Each row: the kernel's device time and its plain version's (CUDA events,
in turns plain, kernel, kernel, plain), its error (within ``KERNEL_TOL``
of the plain version's peak; K5-K8 exact), its bound from
``sdrbench/roofline.py`` (the least time of the work its shape needs:
``decim_fir_work`` for K1, K2 and K4, ``fm_fused_work`` for K3,
``resampler_work`` for R1, the bytes each probe moves for K5-K8), and
where one PyTorch call computes the same function (``conv1d`` for the
FIR kernels, a contiguous slice, ``add``, ``mul``, ``conv2d``), that
call's time: a yardstick the port never calls.  Needs a CUDA device, nvcc
and a host C++ compiler; builds the kernels and the host library (phase
1) into build/tpusdr_torch/.
"""

from __future__ import annotations

import itertools
import json
import sys
import time

import numpy as np

KERNEL_TOL = 1e-5  # max |kernel - plain| / max |plain|: fp32 both, sum order differs
TICK = 1_280_000
FM_F1_TILE = 8  # filtered samples a block of FM-fused at (9660, /666), M = 625: 90 blocks where 16 gave 42


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def compare(torch, card, name, kernel_fn, plain_fn, counter, n_bytes, n_ops,
            library_fn=None, library_view=None, timed_fn=None, exact=False, phase="phase 2"):
    """Kernel against plain on the same inputs; times in turns
    (plain, kernel, kernel, plain).  ``timed_fn`` replaces ``kernel_fn`` in
    the timed loops (rotating inputs).  ``library_fn`` is one PyTorch call
    computing the same function (``library_view`` turns its result into
    the plain version's layout): timed and held to the plain version, used
    nowhere else.  The bound is ``sdrbench.roofline``'s least time of
    (n_bytes, n_ops).  The launches made here leave the counter as it was."""
    from sdrbench import roofline
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
    by_bytes = n_bytes / roofline.PEAK_BYTES_PER_S >= n_ops / roofline.PEAK_FP32_FLOPS
    res = {
        "max_abs_err": diff,
        "rel_err": diff / peak,
        "ms": (k1 + k2) / 2,
        "plain_ms": (p1 + p2) / 2,
        "bound_ms": roofline.least_seconds(n_bytes, n_ops) * 1e3,
        "bound_by": "bytes" if by_bytes else "operations",
        "bytes": n_bytes,
        "operations": n_ops,
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
    """Every kernel of the run launched, exactly as often as expected."""
    for name, n in expected.items():
        check(counts[name] == n, f"{label}: {name} launched {counts[name]} times, expected {n}")


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


def kernel_phase(torch, card, dev) -> dict:
    """Phase 2: every kernel against its plain version."""
    from sdrbench.fm_fused_work import fm_fused_work
    from sdrbench.roofline import PEAK_BYTES_PER_S, decim_fir_work
    from tpusdr_torch import kernels
    from tpusdr_torch.benchmarks import plan_probe
    from tpusdr_torch.benchmarks import staging_probes as probes
    from tpusdr_torch.graph.blocks import FusedFmDemod
    from tpusdr_torch.kernels import build, copy_floor, fir_banded, fir_poly, fm_fused, staging_probes
    from tpusdr_torch.models import receiver
    from tpusdr_torch.ops import osc
    from tpusdr_torch.utils.profiling import device_ms

    rng = np.random.default_rng(1)

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
        *decim_fir_work(TICK + T - 1, T, TICK // D, True),
        **conv1d_fir(torch, torch.cat([hist, x]), ctaps, D, TICK // D),
    )
    s0 = 8 * G - (T - 1)
    cmp["prelude"] = compare(
        torch, card, "D-FIR prelude form T=546 D=50 N=1280000",
        lambda: fir_banded.banded_fir_prelude(x, pre, ctaps, D),
        lambda: fir_banded.decim_fir_plain(pre.reshape(-1), x, ctaps, D, s0, TICK // D),
        fir_banded.banded_fir_prelude,
        *decim_fir_work(TICK + 8 * G, T, TICK // D, True),
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
        *decim_fir_work(x3.shape[0] + 8 * G3, T3, x3.shape[0] // D3, True),
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
        *decim_fir_work(TICK + Ta - 1, Ta, TICK // Da, True),
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
            *decim_fir_work(L + Tb - 1, Tb, L // Db, cplx),
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
        *fm_fused_work(ext.shape[0], Tf, Mf, 1),
    )
    # the channel form at the nbfm.capture cell's shape: the 57 marine
    # channels every 25 kHz from -700 to +700 kHz, a station on each, on one
    # tick behind its carried (T-1) + D samples, each channel's carried
    # phase at random; the launch and channel-row counts from 0
    offsets_c, tick_c = [25e3 * k for k in range(-28, 29)], 1_278_750
    Cc = len(offsets_c)
    zc = sum(fm_signal(Hf + tick_c, 2e6, f, 5e3, seed=20 + j) for j, f in enumerate(offsets_c)) / Cc
    ext_c = torch.from_numpy(zc.astype(np.complex64)).to(dev)
    incs_c = torch.tensor([osc.freq_to_inc_u32(-f, 2e6) for f in offsets_c], dtype=torch.int64, device=dev)
    ph_c = osc.as_phases(rng.integers(0, 2**32, Cc).tolist(), dev)
    Mc = (ext_c.shape[0] - (Tf - 1)) // Df - 1
    fc_plan = fm_fused.fm_fused_plan(Tf, Df, Mc, Cc)
    fc_blocks = fm_fused.fm_fused_grid(Tf, Df, Mc, Cc, fc_plan)
    print(f"phase 2 FM-fused channel form at (728, /66), C={Cc}, M={Mc}: {fc_plan}, {fc_blocks} blocks",
          flush=True)
    check(Mc == 19_375 and fc_plan == fm_fused.FmFusedPlan("shared", fm_fused.PHASE_TILE, Tf),
          f"the nbfm.capture tick takes the shared form over {Cc} channels: M={Mc}, {fc_plan}")

    def channels_kernel():
        return fm_fused.fused_fm_demod(ext_c[Hf:], ftaps, Df, incs_c, ph_c, front.gain, history=ext_c[:Hf])

    kernels.reset_launch_counts()
    got_c = channels_kernel()
    torch.cuda.synchronize()
    counts_c = (fm_fused.fused_fm_demod.launches, fm_fused.fused_fm_demod.channel_rows,
                fm_fused.fused_fm_demod.shared_rows)
    check(counts_c == (1, Cc, Cc) and got_c.shape == (Cc, Mc),
          f"the channel form: (launches, channel rows, shared rows) {counts_c} and {tuple(got_c.shape)}, "
          f"expected (1, {Cc}, {Cc})")
    cmp["fm_channels"] = compare(
        torch, card, f"FM-fused channel form T=728 D=66 C={Cc} M={Mc} {fc_plan}",
        channels_kernel,
        lambda: fm_fused.fused_fm_demod_plain(ext_c, ftaps, Df, incs_c, ph_c, front.gain, Mc),
        fm_fused.fused_fm_demod,
        *fm_fused_work(ext_c.shape[0], Tf, Mc, Cc),
    )
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
        *fm_fused_work(ext_n.shape[0], Tn, Mn, 1),
    )
    b_n = cmp["fm_f1"]
    print(f"phase 2 FM-fused (9660, /666) M={Mn}: {b_n['ms'] * 1e3:.2f} us against a bound of "
          f"{b_n['bound_ms'] * 1e3:.2f} us ({b_n['bound_by']}: {b_n['bytes']} B, {b_n['operations']} operations)", flush=True)

    # K4 at its four shapes with the paths' own taps (the single-stage AM
    # stage with a low-pass of its width), through the streaming call: the
    # carried T-1 samples through the second pointer, then the tick
    am_chain, _ = receiver.am_receiver(20e6, 1.2e6, input_format="int8", fir_mode="pallas", fold_shift=False)
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
            *decim_fir_work(L + Tk - 1, Tk, Mk, False),
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
    peak_gbps = PEAK_BYTES_PER_S / 1e9
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
                  f"({r['gbps_in']:.1f} GB/s in, {r['gbps_moved']:.1f} GB/s moved, peak {peak_gbps:.0f}), "
                  f"{r['fixed_tick_ms'] * 1e3:.2f} us on one fixed tick; read yardstick (torch.sum, rotating) "
                  f"{r['read_yardstick_ms'] * 1e3:.2f} us; slice {r['library_ms'] * 1e3:.2f} us; "
                  f"bound {r['bound_ms'] * 1e3:.2f} us", flush=True)
            check(r["gbps_moved"] <= peak_gbps,
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
#: tick a row)
RESAMPLE_CELLS = [
    ("resample_nbfm", "nbfm.capture", 33, 125, 57, 19_375),
    ("resample_bank100", "bank100.capture", 6, 25, 100, 12_800),
    ("resample_wbfm", "wbfm.capture", 3, 25, 1, 25_600),
    ("resample_live", "wbfm.live", 3, 25, 1, 2_625),
    ("resample_nbfm2", "NBFM 2 Msps", 198, 125, 1, 20_000),
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
    for key, label, U, D, rows, N in RESAMPLE_CELLS:
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
        b = out[key]
        print(f"phase 2 resample_poly {label}: {b['ms'] * 1e3:.2f} us against a bound of {b['bound_ms'] * 1e3:.2f} us "
              f"({b['bound_by']}: {b['bytes']} B, {b['operations']} operations), plain {b['plain_ms'] * 1e3:.2f} us, "
              f"{b['rel_err']:.2g} of peak", flush=True)
    return out


def floor_phase(torch, card, dev) -> list:
    """Phase 6: the floor probe's arms at the 1,280,000-sample tick."""
    from tpusdr_torch import kernels
    from tpusdr_torch.benchmarks import kernel_floor_probe as probe

    reps = 20
    kernels.reset_launch_counts()
    lines = probe.floor_probe(dev, TICK, reps, "all",
                              emit=lambda kw: print(f"phase 6 floor probe [{card}]: " + json.dumps(kw), flush=True))
    check_path(path_counts(torch), "floor probe", probe.launches_expected(reps))
    for line in lines:
        check(line.get("ok", True), f"floor probe: {line}")
    metrics = {line["metric"] for line in lines if "metric" in line}
    want = {f"dma_floor_split{n}_msps" for n in probe.N_SPLITS} | {
        "kernel_prelude_msps", "kernel_hist1copy_msps", "kernel_nohist_msps",
        "kernel_concat2copy_msps", "kernel_prelude_noslice_msps"}
    check(metrics == want, f"floor probe printed {sorted(metrics)}")
    return lines


def staging_phase(torch, card, dev) -> list:
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
    check_path(path_counts(torch), "staging probes",
               {"staged_add_one": 2, "staged_window_double": 2, "staged_shift_sum": 2})
    return lines


def shard_rows(torch, card, dev) -> dict:
    """Phase 12: K1-K4 at the shard shapes of the sharded paths, each
    called directly at that shape against its plain version, the shard's
    halo and tick through the streaming call.  The halos are those of the
    paths' own ``TimeShardedStream`` objects, built and not run."""
    from sdrbench.fm_fused_work import fm_fused_work
    from sdrbench.roofline import decim_fir_work
    from tpusdr_torch.apps.bench_scaling import sharded_for
    from tpusdr_torch.kernels import fir_banded, fir_poly, fm_fused
    from tpusdr_torch.models import receiver
    from tpusdr_torch.ops import osc
    from tpusdr_torch.parallel import TimeShardedStream, make_mesh

    rng = np.random.default_rng(12)

    def crandn(n):
        return torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)).to(dev)

    def stage_halo(stream, name):
        return {n: h for n, _b, h, _s, _bs in stream._stages}[name]

    cmp = {}
    # K1 at bench_scaling --mode time's shard shapes; at 8 shards they are
    # the sharded WBFM receiver's (the same chain's halos)
    for shards in (1, 2, 4, 8):
        for form, stagewise in (("chain-wide", False), ("stagewise", True)):
            stream, tick = sharded_for("time", shards, 20e6, TICK, stagewise, dev)
            fir = stream.full_chain.get_block("shiftfir")
            ctaps, T, D = fir.mod_taps, fir.taps.shape[-1], fir.decimation
            halo = stage_halo(stream, "shiftfir") if stagewise else stream.halo
            n = tick // shards + halo
            x, hist, M = crandn(n), crandn(T - 1), n // D
            plan = fir_banded.decim_fir_plan(T, D, True, M)
            key = f"k1_{form}_s{shards}"
            cmp[key] = compare(
                torch, card, f"D-FIR history form T={T} D={D} N={n} (a shard of {shards}, {form}) {plan}",
                lambda x=x, hist=hist, ctaps=ctaps, D=D: fir_banded.banded_fir(x, ctaps, D, history=hist),
                lambda x=x, hist=hist, ctaps=ctaps, D=D, M=M: fir_banded.decim_fir_plain(hist, x, ctaps, D, 0, M),
                fir_banded.banded_fir, *decim_fir_work(n + T - 1, T, M, True),
                **conv1d_fir(torch, torch.cat([hist, x]), ctaps, D, M), phase="phase 12")
            cmp[key].update(M=M, shards=shards, form=form, halo=halo)
    # K2 at a shard of 2 of the fused receiver's 2,560,000-sample tick
    fused = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM, use_fused=True)[0]
    stream = TimeShardedStream(fused, make_mesh(2, device=dev), stagewise=True)
    front = fused.get_block("frontend")
    T, D = front.taps.shape[-1], front.decimation
    G, _ = fir_banded.prelude_plan(T, D)
    n2 = TICK + stage_halo(stream, "frontend")
    x2, pre = crandn(n2), crandn(8 * G).reshape(8, G)
    cmp["k2_shard"] = compare(
        torch, card, f"D-FIR prelude form T={T} D={D} N={n2} (a shard of 2)",
        lambda: fir_banded.banded_fir_prelude(x2, pre, front.mod_taps, D),
        lambda: fir_banded.decim_fir_plain(pre.reshape(-1), x2, front.mod_taps, D, 8 * G - (T - 1), n2 // D),
        fir_banded.banded_fir_prelude, *decim_fir_work(n2 + 8 * G, T, n2 // D, True),
        **conv1d_fir(torch, torch.cat([pre.reshape(-1), x2])[8 * G - (T - 1):], front.mod_taps, D, n2 // D),
        phase="phase 12")
    # K3 at a shard of 8 of the NBFM 2 Msps tick, a shard's phase just short
    # of the wrap
    nb_chain = receiver.fm_receiver(2e6, 100e3, receiver.NBFM, use_fused=True)[0]
    stream = TimeShardedStream(nb_chain, make_mesh(8, device=dev))
    nb_front = nb_chain.get_block("frontend")
    Tf, Df = nb_front.taps.shape[-1], nb_front.decimation
    Hf = (Tf - 1) + Df
    n3 = nb_chain.granule * 160 // 8 + stage_halo(stream, "frontend")
    ext = torch.from_numpy(fm_signal(Hf + n3, 2e6, 100e3, 5e3, seed=12)).to(dev)
    ph = osc.as_phase(0xFFFFFF00, dev)
    M3 = (ext.shape[0] - (Tf - 1)) // Df - 1
    plan3 = fm_fused.fm_fused_plan(Tf, Df, M3)
    print(f"phase 12 FM-fused plan at ({Tf}, /{Df}), shard M={M3}: {plan3}, {fm_fused.fm_fused_blocks(M3, plan3)} blocks",
          flush=True)
    cmp["k3_shard"] = compare(
        torch, card, f"FM-fused T={Tf} D={Df} M={M3} (a shard of 8) {plan3}",
        lambda: fm_fused.fused_fm_demod(ext[Hf:], nb_front.taps, Df, nb_front.inc, ph, nb_front.gain, history=ext[:Hf]),
        lambda: fm_fused.fused_fm_demod_plain(ext, nb_front.taps, Df, nb_front.inc, ph, nb_front.gain, M3),
        fm_fused.fused_fm_demod, *fm_fused_work(ext.shape[0], Tf, M3, 1), phase="phase 12")
    # K4 at a shard of 8 chain-wide: the JSON graph is the WBFM receiver,
    # so its chain-wide halo is the WBFM chain's
    rfir = receiver.fm_receiver(20e6, 2.5e6, receiver.WBFM)[0].get_block("shiftfir")
    rtaps, T, D = rfir.taps.to(dev), rfir.taps.shape[-1], rfir.decimation
    n4 = TICK // 8 + cmp["k1_chain-wide_s8"]["halo"]
    x4, h4, M4 = crandn(n4), crandn(T - 1), n4 // D
    plan4 = fir_poly.fir_decim_plan(T, D, M4)
    print(f"phase 12 K4 plan at ({T}, /{D}), shard M={M4}: {plan4}, {fir_poly.fir_decim_blocks(M4, plan4)} blocks",
          flush=True)
    cmp["k4_shard"] = compare(
        torch, card, f"K4 fir_decim T={T} D={D} N={n4} (a shard of 8) {plan4}",
        lambda: fir_poly.fir_decim(x4, rtaps, D, history=h4),
        lambda: fir_poly.fir_decim_plain(x4, rtaps, D, M4, h4),
        fir_poly.fir_decim, *decim_fir_work(n4 + T - 1, T, M4, False),
        **conv1d_fir(torch, torch.cat([h4, x4]), rtaps, D, M4), phase="phase 12")
    return cmp


#: the kernel JSON line's rows: (name, source under kernels/csrc/, the TPU
#: kernel it ports, the phase 2 or phase 12 comparison)
K1, K2 = "tpusdr/kernels/fir_banded_pallas.py:243", "tpusdr/kernels/fir_banded_pallas.py:604"
K3, K4 = "tpusdr/kernels/fm_pallas.py:205", "tpusdr/kernels/fir_pallas.py:119"
R1 = "none: port only (plain version tpusdr_torch/ops/resample.py _resample_real)"
KERNEL_ROWS = [
    ("decim_fir (history form)", "decim_fir.cu", K1, "hist"),
    ("decim_fir (prelude form)", "decim_fir.cu", K2, "prelude"),
    ("decim_fir (history form, AM stage 1 (868, /250))", "decim_fir.cu", K1, "hist_am1"),
    ("decim_fir (history form, AM stage 2 (46, /2))", "decim_fir.cu", K1, "hist_am2"),
    ("decim_fir (history form, digital stage (728, /12))", "decim_fir.cu", K1, "hist_digital"),
    ("fm_fused", "fm_fused.cu", K3, "fm"),
    ("fm_fused (channel form, nbfm.capture C=57, M=19,375)", "fm_fused.cu", K3, "fm_channels"),
    ("fir_decim", "fir_poly.cu", K4, "k4_graph"),
    ("fir_decim (AM K4 runner stage 1 (868, /250))", "fir_poly.cu", K4, "k4_250"),
    ("fir_decim (AM K4 runner stage 2 (46, /2))", "fir_poly.cu", K4, "k4_2"),
    ("copy_floor", "copy_floor.cu", "benchmarks/kernel_floor_probe.py:336", f"k5_{TICK}_best"),
    ("staged_add_one", "staging_probes.cu", "benchmarks/pallas_mosaic_probes.py:55", "k6"),
    ("staged_window_double", "staging_probes.cu", "benchmarks/pallas_mosaic_probes.py:76", "k7"),
    ("staged_shift_sum", "staging_probes.cu", "benchmarks/pallas_mosaic_probes.py:96", "k8"),
    *[(f"resample_poly ({label}, {U}/{D}, {rows} rows of {N:,})", "resample_poly.cu", R1, key)
      for key, label, U, D, rows, N in RESAMPLE_CELLS],
    ("decim_fir (prelude form, WBFM fused a shard of 2, M=26,624)", "decim_fir.cu", K2, "k2_shard"),
    ("fm_fused (NBFM a shard of 8, M=2,513)", "fm_fused.cu", K3, "k3_shard"),
    ("fir_decim (JSON graph a shard of 8 chain-wide, M=4,000)", "fir_poly.cu", K4, "k4_shard"),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from sdrbench.run import card_line
    from tpusdr_torch.io import native
    from tpusdr_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    # -- phase 1: card and build ---------------------------------------------
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.get_lib()
    host_build_s = time.perf_counter() - t0
    print(f"phase 1: card {card!r}, device {torch.cuda.get_device_name(0)!r}, "
          f"kernels built in {build_s:.1f} s, the host library in {host_build_s:.1f} s", flush=True)

    cmp = kernel_phase(torch, card, dev)  # phase 2
    floor_lines = floor_phase(torch, card, dev)  # phase 6
    staging_phase(torch, card, dev)
    rows = {**cmp, **shard_rows(torch, card, dev)}  # phase 12

    # -- phase 11: report -------------------------------------------------------
    src = "tpusdr_torch/kernels/csrc/"
    kern = [{"name": name, "route": "cuda", "source": src + cu, "replaces": ported, **_nums(rows[key])}
            for name, cu, ported, key in KERNEL_ROWS]
    kern += [{"name": f"decim_fir (history form, a shard of {r['shards']} {r['form']}, M={r['M']:,})", "route": "cuda",
              "source": src + "decim_fir.cu", "replaces": K1, **_nums(r)}
             for key, r in rows.items() if key.startswith("k1_")]
    # every phase 2 row's bound at K5's best rate in this run (the floor
    # probe's ceiling at the 1,280,000-sample tick) beside its bound at peak
    k5_gbps = max(line["dma_gbps"] for line in floor_lines if "dma_gbps" in line and line["ok"])
    at_k5 = {key: {"kernel_us": r["ms"] * 1e3, "bound_peak_us": r["bound_ms"] * 1e3,
                   "bound_k5_us": r["bytes"] / (k5_gbps * 1e3), "bound_by": r["bound_by"]}
             for key, r in cmp.items()}
    print(f"phase 11 bounds at K5's rate ({k5_gbps:.1f} GB/s in): " + json.dumps(at_k5), flush=True)
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
