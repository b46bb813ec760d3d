"""FIR filter design: Parks-McClellan (Remez exchange) + Kaiser window.

TPU-native replacement for the reference's external C dependency
kernrj/remez-exchange (`remezGenerateLowPassTaps`,
`remezGenerateSingleBandPassTaps` — used by
cuda-sdr src/filters/factories/RfToPcmAudioFactory.cpp:87-110 and
src/applications/am_test.cpp:176-195).  Includes the same two tap-count
estimators (Bellanger and Fred Harris, RfToPcmAudioFactory.cpp:30-47) and the
same retry ladder over candidate tap counts (RfToPcmAudioFactory.cpp:66-105),
with a Kaiser-window design as the final fallback (the reference apps carry a
`kaiserWindowLength` helper for the same purpose, nbfm_test.cpp:87-93).

All of this is host-side NumPy: tap design happens once at graph-build time,
never on the TPU hot path.
"""

from __future__ import annotations

import math

import numpy as np

from tpusdr_torch.utils.logging import get_logger

log = get_logger("design")

# ---------------------------------------------------------------------------
# Tap-count estimators (parity with RfToPcmAudioFactory.cpp:30-47)
# ---------------------------------------------------------------------------


def bellanger_tap_count(
    sample_rate: float,
    transition_width: float,
    passband_ripple: float = 0.01,
    db_attenuation: float = -60.0,
) -> int:
    """Bellanger's FIR length estimate.

    Mirrors bellangerLowPassTapCount (RfToPcmAudioFactory.cpp:30-42):
    N ~= 2/3 * log10(1/(10*d1*d2)) * fs/df   with d2 = 10^(A/10).
    """
    sigma1 = 10.0 ** (passband_ripple / 10.0)
    sigma2 = 10.0 ** (db_attenuation / 10.0)
    log_val = math.log10(1.0 / (10.0 * sigma1 * sigma2))
    return int(math.ceil(2.0 / 3.0 * log_val * sample_rate / transition_width))


def fred_harris_tap_count(
    db_attenuation: float, transition_width: float, sample_rate: float
) -> int:
    """fred harris' estimate: N ~= A / (22 * df/fs).

    Mirrors fredHarrisLowPassTapCount (RfToPcmAudioFactory.cpp:44-47).
    """
    norm_tw = transition_width / sample_rate
    return int(math.ceil(-db_attenuation / (22.0 * norm_tw)))


def kaiser_beta(atten_db: float) -> float:
    """Kaiser window beta for a given stop-band attenuation (positive dB)."""
    a = abs(atten_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_tap_count(atten_db: float, transition_width: float, sample_rate: float) -> int:
    """Kaiser's length formula N ~= (A - 8) / (2.285 * 2pi * df/fs).

    Same role as kaiserWindowLength (nbfm_test.cpp:87-93).
    """
    a = abs(atten_db)
    norm_tw = 2.0 * math.pi * transition_width / sample_rate
    n = int(math.ceil((a - 8.0) / (2.285 * norm_tw))) + 1
    return max(n, 3)


# ---------------------------------------------------------------------------
# Kaiser-window lowpass/bandpass design (robust fallback)
# ---------------------------------------------------------------------------


def _sinc_lowpass(num_taps: int, cutoff_norm: float) -> np.ndarray:
    """Ideal lowpass impulse response, cutoff in cycles/sample (0..0.5)."""
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    return 2.0 * cutoff_norm * np.sinc(2.0 * cutoff_norm * n)


def window(name: str, num_taps: int, beta: float = 8.6) -> np.ndarray:
    """Named window functions (the reference ships a Hamming window helper,
    src/util/Window.cpp:23-31)."""
    name = name.lower()
    if name == "hamming":
        return np.hamming(num_taps)
    if name in ("hann", "hanning"):
        return np.hanning(num_taps)
    if name == "blackman":
        return np.blackman(num_taps)
    if name == "kaiser":
        return np.kaiser(num_taps, beta)
    if name in ("rect", "rectangular", "boxcar"):
        return np.ones(num_taps)
    raise ValueError(f"unknown window {name!r}")


def kaiser_lowpass(
    sample_rate: float,
    cutoff: float,
    transition_width: float,
    db_attenuation: float = -60.0,
    num_taps: int | None = None,
) -> np.ndarray:
    """Windowed-sinc lowpass with a Kaiser window. Returns float64 taps."""
    if num_taps is None:
        num_taps = kaiser_tap_count(db_attenuation, transition_width, sample_rate)
    beta = kaiser_beta(db_attenuation)
    # Place the cutoff mid-transition, matching firwin convention.
    fc = (cutoff + transition_width / 2.0) / sample_rate
    fc = min(max(fc, 1e-6), 0.5 - 1e-6)
    h = _sinc_lowpass(num_taps, fc)
    h *= np.kaiser(num_taps, beta)
    return h / np.sum(h)


def kaiser_bandpass(
    sample_rate: float,
    low_cutoff: float,
    high_cutoff: float,
    transition_width: float,
    db_attenuation: float = -60.0,
    num_taps: int | None = None,
) -> np.ndarray:
    if num_taps is None:
        num_taps = kaiser_tap_count(db_attenuation, transition_width, sample_rate)
    if num_taps % 2 == 0:
        num_taps += 1  # bandpass needs Type I symmetry
    beta = kaiser_beta(db_attenuation)
    f_lo = max(low_cutoff - transition_width / 2.0, 1e-6) / sample_rate
    f_hi = min(high_cutoff + transition_width / 2.0, sample_rate / 2 - 1e-6) / sample_rate
    h = _sinc_lowpass(num_taps, f_hi) - _sinc_lowpass(num_taps, f_lo)
    h *= np.kaiser(num_taps, beta)
    # Normalize center-of-band gain to 1.
    fc = (f_lo + f_hi) / 2.0
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    gain = np.abs(np.sum(h * np.exp(-2j * np.pi * fc * n)))
    return h / gain


# ---------------------------------------------------------------------------
# Remez exchange (Parks-McClellan)
# ---------------------------------------------------------------------------


class RemezError(RuntimeError):
    pass


def remez(
    num_taps: int,
    bands: np.ndarray,
    desired: np.ndarray,
    weights: np.ndarray | None = None,
    grid_density: int = 16,
    max_iter: int = 100,
) -> np.ndarray:
    """Parks-McClellan optimal equiripple FIR design.

    Args:
      num_taps: filter length (Type I odd / Type II even supported).
      bands: (nbands, 2) edges in cycles/sample, ascending, within [0, 0.5].
      desired: (nbands,) desired amplitude per band.
      weights: (nbands,) relative error weight per band.

    Returns float64 taps of length ``num_taps`` (linear phase, symmetric).

    In-repo implementation of the role played by kernrj/remez-exchange in the
    reference (RfToPcmAudioFactory.cpp:89-110). Barycentric-form exchange as
    in the classic McClellan-Parks-Rabiner program.
    """
    bands = np.asarray(bands, dtype=np.float64).reshape(-1, 2)
    desired = np.asarray(desired, dtype=np.float64)
    if weights is None:
        weights = np.ones(len(bands))
    weights = np.asarray(weights, dtype=np.float64)
    if num_taps < 3:
        raise RemezError("num_taps must be >= 3")

    odd = num_taps % 2 == 1
    # r = number of approximating cosine terms.
    r = (num_taps + 1) // 2 if odd else num_taps // 2

    # --- dense frequency grid over the union of bands -----------------------
    grid_size = max(grid_density * r, 256)
    band_widths = bands[:, 1] - bands[:, 0]
    total_width = band_widths.sum()
    segs: list[np.ndarray] = []
    seg_of: list[np.ndarray] = []
    d_parts: list[np.ndarray] = []
    w_parts: list[np.ndarray] = []
    for bi, ((lo, hi), bw, d, w) in enumerate(zip(bands, band_widths, desired, weights)):
        n = max(int(round(grid_size * bw / total_width)), 8)
        g = np.linspace(lo, hi, n)
        if not odd:
            g = g[g < 0.5 - 1e-9]  # Type II: A(0.5)=0 structurally
            if len(g) == 0:
                continue
        segs.append(g)
        seg_of.append(np.full(len(g), bi))
        d_parts.append(np.full(len(g), d))
        w_parts.append(np.full(len(g), w))
    grid = np.concatenate(segs)
    seg_id = np.concatenate(seg_of)
    d_grid = np.concatenate(d_parts)
    w_grid = np.concatenate(w_parts)

    if not odd:
        # Transform desired/weight so we design P(f) = A(f)/cos(pi f).
        c = np.cos(np.pi * grid)
        d_grid = d_grid / c
        w_grid = w_grid * c

    next_ = r + 1  # number of extremal frequencies
    if len(grid) < next_ + 2:
        raise RemezError("grid too small for requested tap count")

    # Initial extremal guess: equally spaced over the grid.
    ext_idx = np.round(np.linspace(0, len(grid) - 1, next_)).astype(np.int64)

    x_grid = np.cos(2.0 * np.pi * grid)

    last_delta = None
    for _ in range(max_iter):
        xe = x_grid[ext_idx]
        de = d_grid[ext_idx]
        we = w_grid[ext_idx]

        # Barycentric weights gamma_i = 1 / prod_{j != i} (x_i - x_j),
        # computed in log space for stability.
        diff = xe[:, None] - xe[None, :]
        np.fill_diagonal(diff, 1.0)
        if np.any(diff == 0.0):
            raise RemezError("degenerate extremal set (duplicate frequencies)")
        sign = np.prod(np.sign(diff), axis=1)
        logg = -np.sum(np.log(np.abs(diff)), axis=1)
        logg -= logg.max()  # common scale cancels in the ratios below
        gamma = sign * np.exp(logg)

        alt = (-1.0) ** np.arange(next_)
        delta = np.sum(gamma * de) / np.sum(gamma * alt / we)
        if delta == 0.0 or not np.isfinite(delta):
            raise RemezError("Remez delta degenerate")

        # Values of P at the first r extremal points.
        ce = de - alt * delta / we  # length next_; use first r for interp
        xi = xe[:r]
        ci = ce[:r]
        # Barycentric interpolation weights over the r-subset.
        diff_r = xi[:, None] - xi[None, :]
        np.fill_diagonal(diff_r, 1.0)
        sign_r = np.prod(np.sign(diff_r), axis=1)
        logb = -np.sum(np.log(np.abs(diff_r)), axis=1)
        logb -= logb.max()
        beta = sign_r * np.exp(logb)

        # Evaluate error on the whole grid.
        dx = x_grid[:, None] - xi[None, :]
        exact = np.isclose(dx, 0.0, atol=1e-14)
        with np.errstate(divide="ignore", invalid="ignore"):
            k = beta[None, :] / dx
            p = np.sum(k * ci[None, :], axis=1) / np.sum(k, axis=1)
        hit = exact.any(axis=1)
        if hit.any():
            p[hit] = ci[exact[hit].argmax(axis=1)]
        err = w_grid * (d_grid - p)

        # --- find new extremal set: local extrema of the error --------------
        # Candidates: per band segment, local maxima/minima of err, with
        # segment endpoints always eligible (band edges are extremal in the
        # optimal solution).
        cand: list[int] = []
        n_grid = len(err)
        for i in range(n_grid):
            first = i == 0 or seg_id[i] != seg_id[i - 1]
            last = i == n_grid - 1 or seg_id[i] != seg_id[i + 1]
            left_ok = first or (
                err[i] >= err[i - 1] if err[i] > 0 else err[i] <= err[i - 1]
            )
            right_ok = last or (
                err[i] >= err[i + 1] if err[i] > 0 else err[i] <= err[i + 1]
            )
            if left_ok and right_ok:
                cand.append(i)

        # Enforce sign alternation: among consecutive same-sign candidates
        # keep the one with the largest |err|.
        sign_err = np.where(err >= 0, 1.0, -1.0)
        kept: list[int] = []
        for i in cand:
            if kept and sign_err[i] == sign_err[kept[-1]]:
                if abs(err[i]) > abs(err[kept[-1]]):
                    kept[-1] = int(i)
            else:
                kept.append(int(i))

        # Trim to exactly next_ extremals, dropping the weakest endpoint(s).
        while len(kept) > next_:
            if abs(err[kept[0]]) <= abs(err[kept[-1]]):
                kept.pop(0)
            else:
                kept.pop()

        if len(kept) < next_:
            raise RemezError(
                f"lost alternation: only {len(kept)} extrema for order needing {next_}"
            )

        new_idx = np.array(kept, dtype=np.int64)
        converged = np.array_equal(new_idx, ext_idx)
        ext_idx = new_idx
        if converged or (
            last_delta is not None
            and abs(abs(delta) - abs(last_delta)) < 1e-12 * max(abs(delta), 1e-30)
        ):
            break
        last_delta = delta
    else:
        log.debug("remez: max_iter reached without convergence (delta=%g)", delta)

    # --- compute taps from P sampled on a uniform frequency grid ------------
    # A(f) = sum_{k<r} a_k cos(2 pi k f)  (Type I)
    # A(f) = cos(pi f) * P(f)             (Type II)
    m = num_taps
    fs_eval = np.arange(r) / m  # r uniform points in [0, 0.5)
    x_eval = np.cos(2.0 * np.pi * fs_eval)
    dx = x_eval[:, None] - xe[:r][None, :]
    exact = np.isclose(dx, 0.0, atol=1e-14)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = beta[None, :] / dx
        p_eval = np.sum(k * ce[:r][None, :], axis=1) / np.sum(k, axis=1)
    hit = exact.any(axis=1)
    if hit.any():
        p_eval[hit] = ce[:r][exact[hit].argmax(axis=1)]

    if odd:
        a_eval = p_eval
        # h[n] via inverse DFT of the real, even amplitude response.
        n = np.arange((m - 1) // 2 + 1)
        h_half = np.zeros(len(n))
        for i, nn in enumerate(n):
            h_half[i] = (
                a_eval[0]
                + 2.0 * np.sum(a_eval[1:] * np.cos(2.0 * np.pi * np.arange(1, r) * nn / m))
            ) / m
        h = np.concatenate([h_half[::-1], h_half[1:]])
    else:
        a_eval = p_eval * np.cos(np.pi * fs_eval)
        # Type II: A(f) = sum_{n=1}^{m/2} b_n cos(2 pi (n - 1/2) f).
        # Recover h by sampling A at m points and least-squares/IDFT.
        fgrid = np.arange(m) / (2.0 * m)  # m points in [0, 0.5)
        dxg = np.cos(2.0 * np.pi * fgrid)[:, None] - xe[:r][None, :]
        exg = np.isclose(dxg, 0.0, atol=1e-14)
        with np.errstate(divide="ignore", invalid="ignore"):
            kg = beta[None, :] / dxg
            pg = np.sum(kg * ce[:r][None, :], axis=1) / np.sum(kg, axis=1)
        hitg = exg.any(axis=1)
        if hitg.any():
            pg[hitg] = ce[:r][exg[hitg].argmax(axis=1)]
        ag = pg * np.cos(np.pi * fgrid)
        half = m // 2
        nn = np.arange(1, half + 1)
        basis = np.cos(2.0 * np.pi * np.outer(fgrid, nn - 0.5))
        b, *_ = np.linalg.lstsq(basis, ag, rcond=None)
        h = np.concatenate([b[::-1] / 2.0, b / 2.0])

    if not np.all(np.isfinite(h)):
        raise RemezError("non-finite taps")
    return h


# ---------------------------------------------------------------------------
# High-level design entry points (parity with remezGenerateLowPassTaps et al.)
# ---------------------------------------------------------------------------


def _try_ladder(design_fn, try_lengths, fallback_fn) -> np.ndarray:
    """Retry ladder over candidate tap counts, mirroring
    RfToPcmAudioFactory.cpp:66-105, with a Kaiser fallback."""
    last_err: Exception | None = None
    for n in try_lengths:
        if n < 8:
            continue
        try:
            taps = design_fn(int(n))
            log.debug("remez succeeded with %d taps", n)
            return taps
        except (RemezError, np.linalg.LinAlgError) as e:  # keep trying
            log.debug("remez failed with %d taps: %s", n, e)
            last_err = e
    log.warning("remez ladder exhausted (%s); falling back to Kaiser design", last_err)
    return fallback_fn()


def lowpass_taps(
    sample_rate: float,
    cutoff: float,
    transition_width: float,
    db_attenuation: float = -60.0,
    dtype=np.float32,
) -> np.ndarray:
    """Design lowpass taps: Remez with the reference's candidate-length ladder
    (fred harris, Bellanger, then halves — RfToPcmAudioFactory.cpp:66-76),
    Kaiser-window fallback. Returns taps in natural (convolution) order."""
    fh = fred_harris_tap_count(db_attenuation, transition_width, sample_rate)
    bl = bellanger_tap_count(sample_rate, transition_width, 0.01, db_attenuation)
    ladder = [fh, bl, fh // 2, bl // 2]

    f_pass = cutoff / sample_rate
    f_stop = (cutoff + transition_width) / sample_rate
    if not 0 < f_pass < f_stop <= 0.5:
        raise ValueError(
            f"invalid lowpass spec: cutoff={cutoff}, transition={transition_width}, "
            f"fs={sample_rate}"
        )
    # Weight stopband by the ripple ratio implied by the attenuation spec.
    delta_stop = 10.0 ** (-abs(db_attenuation) / 20.0)
    delta_pass = 0.01
    w = delta_pass / delta_stop

    def _design(n: int) -> np.ndarray:
        return remez(
            n,
            np.array([[0.0, f_pass], [f_stop, 0.5]]),
            np.array([1.0, 0.0]),
            np.array([1.0, w]),
        )

    def _fallback() -> np.ndarray:
        return kaiser_lowpass(sample_rate, cutoff, transition_width, db_attenuation)

    return _try_ladder(_design, ladder, _fallback).astype(dtype)


def bandpass_taps(
    sample_rate: float,
    low_cutoff: float,
    high_cutoff: float,
    transition_width: float,
    db_attenuation: float = -60.0,
    dtype=np.float32,
) -> np.ndarray:
    """Single band-pass design (parity with remezGenerateSingleBandPassTaps,
    am_test.cpp:176-195)."""
    fh = fred_harris_tap_count(db_attenuation, transition_width, sample_rate)
    bl = bellanger_tap_count(sample_rate, transition_width, 0.01, db_attenuation)
    # Bandpass benefits from Type I symmetry; force odd candidates.
    ladder = [n | 1 for n in (fh, bl, fh // 2, bl // 2)]

    f1 = low_cutoff / sample_rate
    f2 = high_cutoff / sample_rate
    tw = transition_width / sample_rate
    lo_stop = max(f1 - tw, 0.0)
    hi_stop = min(f2 + tw, 0.5)
    delta_stop = 10.0 ** (-abs(db_attenuation) / 20.0)
    w = 0.01 / delta_stop

    def _design(n: int) -> np.ndarray:
        bands = []
        desired = []
        weights = []
        if lo_stop > 1e-9:
            bands.append([0.0, lo_stop])
            desired.append(0.0)
            weights.append(w)
        bands.append([f1, f2])
        desired.append(1.0)
        weights.append(1.0)
        if hi_stop < 0.5 - 1e-9:
            bands.append([hi_stop, 0.5])
            desired.append(0.0)
            weights.append(w)
        return remez(n, np.array(bands), np.array(desired), np.array(weights))

    def _fallback() -> np.ndarray:
        return kaiser_bandpass(
            sample_rate, low_cutoff, high_cutoff, transition_width, db_attenuation
        )

    return _try_ladder(_design, ladder, _fallback).astype(dtype)


# ---------------------------------------------------------------------------
# Multistage decimation design
# ---------------------------------------------------------------------------


def _ordered_factorizations(d: int, max_stages: int = 3) -> list[list[int]]:
    """All ordered factorizations of ``d`` into 2..max_stages factors >= 2,
    plus the single-stage [d]."""
    out = [[d]]

    def rec(rem: int, acc: list[int]) -> None:
        if len(acc) >= 2 and rem == 1:
            out.append(list(acc))
        if len(acc) >= max_stages:
            return
        f = 2
        while f * f <= rem or f <= rem:
            if f > rem:
                break
            if rem % f == 0:
                acc.append(f)
                rec(rem // f, acc)
                acc.pop()
            f += 1

    rec(d, [])
    return out


def decimation_stages(
    sample_rate: float,
    cutoff: float,
    transition_width: float,
    db_attenuation: float,
    decimation: int,
) -> list[tuple[np.ndarray, int]]:
    """Design a minimum-work cascade of decimating lowpass FIRs equivalent
    to one ``decimation``-fold lowpass stage (Crochiere & Rabiner style).

    Large single-stage decimators are wasteful: the reference's WBFM chain
    needs ~550 taps at 20 Msps for a D=50 stage
    (RfToPcmAudioFactory.cpp:151-166 spec), but a D=10 stage with a relaxed
    transition followed by a sharp D=5 stage at 2 Msps does the same job in
    ~4x fewer multiply-accumulates per input sample.  Alias protection: each
    intermediate stage i (output rate fs_i+1) stops at
    fs_i+1 - (cutoff + transition_width), so everything folding onto the
    final band [0, cutoff+transition] sees that stage's full stopband
    attenuation; the final stage applies the exact requested edge.

    Returns [(taps, d), ...]; a single-element list when one stage is
    already optimal (or ``decimation`` is 1/prime-small).
    """
    D = int(decimation)
    f_pass = float(cutoff)
    f_stop = float(cutoff) + float(transition_width)
    if D <= 1:
        return [
            (
                lowpass_taps(sample_rate, cutoff, transition_width, db_attenuation),
                1,
            )
        ]

    def stage_specs(factors: list[int]):
        """Per-stage (fs, cutoff, transition) or None if infeasible."""
        specs = []
        fs = float(sample_rate)
        for i, d in enumerate(factors):
            fs_out = fs / d
            if i == len(factors) - 1:
                tw = f_stop - f_pass
            else:
                stop_edge = fs_out - f_stop
                tw = stop_edge - f_pass
                if tw <= 0.05 * fs_out:  # transition too squeezed: infeasible
                    return None
            if f_pass + tw > 0.5 * fs:
                return None
            specs.append((fs, f_pass, tw))
            fs = fs_out
        return specs

    # TPU-lane-aware cost model.  The polyphase kernel (ops/fir.py
    # _fir_poly) makes ceil(T/D) passes over frames whose minor axis is D;
    # TPU arrays tile the minor axis to 128 lanes, so a stage's effective
    # traffic per input sample is ceil(T/D) * max(D,128)/D, NOT T/D MACs.
    # Measured (benchmarks/fir_transpose_probe.py, v5e): D=50/T=546 runs
    # 6x faster than D=10/T=33 per input sample despite 2.5x more MACs —
    # lane utilization dominates.  Small-D stages are only worth it when
    # every candidate stage keeps D large.
    LANE = 128.0

    def stage_cost(t_est: int, d: int) -> float:
        passes = -(-t_est // d)  # ceil(T/D), the P slice-reduce passes
        return passes * max(float(d), LANE) / d

    best = None
    for factors in _ordered_factorizations(D):
        specs = stage_specs(factors)
        if specs is None:
            continue
        cost = 0.0
        rate_frac = 1.0
        for (fs_i, c_i, tw_i), d in zip(specs, factors):
            t_est = kaiser_tap_count(db_attenuation, tw_i, fs_i)
            cost += rate_frac * stage_cost(t_est, d)
            rate_frac /= d
        if best is None or cost < best[0] - 1e-9:
            best = (cost, factors, specs)

    _, factors, specs = best
    if len(factors) > 1:
        single_t = kaiser_tap_count(
            db_attenuation, f_stop - f_pass, sample_rate
        )
        log.info(
            "multistage decimation %d -> %s (lane-aware cost %.1f vs %.1f single)",
            D,
            factors,
            best[0],
            stage_cost(single_t, D),
        )
    # 2 dB design margin per cascade stage: the tap-count estimators can
    # under-deliver a couple dB at band edges, and in a cascade each fold
    # region is protected by ONE stage, so that stage alone must meet the
    # full spec.
    atten = db_attenuation - 2.0 if len(factors) > 1 else db_attenuation
    return [
        (lowpass_taps(fs_i, c_i, tw_i, atten), d)
        for (fs_i, c_i, tw_i), d in zip(specs, factors)
    ]
