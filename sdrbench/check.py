"""Whether the timed path's audio is right: each tick the driver kept is
decoded again by the configuration's plain reference (``reference/<module>``,
float64, on the same wire samples, from rest as many ticks earlier as fill
every stage's memory) and compared sample for sample.

Numbers compared, each with its limit:
  * ``audio_peak_err_db``: the worst, over the kept ticks and channels, of
    20 log10(max |program - reference| / max |reference|); the limit is the
    configuration's ``check.audio_peak_err_db``;
  * ``wrong_length_ticks``: delivered ticks whose audio has another length
    than the reference's for one tick; limit 0;
  * ``undelivered``: ticks or blocks due in the window whose audio never
    reached the sink; limit 0;
  * ``ticks_checked``: ticks compared; at least 1.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch


def reference_module(cfg: dict):
    return importlib.import_module(f"sdrbench.reference.{cfg['reference']['module']}")


def decode_tick(cfg: dict, plan: dict, inputs, index: int, tick: int, device, dtype=torch.float64) -> np.ndarray:
    """The reference's audio of tick ``index`` alone (float64 numpy),
    decoded from rest as many ticks earlier as the reference's memory
    needs."""
    mod = reference_module(cfg)
    wire, start, ctx = inputs(index, -(-mod.memory(plan) // tick))
    wire = wire.to(device)
    audio = mod.decode(cfg["reference"], plan, wire, start, dtype)
    n_ctx = audio.shape[-1] * ctx // wire.shape[-1]
    return audio[..., n_ctx:].to(torch.float64).cpu().numpy()


def peak_err_db(got: np.ndarray, ref: np.ndarray) -> float:
    """Worst row of 20 log10(max|got - ref| / max|ref|); 400 dB where the
    shapes differ."""
    if got.shape != ref.shape:
        return 400.0
    got = got.reshape(-1, got.shape[-1]).astype(np.float64)
    ref = ref.reshape(-1, ref.shape[-1])
    err = np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1e-30)
    worst = float(err.max())
    return 20.0 * math.log10(worst) if worst > 0 else -400.0


def check(cfg: dict, window, device) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "limit": l}})."""
    mod = reference_module(cfg)
    plan = mod.plan(cfg["reference"])
    worst = -math.inf
    length = None
    for index in sorted(window.kept):
        ref = decode_tick(cfg, plan, window.inputs, index, window.tick, device)
        length = ref.shape[-1]
        worst = max(worst, peak_err_db(window.kept[index], ref))
    wrong = sum(k for n, k in window.lengths.items() if n != length) if length is not None else 1
    limit = float(cfg["check"]["audio_peak_err_db"])
    numbers = {
        "audio_peak_err_db": {"value": worst, "limit": limit},
        "wrong_length_ticks": {"value": wrong, "limit": 0},
        "undelivered": {"value": window.failed, "limit": 0},
        "ticks_checked": {"value": len(window.kept), "limit": 1},
    }
    correct = (
        worst <= limit and wrong == 0 and window.failed == 0 and len(window.kept) >= 1
    )
    return correct, numbers
