"""The cell's own mix driven again with the program's tracer on, for the
per-layer metrics that read the program's spans and stamps.

``traced(r)`` runs the mode's own ``drive``, unedited, on a copy of the
cell whose window lasts min(``SECONDS``, ``--seconds``), with no profiler
slice and with set-up marks and a window start of its own (so the run's
printed set-up phases do not change), under one
``tpusdr_torch.utils.tracing.Tracer``.  It runs once a run: the result is
kept on the ``Readings`` and shared by every reader.  Where the program
has no tracer (a tree from before it), it gives None, and so does every
reader that needs it.

The helpers below reduce the tracer's rings for the readers: a stage's
median time inside the tick, the device gaps between replays, and, per
block of the traced run, how long its audio waited for the drain and how
long its samples waited between the radio and the step.
"""

from __future__ import annotations

import copy

import numpy as np

SECONDS = 5.0


def traced(r) -> dict | None:
    """{'summary', 'rows', 'spans', 'end_to_end'} of the traced re-drive,
    or None where the program has no tracer."""
    if not hasattr(r, "spans_run"):
        r.spans_run = _drive(r.cell)
    return r.spans_run


def _drive(cell) -> dict | None:
    try:
        from tpusdr_torch.utils.tracing import Tracer
    except ModuleNotFoundError as e:
        if e.name != "tpusdr_torch.utils.tracing":
            raise  # the tracer is there but does not import
        return None
    from sdrbench import run

    c = copy.copy(cell)
    c.seconds = min(SECONDS, cell.seconds)
    c.trace = False
    c.marks = {}
    c.t_window = None
    c.keep_alive = None
    with Tracer() as tracer:
        window = run.traffic_mode(c.traffic["mode"]).drive(c)
    out = {"summary": tracer.summary(), "rows": tracer.rows(), "spans": tracer.spans(),
           "end_to_end": dict(window.end_to_end)}
    c.keep_alive = None  # the copy's recording, buffers and runner go now
    return out


def on_card(r) -> bool:
    """The readers read only a run on the card (the benchmark runs nowhere
    else; its CPU tests run the rest)."""
    return r.cell.device.type == "cuda"


def stage(r, *kinds: str) -> dict | None:
    """The first stage of the chain whose block class is one of ``kinds``:
    {'name', 'block', 'n_in', 'n_out'} at the cell's tick."""
    chain = r.cell.chain
    plan = {name: (n_in, n_out) for name, n_in, n_out in chain.plan(r.cell.tick)}
    for name, block in chain.blocks:
        if type(block).__name__ in kinds:
            return {"name": name, "block": block, "n_in": plan[name][0], "n_out": plan[name][1]}
    return None


def stage_us(t: dict, name: str) -> float | None:
    """The median time of stage ``name`` inside the tick, in us."""
    row = t["summary"]["stages"].get(name)
    return row["p50_us"] if row and row["count"] else None


def replay_gaps_us(t: dict) -> np.ndarray:
    """Device time from each replay's last stamp to the next replay's
    first, us."""
    rows = t["rows"]
    st, mode = rows["stamps"], rows["mode"]
    if len(st) < 2:
        return np.zeros(0)
    widths = np.array([len(n) for n in rows["names"]])[rows["layout"]]
    last = st[np.arange(len(st)), widths - 1]
    both = (mode[1:] == 2) & (mode[:-1] == 2)
    return ((st[1:, 0] - last[:-1]) * 1e-3)[both]


def _last_run(ids: np.ndarray) -> np.ndarray:
    """Which of ``ids`` belong to the newest run (a run's number sits above
    bit 32 of a block's id)."""
    if not len(ids):
        return np.zeros(0, bool)
    return (ids >> 32) == (ids.max() >> 32)


def _first_by_id(ids: np.ndarray, values: np.ndarray) -> dict:
    out: dict = {}
    for i, v in zip(ids.tolist(), values.tolist()):
        out.setdefault(i, v)
    return out


def _span_by_id(t: dict, name: str, end: int) -> dict:
    sp = t["spans"]
    k = sp["names"].index(name) if name in sp["names"] else -1
    m = sp["name"] == k
    return _first_by_id(sp["id"][m], (sp["t1"] if end else sp["t0"])[m])


def drain_hold_ms(t: dict) -> np.ndarray:
    """For each block of the newest run: from its tick's last stamp (on the
    host's clock) to the start of its ``sink`` span, ms."""
    rows = t["rows"]
    keep = _last_run(rows["id"]) & (rows["id"] >= 0)
    widths = np.array([len(n) for n in rows["names"]])[rows["layout"]]
    last = rows["host"][np.arange(len(widths)), widths - 1]
    done = _first_by_id(rows["id"][keep], last[keep])
    sink = _span_by_id(t, "sink", 0)
    return np.array([(sink[i] - done[i]) * 1e-6 for i in done if i in sink])


def upload_wait_ms(t: dict) -> np.ndarray:
    """For each block of the newest run: from the end of its ``source``
    span (the radio handed it over) to the start of its ``step`` span, ms."""
    src = _span_by_id(t, "source", 1)
    step = _span_by_id(t, "step", 0)
    ids = np.array([i for i in step if i in src], np.int64)
    ids = ids[_last_run(ids)]
    return np.array([(step[i] - src[i]) * 1e-6 for i in ids.tolist()])
