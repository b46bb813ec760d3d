"""The port's tracer (``tpusdr_torch/utils/tracing.py``) on the CPU, where a
stamp is its plain version (``time.perf_counter_ns`` into the ring): a
runner with no tracer records nothing and a traced one gives the same
audio bit for bit; a traced Chain writes one row a tick with its stages in
order; the runner's spans come in order per block with one id across its
two threads; self time; the calibration on a scripted clock; the rings
wrapping; and a profiler trace lined up with the ring.  The card's side
(the stamps captured into the graph, bit-identical audio, the stages
against CUDA events) is in tests/test_torch_cuda.py.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.runner import CapturedStep, StreamRunner
from tpusdr_torch.io.sinks import CollectSink
from tpusdr_torch.models import receiver
from tpusdr_torch.utils import tracing
from tpusdr_torch.utils.tracing import Calibration, Tracer

TICK = 40000
RUNNER_SPANS = ["source", "upload", "step", "fetch", "drain_wait", "sink"]


@pytest.fixture
def chain():
    return receiver.fm_receiver(2e6, 300e3, receiver.WBFM)[0]


def ticks(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(TICK) + 1j * rng.standard_normal(TICK)).astype(np.complex64) for _ in range(n)]


def run_audio(runner, blocks):
    sink = CollectSink()
    _, stats = runner.run(iter(blocks), sink)
    return sink.result(), stats


def test_a_runner_without_a_tracer_records_nothing_and_tracing_keeps_the_audio(chain):
    blocks = ticks(6)
    idle = Tracer()
    plain = StreamRunner(chain, device="cpu")
    assert plain.tracer is None and tracing.current() is None
    audio, stats = run_audio(plain, blocks)
    s = idle.summary()
    assert s["spans"] == {} and s["ticks"]["claimed"] == 0 and s["stages"] == {}
    assert s["counters"] == {"launches": {}}
    with Tracer() as tr:
        traced = StreamRunner(chain, device="cpu")
        assert traced.tracer is tr
        audio_on, stats_on = run_audio(traced, blocks)
    assert tracing.current() is None
    assert np.array_equal(audio, audio_on)
    assert stats.eager_ticks == stats_on.eager_ticks == 6 and stats.captures == stats_on.captures == 0
    s = tr.summary()
    assert s["ticks"]["claimed"] == s["ticks"]["eager"] == 6
    assert s["counters"]["blocks"] == 6 and s["counters"]["samples_in"] == 6 * TICK
    assert s["counters"]["samples_out"] == stats_on.samples_out


def test_a_traced_chain_writes_one_row_a_tick_with_its_stages_in_order(chain):
    names = [n for n, _ in chain.blocks]
    outer = Chain([("rx", chain)])  # a chain inside a chain: only the outer one stamps
    with Tracer() as tr:
        state = chain.init_state(device="cpu")
        for x in ticks(5):
            state, _ = chain.apply(state, torch.from_numpy(x))
        outer.apply(outer.init_state(device="cpu"), torch.from_numpy(x))
    rows = tr.rows()
    assert rows["claimed"] == 6 and (rows["mode"] == tracing.EAGER).all()
    assert [rows["names"][k] for k in rows["layout"]] == [["start", *names]] * 5 + [["start", "rx"]]
    st = rows["stamps"][:5, : len(names) + 1]
    assert (np.diff(st, axis=1) >= 0).all()
    assert (st[1:, 0] >= st[:-1, -1]).all()
    assert (rows["stamps"][5, 2:] == -1).all() and rows["stamps"][5, 1] >= rows["stamps"][5, 0]
    s = tr.summary()
    assert list(s["stages"]) == [*names, "rx"] and s["stages"]["shiftfir"]["count"] == 5
    assert s["gaps"]["count"] == 5


class FakeEvent:
    def synchronize(self):
        pass


def test_runner_spans_come_in_order_per_block_with_one_id_across_threads(chain):
    with Tracer() as tr:
        runner = StreamRunner(chain, device="cpu")
    runner._fetch = lambda y: (y, FakeEvent())  # a fetch with an event to wait on, as on a card
    for _ in range(2):
        run_audio(runner, ticks(5))
    sp = tr.spans()
    by = {}
    for k, i, t0, t1, th in zip(sp["name"], sp["id"], sp["t0"], sp["t1"], sp["thread"]):
        by.setdefault(sp["names"][k], {})[int(i)] = (int(t0), int(t1), int(th))
    ids = sorted(by["step"])
    assert ids == [0, 1, 2, 3, 4, 1 << 32, (1 << 32) + 1, (1 << 32) + 2, (1 << 32) + 3, (1 << 32) + 4]
    assert all(sorted(by[name]) == ids for name in RUNNER_SPANS)
    for i in ids:
        spans = [by[name][i] for name in RUNNER_SPANS]
        for (_, end, _), (start, _, _) in zip(spans, spans[1:]):
            assert end <= start
        threads = [th for _, _, th in spans]
        assert threads[0] == threads[1] != threads[2] == threads[3] == threads[4] == threads[5]
    assert {th for _, _, th in by["queue"].values()} == {by["step"][0][2]}
    s = tr.summary()
    assert set(s["gaps"]["by_span"]) <= set(sp["names"]) | {"no span"}
    assert sum(g["count"] for g in s["gaps"]["by_span"].values()) == s["gaps"]["count"] == 9


def test_self_time_leaves_out_the_children_it_covers():
    t0 = np.array([0, 10, 12, 40, 20, 100])
    t1 = np.array([100, 30, 20, 50, 80, 110])
    thread = np.array([0, 0, 0, 0, 1, 0])  # the span on thread 1 overlaps but is no child
    assert tracing.self_times(t0, t1, thread).tolist() == [70, 12, 8, 10, 60, 10]
    tr = Tracer()
    for name, a, b in [("step", 0, 100), ("step.copy_in", 10, 30), ("step.replay", 30, 50), ("step", 200, 260)]:
        tr.span(name, 0, a, b)
    s = tr.summary()["spans"]
    assert s["step"]["count"] == 2 and s["step"]["total_ms"] == pytest.approx(160e-6)
    assert s["step"]["self_ms"] == pytest.approx(120e-6)
    assert s["step.copy_in"]["self_ms"] == pytest.approx(20e-6)


def test_the_calibration_takes_the_narrowest_bracket_on_a_scripted_clock():
    brackets = [(1_000, 1_050), (2_000, 2_010), (3_000, 3_030), (4_000, 4_020)]
    offset = 777
    clock_reads = iter([t for b in brackets for t in b])
    stamps = iter([(a + b) // 2 - offset + d for (a, b), d in zip(brackets, (20, 0, -9, 4))])
    c = tracing.calibrate(lambda: next(stamps), clock=lambda: next(clock_reads), n=len(brackets))
    assert c == Calibration(offset, 5.0, 2_005 - offset)
    tr = Tracer()
    tr._calib = [Calibration(1_000, 5.0, 0), Calibration(1_100, 4.0, 10_000)]
    assert tr._to_host(np.array([0, 5_000, 10_000])).tolist() == [1_000, 6_050, 11_100]


def test_the_rings_keep_the_newest_when_they_wrap(chain, monkeypatch):
    monkeypatch.setattr(tracing, "RING_TICKS", 4)
    monkeypatch.setattr(tracing, "RING_SPANS", 8)
    with Tracer() as tr:
        state = chain.init_state(device="cpu")
        for i, x in enumerate(ticks(10)):
            tr.block = i
            state, _ = chain.apply(state, torch.from_numpy(x))
    for i in range(20):
        tr.span("s", i, i, i + 1)
    rows = tr.rows()
    assert rows["claimed"] == 10 and rows["id"].tolist() == [6, 7, 8, 9]
    assert (rows["stamps"][1:, 0] >= rows["stamps"][:-1, -1]).all()
    sp = tr.spans("s")
    assert sp["recorded"] == 20 and sp["id"].tolist() == list(range(12, 20))
    s = tr.summary()
    assert s["ticks"]["kept"] == 4 and s["spans_dropped"] == 12 and s["spans"]["s"]["count"] == 8


def test_the_plain_stamp_advances_the_slot_at_the_first_stamp():
    ring = torch.full((3, 2), -1, dtype=torch.int64)
    slot = torch.zeros(1, dtype=torch.int64)
    for _ in range(4):
        tracing.stamp_plain(ring, slot, 0)
        tracing.stamp_plain(ring, slot, 1)
    assert int(slot) == 4 and (ring >= 0).all()
    assert ring[0, 0] > ring[2, 1] > ring[2, 0] > ring[1, 1]  # row 0 written again by the fourth tick


def test_a_captured_step_counts_its_eager_tick_into_the_tracer(chain):
    """A bare step's ticks are counted by mode in the tracer's rows; its own
    counters stay on the step (a runner's reach the tracer through its
    ``RunStats``), and the tracer keeps no reference to it."""
    tr = Tracer()
    step = CapturedStep(chain, tracer=tr)  # on the CPU only its eager first tick runs
    tr.block = 7
    step(chain.init_state(device="cpu"), torch.from_numpy(ticks(1)[0]))
    assert step.eager_ticks == 1 and step.captures == 0
    rows = tr.rows()
    assert rows["mode"].tolist() == [tracing.EAGER] and rows["id"].tolist() == [7]
    s = tr.summary()
    assert (s["ticks"]["eager"], s["ticks"]["capture"], s["ticks"]["replay"]) == (1, 0, 0)
    assert "eager_ticks" not in s["counters"] and "captures" not in s["counters"]
    assert CapturedStep(chain).tracer is None
    gone = weakref.ref(step)
    del step
    gc.collect()
    assert gone() is None


def test_a_refreshed_step_is_freed_while_the_tracer_records(chain):
    """A traced runner's ``refresh`` drops its step: neither the tracer nor
    the runner keeps it, and the runs' counters still reach the tracer
    through their ``RunStats``."""
    with Tracer() as tr:
        runner = StreamRunner(chain, device="cpu")
    runner.capture = True  # a captured step's eager first tick runs on the CPU
    runner.refresh()
    stats = []
    for _ in range(3):
        step = weakref.ref(runner._step)
        stats.append(run_audio(runner, ticks(1))[1])
        runner.update_parameters("shiftfir", frequency=-310e3)
        gc.collect()
        assert step() is None and runner._step is not None
    assert [(st.captures, st.eager_ticks) for st in stats] == [(0, 1)] * 3
    s = tr.summary()
    assert s["counters"]["eager_ticks"] == 3 and s["counters"]["captures"] == 0 and s["counters"]["blocks"] == 3


def test_a_tracer_records_one_device_and_refuses_another():
    tr = Tracer()
    tr.ring("cpu")
    with pytest.raises(ValueError, match="one stream of one device"):
        tr.ring("meta")


def test_a_profiler_trace_lines_up_with_the_ring():
    rng = np.random.default_rng(5)
    names = [["start", "a", "b"]]
    st = np.cumsum(rng.integers(3_000, 9_000, size=(8, 3)).reshape(-1)).reshape(8, 3)
    rows = {"stamps": st, "layout": np.zeros(8, np.int64), "names": names}
    offset = 10**15
    # a slice that began inside tick 2, after its first stamp
    prof = [(tracing.STAMP_KERNEL, int(v) + offset + int(rng.integers(0, 40)), 900) for v in st.reshape(-1)[7:]]
    prof += [("kern_a", int(st[3, 0]) + offset + 1_000, 500), ("kern_b", int(st[4, 1]) + offset + 1_000, 700),
             ("copy", int(st[5, 2]) + offset + 1_000, 300)]
    fit = tracing.line_up([p[1] for p in prof if p[0] == tracing.STAMP_KERNEL], rows)
    assert fit["at"] == (2, 1) and abs(fit["offset_ns"] - offset) < 40 and fit["spread_ns"] < 40
    got = tracing.attribute(prof, rows)
    assert got == {"a": {"kern_a": 500}, "b": {"kern_b": 700}, "between ticks": {"copy": 300}}
