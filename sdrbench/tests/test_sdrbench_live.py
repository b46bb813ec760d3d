"""The open loop's schedule, lateness, latencies and 95th percentile on a
fake clock."""

import numpy as np
import pytest

from sdrbench import run

paced = run.traffic_mode("paced")
NEVER_MS, Pacer, p95 = paced.NEVER_MS, paced.Pacer, paced.p95


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t
        self.slept = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.slept.append(s)
        self.t += s


def test_blocks_are_handed_over_at_their_due_time_and_never_earlier():
    clk = FakeClock()
    pacer = Pacer(0.0065625, 4, clock=clk, sleep=clk.sleep)
    t0 = [clk()]
    got = []
    for i, b in enumerate(pacer.source(["a", "b"], t0)):
        got.append((b, clk()))
        if i == 1:
            clk.t += 0.010  # the runner stalls 10 ms after block 1
    due = pacer.due(t0[0])
    assert [b for b, _ in got] == ["a", "b", "a", "b"]
    assert got[0][1] == pytest.approx(due[0]) and got[1][1] == pytest.approx(due[1])
    # block 2 was due 3.4375 ms before the stall ended: handed over at once, late
    assert got[2][1] == pytest.approx(due[1] + 0.010)
    assert pacer.late[2] == pytest.approx(0.010 - 0.0065625)
    assert got[3][1] == pytest.approx(due[3]) and pacer.late[3] == pytest.approx(0.0)


def test_latency_from_due_time_and_missing_blocks():
    pacer = Pacer(0.005, 5)
    t0 = 10.0
    stamps = [10.005 + 0.013, 10.010 + 0.014, 10.015 + 0.020]  # two blocks never written
    lat = pacer.latencies_ms(t0, stamps)
    assert lat[:3] == pytest.approx([13.0, 14.0, 20.0])
    assert list(lat[3:]) == [NEVER_MS, NEVER_MS]


def test_p95_is_linear_between_ranks():
    lat = np.arange(1, 101, dtype=float)  # 1 .. 100 ms
    assert p95(lat) == pytest.approx(95.05)
    lat[-1] = NEVER_MS
    assert p95(lat) == pytest.approx(95.05)
    lat[-6:] = NEVER_MS  # more than 5% never delivered: the tail is infinite
    assert p95(lat) > 1e8
