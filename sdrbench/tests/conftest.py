"""Shared sizes for the benchmark's CPU tests: every configuration cut to a
few granules, so a whole run takes seconds on the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "wbfm_hackrf20": {"tick": 50000, "recording_ticks": 6, "period": 25000, "pool_blocks": 4},
    "fm_band100": {"tick": 25000, "recording_ticks": 5, "period": 25000, "pool_blocks": 4},
}


@pytest.fixture
def small():
    return SMALL
