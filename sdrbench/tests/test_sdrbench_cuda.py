"""On the card: one short traced run of each cell at small sizes, correct.  Run on
a machine with a card: python -m pytest sdrbench/tests -m cuda -q"""

import pytest
import torch

from sdrbench import run
from sdrbench.tests.conftest import SMALL

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("workload,config", [("wbfm.capture", "wbfm_hackrf20"), ("bank100.capture", "fm_band100"),
                                             ("wbfm.live", "wbfm_hackrf20")])
def test_a_short_run_on_the_card_is_correct(cuda, workload, config):
    run.pin_caches()
    # 2.5 s: the traced slice starts 1 s into the window
    r = run.run_cell(workload, 2**33 + 29, 2.5, True, cuda, sizes=SMALL[config], say=lambda _: None)
    assert r["correct"], r["check"]
    assert r["device"]["busy_s"] > 0
