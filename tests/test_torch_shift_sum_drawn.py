"""K8's plan (``staging_probes.shift_sum_plan``) and the numpy model of its
kernel over shapes and plans drawn by hypothesis, on the CPU: the listed
cases are in test_torch_probes.py, whose ``check_shift_sum_plan`` and
``k8_model`` these reuse.  The draws are derandomized, so every run takes
the same cases."""

import numpy as np
import pytest
import torch

from tpusdr_torch.kernels import staging_probes as sp

hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies

from test_torch_probes import check_shift_sum_plan, k8_model  # noqa: E402


@hypothesis.settings(max_examples=60, deadline=None, derandomize=True)
@hypothesis.given(rows_out=st.integers(1, 400_000), w4=st.integers(1, 3000), P=st.integers(1, 700),
                  sms=st.integers(1, 132), run_rows=st.none() | st.integers(1, 5000),
                  groups=st.none() | st.integers(1, 300))
def test_shift_sum_plan_properties_drawn(rows_out, w4, P, sms, run_rows, groups):
    plan = sp.shift_sum_plan(rows_out, 4 * w4, P, sms, run_rows=run_rows, groups=groups)
    check_shift_sum_plan(rows_out, 4 * w4, P, sms, plan)


@hypothesis.settings(max_examples=40, deadline=None, derandomize=True)
@hypothesis.given(rows_out=st.integers(1, 600), w4=st.integers(1, 300), P=st.integers(1, 40),
                  sms=st.integers(1, 132), run_rows=st.none() | st.integers(1, 50),
                  groups=st.none() | st.integers(1, 20))
def test_shift_sum_model_is_the_plain_version_drawn(rows_out, w4, P, sms, run_rows, groups):
    x = np.random.default_rng(rows_out).standard_normal((rows_out + P - 1, 4 * w4)).astype(np.float32)
    plan = sp.shift_sum_plan(rows_out, 4 * w4, P, sms, run_rows=run_rows, groups=groups)
    out, written = k8_model(x, P, plan)
    np.testing.assert_array_equal(written, 1)
    np.testing.assert_array_equal(out, sp.staged_shift_sum_plain(torch.from_numpy(x), P).numpy())
