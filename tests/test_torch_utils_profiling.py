"""The port's checks and profiling helpers against the JAX package's
(``tests/test_utils.py``): ``finite_or_skip`` and the NaN screen,
``roofline_report`` (the same counters, the H100's 3,350 GB/s as the
default bound), ``log_memory_usage`` without ``psutil``, ``profiler_trace``
writing a Chrome trace on the CPU, and ``timed``."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.utils import finite_or_skip as j_finite_or_skip
from gflownet_spai_tpu.utils import roofline_report as j_roofline_report
from gflownet_spai_tpu_torch import utils
from gflownet_spai_tpu_torch.utils import (checkify_nan_screen, finite_or_skip,
                                           log_memory_usage, profiler_trace,
                                           roofline_report, timed)


@pytest.mark.parametrize("loss", [float("nan"), float("inf"), 1.0])
def test_finite_or_skip_matches_jax(loss):
    grads = {"w": torch.ones(3), "b": [torch.full((2,), 2.0)]}
    g, skipped = finite_or_skip(torch.tensor(loss), grads)
    jg, jskipped = j_finite_or_skip(jnp.asarray(loss),
                                    {"w": jnp.ones(3), "b": [jnp.full((2,), 2.0)]})
    assert isinstance(skipped, torch.Tensor) and bool(skipped) == bool(jskipped)
    np.testing.assert_array_equal(g["w"].numpy(), np.asarray(jg["w"]))
    np.testing.assert_array_equal(g["b"][0].numpy(), np.asarray(jg["b"][0]))
    assert float(g["w"].sum()) == (0.0 if bool(skipped) else 3.0)


def test_checkify_nan_screen():
    screened = checkify_nan_screen(torch.log)
    assert float(screened(torch.tensor(1.0))) == 0.0
    with pytest.raises(FloatingPointError, match="NaN or an inf"):
        screened(torch.tensor(-1.0))


def test_nan_screen_names_the_first_bad_operation_inside_fn():
    seen = []

    def fn(x):
        y = x * 2.0                   # finite
        seen.append("mul")
        z = y / torch.zeros_like(y)   # inf: raises here
        seen.append("div")
        return z

    with pytest.raises(FloatingPointError, match="div"):
        checkify_nan_screen(fn)(torch.ones(3))
    assert seen == ["mul"]
    # integer and boolean outputs are not checked; the screen leaves no mode on
    assert checkify_nan_screen(lambda x: x > 0)(torch.ones(2)).all()
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_roofline_report_against_the_h100():
    r = roofline_report(nnz=5_000_000, seconds_per_op=48e-6)
    assert r["gnnz_per_s"] == pytest.approx(104.2, rel=0.01)
    want = j_roofline_report(nnz=5_000_000, seconds_per_op=48e-6, hbm_gbps=3350.0)
    for k, v in want.items():
        assert r[k] == pytest.approx(v, rel=1e-12)
    assert r["roofline_fraction"] == pytest.approx(104.1667e9 * 5.6 / 3350e9, rel=1e-4)


def test_log_memory_usage_without_psutil(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "psutil", None)     # import psutil raises
    out = log_memory_usage("stage-x")
    assert out["rss_mb"] > 1.0 and out["vms_mb"] >= out["rss_mb"]
    assert capsys.readouterr().out.startswith("[stage-x] rss_mb=")


def test_profiler_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    a = torch.randn(64, 64)
    with profiler_trace(str(tmp_path / "trace")):
        torch.mm(a, a).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])


def test_timed_returns_a_positive_time_per_call():
    a = torch.randn(32, 32)
    secs = timed(torch.mm, a, a, reps=5)
    assert 0.0 < secs < 1.0


def test_utils_exports_match_jax():
    import gflownet_spai_tpu.utils as j_utils

    assert set(j_utils.__all__) == set(utils.__all__)
