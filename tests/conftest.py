# NOTE: no XLA_FLAGS / device-count manipulation here — smoke tests and
# benches must see the single real device.  Multi-device tests spawn
# subprocesses that set --xla_force_host_platform_device_count themselves.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def trace_counter():
    """TraceCounter over the serving-path jit entrypoints (repro.lint.runtime):
    wrap steady-state traffic in ``with trace_counter.assert_no_retrace():``
    to assert the window added zero new jit traces."""
    from repro.lint.runtime import TraceCounter, scan_trace_targets
    return TraceCounter(scan_trace_targets())


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips (from a fixture) on "
                   "machines without one")
