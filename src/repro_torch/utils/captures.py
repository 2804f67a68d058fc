"""A sentinel on CUDA-graph captures, the port's counterpart of the JAX
package's retrace sentinel (src/repro/lint/runtime.py:36
``TraceCounter``): where the reference compiles a jitted function again,
the port captures a CUDA graph again, and either costs a steady-state
window its speed without changing an answer.

``CaptureCounter`` snapshots the port's capture counters (each moves
through ``kernels._build.count``) and ``assert_no_capture`` fails if a
window that must be capture-stable made one:

>>> cc = CaptureCounter()
>>> ...warm-up...
>>> with cc.assert_no_capture():
...     ...steady-state traffic...
"""
from __future__ import annotations

import contextlib


def capture_targets() -> dict:
    """name -> (object, counter attribute) of every capture counter:
    ``core.learning.BitLoop.captures`` (one per LBH fit's graph) and
    ``kernels.lbh_grad.lbh_chain.captured`` (the chain launches recorded
    into graphs)."""
    from repro_torch.core.learning import BitLoop
    from repro_torch.kernels.lbh_grad import lbh_chain
    return {"core.learning.BitLoop.captures": (BitLoop, "captures"),
            "kernels.lbh_grad.lbh_chain.captured": (lbh_chain, "captured")}


class CaptureCounter:
    """Snapshot / assert helper over named capture counters (default
    ``capture_targets()``)."""

    def __init__(self, targets: dict | None = None):
        self.targets = dict(capture_targets() if targets is None
                            else targets)

    def snapshot(self) -> dict:
        return {name: getattr(obj, attr)
                for name, (obj, attr) in self.targets.items()}

    def deltas(self, before: dict) -> dict:
        """The counters that moved since ``before``, by how much."""
        now = self.snapshot()
        return {name: now[name] - before.get(name, 0) for name in now
                if now[name] != before.get(name, 0)}

    @contextlib.contextmanager
    def assert_no_capture(self):
        before = self.snapshot()
        yield self
        grew = self.deltas(before)
        if grew:
            raise AssertionError(
                f"CUDA graphs were captured during a window that must be "
                f"capture-stable: {grew} (new captures per counter); a "
                f"capture per call costs the window its speed")
