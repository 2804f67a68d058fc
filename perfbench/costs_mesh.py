"""The frozen yardstick of a cell whose rows are sharded over several
cards: the least time one card could take for its share of a micro-batch.

``shard_select_bound`` is a frozen copy of
``repro_torch.kernels.ops.shard_select_bound`` (the rates are
``costs.py``'s), so that a change to the program cannot move the bound
it is measured against; ``perfbench/tests/test_perfbench_mesh.py`` holds
the copy equal to the program's at the cell's shapes.
"""
from __future__ import annotations

from perfbench.costs import MAX_SM_CLOCK_HZ, SMS, Bound, _bound, popc_s


def shard_select_bound(n: int, w: int, b: int, selected: int, *,
                       g: int = 1, sms: int = SMS,
                       clock_hz: float = MAX_SM_CLOCK_HZ) -> Bound:
    """One card's histogram and select of the cutoff exchange: n valid
    rows of g groups of W-word codes against B queries each, ``selected``
    rows (over every group and query) its share of the top-l.  Bytes:
    codes and queries once (g (n + B) W 4), the selected rows' int32
    written once (selected 4).  Operations: one popcount per row, query
    and word (g n B W)."""
    return _bound(g * (n + b) * w * 4 + selected * 4, g * n * b * w,
                  popc_s(sms, clock_hz))
