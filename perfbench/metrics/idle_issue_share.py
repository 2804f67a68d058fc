"""The share of the span window in which the device waits while the host
issues a micro-batch's work (hash to re-rank): over the traced segment's
micro-batches, the sum of (the device time of the read-back's entry event
- the root span's host start), less the device's busy time, over the
window from the first root's start to the last one's end."""
from perfbench import spans

LAYER = "device (H100)"
UNIT = "%"
MOVES = "qps"
SOURCE = "program_span"


def read(ctx):
    bs = spans.batches(ctx)
    if not bs or spans.window_ns(bs) <= 0:
        return None
    issue_ns = sum(b["d1"] - b["h0"] for b in bs)
    busy_ns = 1e9 * ctx["profile"]["busy_s"]
    return 100.0 * (issue_ns - busy_ns) / spans.window_ns(bs)
