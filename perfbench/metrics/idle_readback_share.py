"""The share of the span window in which the device is done with a
micro-batch while the host reads the answers back and builds them: the
sum over the traced segment's micro-batches of max(0, the root span's
host end - the device time of the read-back's entry event), over the
window (the read-back's own copies, a small part, count here)."""
from perfbench import spans

LAYER = "device (H100)"
UNIT = "%"
MOVES = "qps"
SOURCE = "program_span"


def read(ctx):
    bs = spans.batches(ctx)
    if not bs or spans.window_ns(bs) <= 0:
        return None
    return 100.0 * sum(max(0, b["h3"] - b["d1"]) for b in bs) / \
        spans.window_ns(bs)
