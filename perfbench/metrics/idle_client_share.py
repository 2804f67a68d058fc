"""The share of the span window in which nothing is queued because the
caller holds the thread between micro-batches: the sum of (the next root
span's host start - this one's host end) over the window."""
from perfbench import spans

LAYER = "device (H100)"
UNIT = "%"
MOVES = "qps"
SOURCE = "program_span"


def read(ctx):
    bs = spans.batches(ctx)
    if not bs or spans.window_ns(bs) <= 0:
        return None
    gaps = sum(b["h0"] - a["h3"] for a, b in zip(bs, bs[1:]))
    return 100.0 * gaps / spans.window_ns(bs)
