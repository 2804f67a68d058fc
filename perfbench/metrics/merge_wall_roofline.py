"""The scan's merge's share of its roofline over the device wall of its
span: the traced segment's micro-batches times the frozen ``merge_bound``
over the sum of the ``index.merge`` spans' device end - start (the int32
widening included, as is any time the device waited for the host inside
the span)."""
from perfbench import spans

LAYER = "index: scan"
UNIT = "%"
MOVES = "qps"
SOURCE = "program_span"


def read(ctx):
    bs = spans.batches(ctx)
    if not bs:
        return None
    wall_ns = spans.total(bs, "wall", "index.merge")
    if wall_ns <= 0:
        return None
    sh = ctx["shape"]
    bound = ctx["costs"].merge_bound(sh["n"], sh["w"], sh["b"], sh["l"],
                                     g=sh["g"])
    return 100.0 * len(bs) * bound.seconds / (1e-9 * wall_ns)
