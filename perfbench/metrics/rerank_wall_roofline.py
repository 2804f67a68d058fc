"""The union and re-rank's share of their roofline over the device wall of
their spans: the frozen ``rerank_bound`` of the candidates the read-back
span counted (the sum over the traced segment's queries of their unique
candidates) over the sum of the ``index.union`` and ``index.rerank``
spans' device end - start."""
from perfbench import spans

LAYER = "index: union, re-rank"
UNIT = "%"
MOVES = "qps"
SOURCE = "program_span"


def read(ctx):
    bs = spans.batches(ctx)
    if not bs:
        return None
    wall_ns = (spans.total(bs, "wall", "index.union")
               + spans.total(bs, "wall", "index.rerank"))
    cands = spans.total(bs, "counts", "candidates")
    if wall_ns <= 0 or cands <= 0:
        return None
    bound = ctx["costs"].rerank_bound(cands, ctx["shape"]["d"])
    return 100.0 * bound.seconds / (1e-9 * wall_ns)
