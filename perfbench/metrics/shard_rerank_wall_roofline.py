"""The per-card re-rank's share of its roofline over the device wall of
its spans: over the traced segment's micro-batches, the frozen
``rerank_bound`` of the most candidates any one card selected (its
``index.shard_select`` spans' ``candidates``, each row of d float32 read
once) over the longest card's summed ``index.shard_rerank`` device wall
(the gather, the margins, their selection and the card's candidate
lists)."""
from perfbench import mesh_spans

LAYER = "index: union, re-rank"
UNIT = "%"
MOVES = "qps"
SOURCE = "program_span"


def read(ctx):
    bs = mesh_spans.batches(ctx)
    if not bs:
        return None
    d = ctx["shape"]["d"]
    bound_s = wall_ns = 0
    for b in bs:
        if not b["rerank"] or not b["candidates"]:
            return None
        bound_s += ctx["costs"].rerank_bound(max(b["candidates"].values()),
                                             d).seconds
        wall_ns += mesh_spans.longest(b["rerank"])
    if wall_ns <= 0:
        return None
    return 100.0 * bound_s / (1e-9 * wall_ns)
