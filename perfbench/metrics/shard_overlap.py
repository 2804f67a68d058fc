"""How far the cards of a row-sharded index select at once: over the
traced segment's micro-batches b and the cards s (S of them), 100 times
the summed device wall of each card's ``index.shard_select`` spans over S
times the summed span of each batch's selects (the last card's end less
the first card's start).  100 when every card selects through the whole
span, 100 / S when they take turns."""
from perfbench import mesh_spans

LAYER = "index: scan"
UNIT = "%"
MOVES = "qps"
SOURCE = "program_span"


def read(ctx):
    bs = mesh_spans.batches(ctx)
    if not bs:
        return None
    busy = span = 0
    cards = ctx["shape"]["shards"]
    for b in bs:
        every = [t for v in b["select"].values() for t in v]
        busy += sum(mesh_spans.wall(v) for v in b["select"].values())
        span += max(e for _, e in every) - min(s for s, _ in every)
    if span <= 0:
        return None
    return 100.0 * busy / (cards * span)
