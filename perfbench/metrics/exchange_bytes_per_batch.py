"""Bytes that cross between the cards of a row-sharded index a
micro-batch, from the ``index.exchange`` spans' ``exchange_bytes``: their
sum over the traced segment's micro-batches over the micro-batches (the
queries out, the distance histograms in, the cutoffs out, each card's
least margins, hits and candidate lists in)."""
from perfbench import mesh_spans

LAYER = "index: exchange"
UNIT = "bytes"
MOVES = "qps"
SOURCE = "program_counter"


def read(ctx):
    bs = mesh_spans.batches(ctx)
    if not bs:
        return None
    return sum(b["exchange_bytes"] for b in bs) / len(bs)
