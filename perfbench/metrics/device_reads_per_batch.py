"""Blocking device-to-host reads a micro-batch makes, from the read-back
span's ``reads`` count: their sum over the traced segment's micro-batches
over the micro-batches."""
from perfbench import spans

LAYER = "index: union, re-rank"
UNIT = "reads"
MOVES = "qps"
SOURCE = "program_counter"


def read(ctx):
    bs = spans.batches(ctx)
    if not bs:
        return None
    return spans.total(bs, "counts", "reads") / len(bs)
