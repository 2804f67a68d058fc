"""The per-card select's share of its roofline over the device wall of its
spans: over the traced segment's micro-batches, the frozen
``costs_mesh.shard_select_bound`` of one card's rows (its shard of R rows
against the batch's B queries in g tables, and the most rows any card
selected, its ``index.shard_select`` spans' ``candidates``, at one card's
rates) over the longest card's summed ``index.shard_select`` device wall
(the histogram pass, the select pass and any wait inside the spans)."""
from perfbench import costs_mesh, mesh_spans

LAYER = "index: scan"
UNIT = "%"
MOVES = "qps"
SOURCE = "program_span"


def read(ctx):
    bs = mesh_spans.batches(ctx)
    if not bs:
        return None
    sh = ctx["shape"]
    bound_s = wall_ns = 0
    for b in bs:
        if not b["candidates"]:
            return None
        bound_s += costs_mesh.shard_select_bound(
            sh["shard_rows"], sh["w"], sh["b"], max(b["candidates"].values()),
            g=sh["g"]).seconds
        wall_ns += mesh_spans.longest(b["select"])
    if wall_ns <= 0:
        return None
    return 100.0 * bound_s / (1e-9 * wall_ns)
