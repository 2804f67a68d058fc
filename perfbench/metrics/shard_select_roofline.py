"""The cutoff exchange's kernels' share of their roofline in the traced
segment: the frozen ``costs_mesh.shard_select_bound`` of each micro-batch's
work over all the cards (the n valid rows of the pool against B queries
in g tables, the g B l rows of the top-l written) over the device time of
the kernels whose name holds a fragment below, summed over the cards
(the histogram pass, the offsets and the select of
``repro_torch/kernels/csrc/shard_select.cu``).  The summed bound is no
more than the sum of each card's, so the share cannot pass 100."""
from perfbench import costs_mesh
from perfbench.profiling import fragment_seconds

LAYER = "index: scan"
UNIT = "%"
MOVES = "qps"
SOURCE = "device_trace"
FRAGMENTS = ("shard_hist_kernel", "shard_offsets_kernel",
             "shard_select_kernel")


def read(ctx):
    prof, ph, sh = ctx["profile"], ctx["phases"]["traced"], ctx["shape"]
    t = fragment_seconds(prof["kernels"], FRAGMENTS)
    if t <= 0:
        return None
    bound = costs_mesh.shard_select_bound(
        sh["n"], sh["w"], sh["b"], sh["g"] * sh["b"] * min(sh["l"], sh["n"]),
        g=sh["g"])
    return 100.0 * ph["batches"] * bound.seconds / t
