"""The scan kernels' share of their roofline in the traced segment: the
frozen ``scan_bound`` of each micro-batch's grouped scan (n rows of W
words against B queries, block-local top-l, in g tables) over the device
time of the kernels whose name holds a fragment below (any select or
route of the fused scan).  The merge that follows is ``merge_roofline``'s."""
from perfbench.profiling import fragment_seconds

LAYER = "index: scan"
UNIT = "%"
MOVES = "qps"
SOURCE = "device_trace"
FRAGMENTS = ("topk_hist", "topk_fused")


def read(ctx):
    prof, ph, sh = ctx["profile"], ctx["phases"]["traced"], ctx["shape"]
    t = fragment_seconds(prof["kernels"], FRAGMENTS)
    if t <= 0:
        return None
    bound = ctx["costs"].scan_bound(sh["n"], sh["w"], sh["b"], sh["l"],
                                    g=sh["g"])
    return 100.0 * ph["batches"] * bound.seconds / t
