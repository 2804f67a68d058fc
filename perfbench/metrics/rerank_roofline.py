"""The union and re-rank's share of their roofline in the traced segment:
the candidate rows the exact re-rank must read once (the sum over the
segment's queries of their unique candidates, d float32 features each,
``rerank_bound``) over the device time of every kernel that is not the
hash's, the scan's or the merge's, as those readers name them: the
union's sort and dedup, the gather, the margins and their sort.  The
merge's widening of the scan's candidates (elementwise int32 kernels)
cannot be told apart by name and is counted here."""
from perfbench import spec
from perfbench.profiling import fragment_seconds, pattern_seconds

LAYER = "index: union, re-rank"
UNIT = "%"
MOVES = "qps"
SOURCE = "device_trace"


def read(ctx):
    prof, ph, sh = ctx["profile"], ctx["phases"]["traced"], ctx["shape"]
    k = prof["kernels"]
    t = (sum(s for s, _ in k.values())
         - fragment_seconds(k, spec.metric_module("hash_roofline").FRAGMENTS
                            + spec.metric_module("scan_roofline").FRAGMENTS)
         - pattern_seconds(k, spec.metric_module("merge_roofline").PATTERN))
    if t <= 0 or ph["candidates"] <= 0:
        return None
    return 100.0 * ctx["costs"].rerank_bound(ph["candidates"],
                                             sh["d"]).seconds / t
