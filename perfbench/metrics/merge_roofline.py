"""The scan's merge's share of its roofline in the traced segment: the
frozen ``merge_bound`` of each micro-batch (the block-local candidates the
scan wrote, read once, and the top-l out) over the device time of the
merge's kernels, told apart by name: the sorts keyed by int64 (the packed
(distance, id) keys of ``core/search.lex_smallest``; the union and the
re-rank sort int32 ids and float32 margins) and the int64 shifts and
masks that pack and unpack those keys."""
import re

from perfbench.profiling import pattern_seconds

LAYER = "index: scan"
UNIT = "%"
MOVES = "qps"
SOURCE = "device_trace"
PATTERN = re.compile(r"DeviceRadixSortPolicy<long,|SortKVInPlace<(?:-?\d+, )+"
                     r"long,|[lr]shift_kernel_cuda|Bitwise(?:Or|And)Functor"
                     r"<long>")


def read(ctx):
    prof, ph, sh = ctx["profile"], ctx["phases"]["traced"], ctx["shape"]
    t = pattern_seconds(prof["kernels"], PATTERN)
    if t <= 0:
        return None
    bound = ctx["costs"].merge_bound(sh["n"], sh["w"], sh["b"], sh["l"],
                                     g=sh["g"])
    return 100.0 * ph["batches"] * bound.seconds / t
