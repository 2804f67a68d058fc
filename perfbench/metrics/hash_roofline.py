"""The hash kernels' share of their roofline in the traced segment: the
frozen ``hash_bound`` of each micro-batch's call (B normals, d features,
k bits, every table seeded) over the device time of the kernels whose
name holds a fragment below (the seeded hash's generate and product)."""
from perfbench.profiling import fragment_seconds

LAYER = "index: hash"
UNIT = "%"
MOVES = "qps"
SOURCE = "device_trace"
FRAGMENTS = ("bh_seeded",)


def read(ctx):
    prof, ph, sh = ctx["profile"], ctx["phases"]["traced"], ctx["shape"]
    t = fragment_seconds(prof["kernels"], FRAGMENTS)
    if t <= 0:
        return None
    bound = ctx["costs"].hash_bound(sh["b"], sh["d"], sh["k"], g=sh["g"],
                                    seeded=True)
    return 100.0 * ph["batches"] * bound.seconds / t
