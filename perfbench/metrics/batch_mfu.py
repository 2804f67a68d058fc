"""The whole query step's share of the chip's peak over the measured
(untraced) window: the sum of the hash, scan, merge and re-rank bounds of
the window's micro-batches over the window's wall time on the host's
clock (each ``query_batch`` call ends in host arrays, so the window holds
every batch's whole step).  It counts the index's operations and bytes,
the only work a step does."""
LAYER = "query service"
UNIT = "%"
MOVES = "qps"
SOURCE = "host_clock"


def read(ctx):
    ph, sh, c = ctx["phases"]["window"], ctx["shape"], ctx["costs"]
    if ph["wall_s"] <= 0 or ph["batches"] == 0:
        return None
    n, w, b, l, g = sh["n"], sh["w"], sh["b"], sh["l"], sh["g"]
    floor = ph["batches"] * (
        c.hash_bound(b, sh["d"], sh["k"], g=g, seeded=True).seconds
        + c.scan_bound(n, w, b, l, g=g).seconds
        + c.merge_bound(n, w, b, l, g=g).seconds)
    floor += c.rerank_bound(ph["candidates"], sh["d"]).seconds
    return 100.0 * floor / ph["wall_s"]
