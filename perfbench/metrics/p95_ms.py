"""The 95th percentile of a query's latency, submission to answer, over
the measured window (nearest rank).  In the closed micro-batch loop every
query of a batch is submitted when the batch is and answered with it, so
each batch's time stands for its B queries."""
import math

import numpy as np

LAYER = "query service"
UNIT = "ms"
MOVES = "qps"
SOURCE = "host_clock"


def read(ctx):
    lat = np.sort(np.asarray(ctx["phases"]["window"]["latencies_s"],
                             np.float64))
    if lat.size == 0:
        return None
    return 1e3 * float(lat[max(0, math.ceil(0.95 * lat.size) - 1)])
