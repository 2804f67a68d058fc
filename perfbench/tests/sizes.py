"""Sizes at which the benchmark's cells run on a CPU in a test: the
configurations' data, the mixes and the checks cut down; every other
number is the cell's own."""

SIZES = {
    "tiny1m-scan-round10": {
        "data": {"n_labeled": 600, "n_unlabeled": 5000, "d": 32},
        "traffic": {"scan_l": 64, "pool_batches": 4},
        "check": {"sample_batches": 4}},
    "news20-rerank-round20": {
        "data": {"n": 400, "d": 600},
        "traffic": {"scan_l": 16, "pool_batches": 4},
        "check": {"sample_batches": 2}},
}
CELLS = tuple(SIZES)
