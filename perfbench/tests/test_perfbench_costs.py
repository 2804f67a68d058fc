"""The benchmark's frozen bound arithmetic (``perfbench/costs.py``) equals
the program's (``repro_torch.kernels.ops``) at the cells' shapes and at
the shapes of PERF.md's kernel table, and reads that table's bounds."""
import pytest

torch = pytest.importorskip("torch")

from perfbench import costs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# (n, d, k, g): the cells' query batches and the table's fit / query rows
HASH_SHAPES = [(10, 385, 20, 1), (20, 26215, 16, 1), (32, 385, 20, 4),
               (1_060_000, 385, 20, 4), (1, 385, 20, 4)]
# (n, w, b, l, g, active): the cells' scans and the table's scan shapes
SCAN_SHAPES = [(1_060_000, 1, 10, 6264, 1, False),
               (18_846, 1, 20, 201, 1, False),
               (1_080_000, 1, 32, 128, 4, True),
               (1_060_000, 1, 32, 128, 4, False),
               (100_000, 13, 32, 128, 2, True),
               (100_000, 32, 32, 128, 2, True)]


@pytest.mark.parametrize("n,d,k,g", HASH_SHAPES)
@pytest.mark.parametrize("seeded", (True, False))
def test_hash_bound_is_the_programs(n, d, k, g, seeded):
    assert costs.hash_bound(n, d, k, g=g, seeded=seeded) == tuple(
        ops.hash_bound(n, d, k, g=g, seeded=seeded))


@pytest.mark.parametrize("n,w,b,l,g,active", SCAN_SHAPES)
@pytest.mark.parametrize("pack", ("16", "8", "none"))
def test_scan_bound_is_the_programs(n, w, b, l, g, active, pack):
    if pack == "8" and 32 * w >= 0xFF:
        with pytest.raises(ValueError):
            costs.scan_bound(n, w, b, l, g=g, active=active, pack=pack)
        return
    assert costs.scan_bound(n, w, b, l, g=g, active=active,
                            pack=pack) == tuple(
        ops.scan_bound(n, w, b, l, g=g, active=active, pack=pack))


# the live rows of the table's 5%-tombstoned shapes, as it counted them
@pytest.mark.parametrize("bound,ms", [
    (lambda: costs.hash_bound(1_060_000, 385, 20, g=4, seeded=True),
     1.9491),
    (lambda: costs.scan_bound(1_060_000, 1, 32, 128, g=4), 0.032446),
    (lambda: costs.scan_bound(100_000, 13, 32, 128, g=2, active=True,
                              live_rows=94_998), 0.018901),
    (lambda: costs.scan_bound(100_000, 32, 32, 128, g=2, active=True,
                              live_rows=94_922), 0.046488),
    (lambda: costs.scan_bound(1_060_000, 1, 32, 128, g=4, active=True,
                              live_rows=1_006_822), 0.030818),
])
def test_bounds_read_the_kernel_table(bound, ms):
    assert f"{bound().ms:.5g}" == f"{ms:.5g}"


@pytest.mark.parametrize("n,b,l,pair,out", [
    # tiny1m-scan-round10: 259 blocks of 4,096 rows emit every row
    (1_060_000, 10, 6264, 10 * 259 * 4096 * 4, 10 * 6264 * 8),
    # news20-rerank-round20: 5 blocks of 4,096, 201 candidates each
    (18_846, 20, 201, 20 * 5 * 201 * 4, 20 * 201 * 8),
    # l past every candidate: the merge writes what there is
    (300, 2, 500, 2 * 1 * 304 * 4, 2 * 304 * 8)])
def test_merge_bound_reads_the_scans_candidates_once(n, b, l, pair, out):
    m = costs.merge_bound(n, 1, b, l)
    assert m.bytes == pair + out and m.operations == 0 and m.by == "bytes"
    assert m.seconds == pytest.approx(m.bytes / costs.HBM_BYTES_S)
    # the candidate term is the one scan_bound counts as written
    s = costs.scan_bound(n, 1, b, l)
    assert s.bytes - (n + b) * 4 == pair


def test_rerank_bound_counts_candidate_rows_once():
    b = costs.rerank_bound(256 * 500, 385)
    assert b.bytes == 256 * 500 * 385 * 4 and b.by == "bytes"
    assert b.seconds == pytest.approx(b.bytes / costs.HBM_BYTES_S)


def test_rates_are_the_programs():
    from repro_torch.utils import h100
    assert (costs.FP32_FLOP_S, costs.HBM_BYTES_S, costs.SMS,
            costs.MAX_SM_CLOCK_HZ, costs.POPC_PER_CLK_SM) == (
        h100.FP32_FLOP_S, h100.HBM_BYTES_S, h100.SMS, h100.MAX_SM_CLOCK_HZ,
        h100.POPC_PER_CLK_SM)
