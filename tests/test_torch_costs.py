"""The port's kernel cost models and bounds on the CPU.

- The reference's cost models (``kernels/ops.py``: ``scan_cand_model``,
  ``scan_traffic_model``, ``hash_traffic_model``, ``scan_select_model``)
  against the JAX package's, as integers, over a grid of shapes, packs,
  selects and groups: exact.
- The reference's own assertions on them (``tests/test_kernels.py``),
  mirrored on the port's functions.
- The H100 bound of each kernel family (``hash_bound``, ``scan_bound``,
  ``distance_bound``, ``lbh_chain_bound``) against the bound column of
  PERF.md's kernel table at 132 SMs and 1,980 MHz, to 5 significant
  figures, at ``chip_smoke.py``'s shapes; and its bytes and operations
  against counts worked by hand at more shapes, packs and clocks: exact.
- The one-device step floor (``launch.dryrun.one_device_record``)
  against ``record(account(...))`` on a 1 x 1 mesh for a reduced arch's
  decode, prefill and train steps: exact.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.sharding.rules import MeshShape  # noqa: E402
from repro_torch.utils import h100  # noqa: E402

NS = (100, 4096, 4097, 1_060_000)
WS = (1, 2, 13, 32)
BS = (1, 32)
LS = (1, 16, 128, 512, 5000)
GS = (1, 4)
PACKS = ("none", "16", "8")
SELECTS = ("hist", "argmin")
BLOCKS = (4096, 8192)


def k_of(w: int) -> int:
    """A bit count of w words that is not a multiple of 32 where it can
    be (the last word part-filled)."""
    return 32 * w - (5 if w > 1 else 12)


def _grid_cases(n):
    """(port, reference) call pairs of every model at n over the grid."""
    for w, b, l, g, pack, bn in itertools.product(WS, BS, LS, GS, PACKS,
                                                 BLOCKS):
        yield ("scan_cand_model", (n, b, l, bn, g, pack), {})
        for fused in (True, False):
            yield ("scan_traffic_model", (n, w, b, l),
                   dict(block_n=bn, fused=fused, g=g, pack=pack))
    for w, b, l, g, select, bn in itertools.product(WS, BS, LS, GS, SELECTS,
                                                   BLOCKS):
        yield ("scan_select_model", (n, b, l),
               dict(k=k_of(w), block_n=bn, select=select, g=g))
    for w, g, seeded, d in itertools.product(WS, GS, (False, True),
                                             (64, 385, 2560)):
        yield ("hash_traffic_model", (n, d, k_of(w)),
               dict(g=g, seeded=seeded))


@pytest.mark.parametrize("model", ["scan_cand_model", "scan_traffic_model",
                                   "scan_select_model",
                                   "hash_traffic_model"])
@pytest.mark.parametrize("n", NS)
def test_models_equal_the_reference_as_integers(model, n):
    cases = [c for c in _grid_cases(n) if c[0] == model]
    assert cases
    for name, args, kw in cases:
        got = getattr(ops, name)(*args, **kw)
        want = getattr(jops, name)(*args, **kw)
        assert type(got) is int and got == want, (name, args, kw, got, want)


def test_model_constants_equal_the_reference():
    assert ops.WORD == jops.WORD == 32
    assert ops.CAND_PAIR_BYTES == jops.CAND_PAIR_BYTES
    # the pair widths are the ones the port's kernels write
    for pack, nbytes in ops.CAND_PAIR_BYTES.items():
        dd, di, _ = ops.cand_encoding(pack, 1, 4096)
        assert (torch.empty((), dtype=dd).element_size()
                + torch.empty((), dtype=di).element_size()) == nbytes


# -- the reference's assertions, on the port ----------------------------------

def test_scan_select_model():
    """The histogram select is cheaper than argmin wherever the serving
    paths operate (l >= 8), its advantage growing with l."""
    ratios = []
    for l in (8, 32, 128, 512):
        a = ops.scan_select_model(1_000_000, 32, l, select="argmin")
        h = ops.scan_select_model(1_000_000, 32, l, select="hist")
        assert a > 0 and h > 0 and a > h
        ratios.append(a / h)
    assert ratios == sorted(ratios)
    assert ratios[2] >= 8.0


def test_scan_traffic_model():
    """Fused traffic beats unfused by >= 4x at B = 32, W = 4; at B = 1
    fused never moves more bytes."""
    n, w, b, l = 1_000_000, 4, 32, 16
    unfused = ops.scan_traffic_model(n, w, b, l, fused=False)
    fused = ops.scan_traffic_model(n, w, b, l, fused=True)
    assert unfused / fused >= 4.0
    assert (ops.scan_traffic_model(n, w, 1, l, fused=True)
            <= ops.scan_traffic_model(n, w, 1, l, fused=False))


def test_scan_cand_model_packs_and_grouped():
    """int16 pairs halve the candidate bytes, uint8 distances take
    another quarter, a grouped launch scales the term by G; only the
    candidate term of the fused traffic shrinks."""
    n, b, l = 1_000_000, 32, 128
    base = ops.scan_cand_model(n, b, l, pack="none")
    assert base == ops.scan_cand_model(n, b, l) * 2
    assert ops.scan_cand_model(n, b, l, pack="16") * 2 == base
    assert ops.scan_cand_model(n, b, l, pack="8") * 8 == base * 3
    g = 6
    assert (ops.scan_cand_model(n, b, l, g=g, pack="16")
            == g * ops.scan_cand_model(n, b, l, pack="16"))
    w = 4
    fused_none = ops.scan_traffic_model(n, w, b, l, fused=True, pack="none")
    fused_16 = ops.scan_traffic_model(n, w, b, l, fused=True, pack="16")
    assert n * w * 4 < fused_16 < fused_none
    assert fused_none - fused_16 == base / 2


def test_hash_traffic_model_seeded():
    """Seeded hashing drops exactly the factor bytes from every table's
    pass, and keeps the per-table advantage at every g."""
    b, d, k, g = 32, 64, 128, 4
    mat = ops.hash_traffic_model(b, d, k)
    seeded = ops.hash_traffic_model(b, d, k, seeded=True)
    assert mat - seeded == 2 * d * k * 4
    assert mat / seeded >= 2.0
    assert ops.hash_traffic_model(b, d, k, g=g, seeded=True) == g * seeded
    assert (ops.hash_traffic_model(b, d, k, g=g)
            / ops.hash_traffic_model(b, d, k, g=g, seeded=True)
            >= mat / seeded)


# -- the H100 bounds ----------------------------------------------------------

def sig5(x: float) -> float:
    return float(f"{x:.5g}")


# chip_smoke.py's shapes: the tiny1m-like corpus (n, d), k bits, g tables,
# B queries, l candidates, the LBH scan's l, the activation rows
N, D, K, G, B, L = 1_060_000, 385, 20, 4, 32, 128
LBH_L, ACT_N = 256, 8192
# the live rows of its 5%-tombstone masks at its default --seed 0,
# --batches 16: the base, its last 20,000 rows, phase 15's 100,000 rows at
# W = 13 and 32 (its chip log prints the bounds they give)
LIVE_BASE, LIVE_DELTA, LIVE_W13, LIVE_W32 = 1_006_822, 18_963, 94_998, 94_922

# PERF.md's kernel table, bound column: row -> (function, args, keywords,
# bound ms, what bounds it); the rows marked with a dagger there are
# computed, not measured
PERF_BOUNDS = {
    "1 fit": ("hash_bound", (N, D, K), dict(g=G, seeded=True),
              1.9491, "operations"),
    "1 query": ("hash_bound", (B, D, K), dict(g=G, seeded=True),
                5.8842e-05, "operations"),
    "1 d 2560": ("hash_bound", (ACT_N, 2560, K), dict(seeded=True),
                 0.025050, "bytes"),
    "4 fit": ("hash_bound", (N, D, K), dict(seeded=False),
              0.48857, "bytes"),
    "4 query": ("hash_bound", (B, D, K), dict(seeded=False),
                3.3137e-05, "bytes"),
    "4 d 2048": ("hash_bound", (ACT_N, 2048, K), dict(seeded=False),
                 0.020140, "bytes"),
    "4 d 2560": ("hash_bound", (ACT_N, 2560, K), dict(seeded=False),
                 0.025173, "bytes"),
    "2, 3 serving": ("scan_bound", (N, 1, B, L), dict(g=G),
                     0.032446, "operations"),
    "2, 3 W 13": ("scan_bound", (100_000, 13, B, L),
                  dict(g=2, live_rows=LIVE_W13, active=True),
                  0.018901, "operations"),
    "2, 3 W 32": ("scan_bound", (100_000, 32, B, L),
                  dict(g=2, live_rows=LIVE_W32, active=True),
                  0.046488, "operations"),
    "5 base, 5% tombstoned": ("scan_bound", (N, 1, B, L),
                              dict(g=G, live_rows=LIVE_BASE, active=True),
                              0.030818, "operations"),
    "6 B 32": ("distance_bound", (N, 1, B), {}, 0.041767, "bytes"),
    "7 B 1": ("distance_bound", (N, 1, 1), {}, 0.0025313, "bytes"),
    "8 m 1000": ("lbh_chain_bound", (1000,), {}, 0.0011988, "bytes"),
}


@pytest.mark.parametrize("row", sorted(PERF_BOUNDS))
def test_bounds_reproduce_the_perf_table(row):
    fn, args, kw, ms, by = PERF_BOUNDS[row]
    bd = getattr(ops, fn)(*args, **kw)
    assert sig5(bd.ms) == ms and bd.by == by, (row, bd)


def test_hash_bound_reads_x_once_and_the_model_once_per_table():
    n, d, k, g = 1_060_000, 385, 20, 4
    bd = ops.hash_bound(n, d, k, g=g, seeded=True)
    assert bd.bytes == n * d * 4 + g * n * 4 + g * 4
    assert bd.operations == 4 * n * d * k * g
    assert (ops.hash_traffic_model(n, d, k, g=g, seeded=True) - bd.bytes
            == (g - 1) * n * d * 4 - g * 4)
    mat = ops.hash_bound(n, d, k, g=g, seeded=False)
    assert mat.bytes - bd.bytes == g * (2 * d * k * 4 - 4)
    assert mat.seconds == pytest.approx(bd.seconds)    # operations-bound


# (function, args, keywords, bytes, operations) worked by hand: a grid of
# 259 blocks of 4,096 rows over N, 5 over 20,000; candidate pairs of 4
# bytes at pack 16, 8 at none, 3 at 8 (a uint8 distance, an int16 id)
BY_HAND = {
    "scan serving": ("scan_bound", (N, 1, B, L), dict(g=G),
                     G * (N + B) * 4 + G * 259 * B * L * 4, G * N * B),
    "scan serving, pack none": (
        "scan_bound", (N, 1, B, L), dict(g=G, pack="none"),
        G * (N + B) * 4 + G * 259 * B * L * 8, G * N * B),
    "scan serving, pack 8": (
        "scan_bound", (N, 1, B, L), dict(g=G, pack="8"),
        G * (N + B) * 4 + G * 259 * B * L * 3, G * N * B),
    "scan base": ("scan_bound", (N, 1, B, L),
                  dict(g=G, live_rows=LIVE_BASE, active=True),
                  G * (N + B) * 4 + N * 4 + G * 259 * B * L * 4,
                  G * LIVE_BASE * B),
    "scan LBH query": ("scan_bound", (N, 1, 1, LBH_L), {},
                       (N + 1) * 4 + 259 * LBH_L * 4, N),
    "scan delta": ("scan_bound", (20_000, 1, B, L),
                   dict(g=G, live_rows=LIVE_DELTA, active=True),
                   G * 20_032 * 4 + 20_000 * 4 + G * 5 * B * L * 4,
                   G * LIVE_DELTA * B),
    "hash seeded, 32 rows": ("hash_bound", (32, D, K),
                             dict(g=G, seeded=True),
                             32 * D * 4 + G * 32 * 4 + G * 4,
                             4 * 32 * D * K * G),
    "hash seeded, 8192 rows": ("hash_bound", (8192, D, K),
                               dict(g=G, seeded=True),
                               8192 * D * 4 + G * 8192 * 4 + G * 4,
                               4 * 8192 * D * K * G),
    "hash, 32 rows": ("hash_bound", (32, D, K), dict(seeded=False),
                      32 * D * 4 + 32 * 4 + 2 * D * K * 4, 4 * 32 * D * K),
    "hash, 8192 rows, 2 words": (
        "hash_bound", (8192, D, 48), dict(g=2, seeded=False),
        8192 * D * 4 + 2 * 8192 * 2 * 4 + 2 * 2 * D * 48 * 4,
        4 * 8192 * D * 48 * 2),
    "distance, 8192 rows, B 1": ("distance_bound", (8192, 1, 1), {},
                                 (8192 + 1 + 8192) * 4, 8192),
    "distance, 8192 rows, B 32, W 2": (
        "distance_bound", (8192, 2, 32), {},
        (8192 * 2 + 32 * 2 + 32 * 8192) * 4, 8192 * 32 * 2),
}


@pytest.mark.parametrize("mhz", [1980.0, 1755.0])
@pytest.mark.parametrize("case", sorted(BY_HAND))
def test_bound_terms_worked_by_hand(case, mhz):
    """Bytes and operations equal the hand count; the time is the larger
    of the two terms, popcounts at the clock given."""
    fn, args, kw, nbytes, n_ops = BY_HAND[case]
    if fn != "hash_bound":
        kw = dict(kw, sms=132, clock_hz=mhz * 1e6)
    rate = (16 * 132 * mhz * 1e6 if fn != "hash_bound"
            else h100.FP32_FLOP_S)
    bd = getattr(ops, fn)(*args, **kw)
    assert (bd.bytes, bd.operations) == (nbytes, n_ops), case
    t_bytes, t_ops = nbytes / h100.HBM_BYTES_S, n_ops / rate
    assert bd.seconds == max(t_bytes, t_ops)
    assert bd.by == ("operations" if t_ops > t_bytes else "bytes")


def test_bound_record_and_rates():
    bd = ops.lbh_chain_bound(1000)
    assert bd == (bd.seconds, "bytes", (1000 ** 2 + 4000) * 4,
                  2 * 1000 ** 2 + 6000)
    assert bd.ms == 1e3 * bd.seconds
    assert h100.popc_s() == 16 * 132 * 1.98e9
    # a wider code word costs popcounts: W = 32 is operations-bound
    assert ops.scan_bound(100_000, 32, 32, 128, g=2).by == "operations"
    # a pack the codes cannot carry raises, as the kernels' wrappers do
    with pytest.raises(ValueError):
        ops.scan_bound(1000, 8, 32, 16, pack="8")


def test_candidate_lists_bound_is_its_bytes():
    """Kernel 9 at chip_smoke.py's serving shape (B 32, C = 4 tables x
    128): the slots and flags once, the kept ids once, the lists once."""
    bd = ops.candidate_lists_bound(B, G * L, 9000)
    assert (bd.bytes, bd.operations) == (
        B * G * L * 5 + 9000 * 8 + B * (G * L + 2) * 8, 0)
    assert bd.seconds == bd.bytes / h100.HBM_BYTES_S and bd.by == "bytes"


@pytest.mark.parametrize("candidates, d", [(62_640, 385), (4_020, 26_215),
                                           (1_172_368, 385)])
def test_row_margins_bound_is_the_rows_read_once(candidates, d):
    """Kernel 11 at the cells' shapes (tiny1m, news20, a card of the
    four-card cell): every candidate row's d float32 read once; 2 d
    multiply-adds a row, far below the float32 rate."""
    bd = ops.row_margins_bound(candidates, d)
    assert (bd.bytes, bd.operations) == (candidates * d * 4,
                                         2 * candidates * d)
    assert bd.seconds == bd.bytes / h100.HBM_BYTES_S and bd.by == "bytes"


# -- the one-device step floor ------------------------------------------------

@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_one_device_floor_is_the_account_floor(kind):
    cfg = treg.REDUCED["qwen3-1.7b"]
    shape = ShapeConfig("t", 32, 2, kind)
    kw = dict(dtype=torch.float32) if kind == "train" else \
        dict(dtype=torch.bfloat16)
    got = dryrun.one_device_record(cfg, shape, **kw)
    one = MeshShape(("data", "model"), (1, 1))
    want = dryrun.record(dryrun.account(cfg, shape, one,
                                        dryrun.count_step(cfg, shape, **kw)))
    assert got["devices"] == 1
    assert got["roofline"]["step_floor_s"] == \
        want["roofline"]["step_floor_s"] > 0
    assert got["roofline"]["bound"] == want["roofline"]["bound"]
