"""The port-side checks on the CPU: the launch contracts of the CUDA
kernels (``repro_torch.kernels.contracts``), held to the JAX package's
sentinel rules and to the port's own ``cand_encoding``, and the capture
sentinel (``repro_torch.utils.captures.CaptureCounter``).  The contracts'
``*_fits`` reckonings and the launches of the sweep are held to the built
libraries' ``*_fits`` and ``*_plan`` exports on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 31."""
import pytest

torch = pytest.importorskip("torch")

from repro.lint import kernel_contracts as jkc  # noqa: E402
from repro_torch.kernels import contracts as C  # noqa: E402
from repro_torch.kernels import hamming  # noqa: E402
from repro_torch.utils.captures import (CaptureCounter,  # noqa: E402
                                        capture_targets)

PACKS = ("none", "16", "8")


def test_the_sweep_holds_every_contract():
    cases = C.sweep()
    kernels = {case.kernel for case, _ in cases}
    assert kernels == {"hist", "hist_dma", "fused", "distance",
                       "distance_batch", "bilinear_hash",
                       "bilinear_hash_seeded", "lbh_chain", "cand_lists",
                       "shard_select", "row_margins"}
    assert len(cases) > 150
    assert C.run() == []


@pytest.mark.parametrize("pack", PACKS)
def test_sentinel_verdicts_match_jax_and_cand_encoding(pack):
    for w in range(1, 40):
        for block_n in (1, 128, 4096, 8192, 32768, 32769, 65536):
            legal = C.pack_is_legal(pack, w, block_n)
            assert legal == jkc.pack_is_legal(pack, w, block_n)
            try:
                hamming.cand_encoding(pack, w, block_n)
                refused = False
            except ValueError:
                refused = True
            assert refused == (not legal), (pack, w, block_n)


def test_every_case_names_a_declared_plan_export():
    """compare_plans' calls on the card: each case of the sweep maps to a
    library's ``*_plan`` export, declared with one argument per value it
    is given and its output pointer last."""
    exports = set()
    for case, _ in C.sweep():
        library, export, args = C.plan_export(case)
        restype, argtypes = C._LIBRARY_SIGNATURES[library][export]
        assert len(argtypes) == len(args) + 1, case.case_id
        assert all(isinstance(a, int) for a in args), case.case_id
        exports.add(export)
    assert exports == {"topk_hist_plan", "topk_hist_dma_plan",
                       "topk_fused_plan", "distance_plan",
                       "distance_batch_plan", "bh_plan", "bh_seeded_plan",
                       "lbh_chain_plan", "cand_lists_plan",
                       "shard_select_plan", "row_margins_plan"}


def test_uint8_ceiling():
    assert C.pack_is_legal("8", 7, 8192)          # 224 < 255
    assert not C.pack_is_legal("8", 8, 8192)      # 256 reaches it
    assert C.pack_is_legal("16", 32, 8192)
    assert not C.pack_is_legal("16", 1, 32770)    # ids past int16
    verdicts = {case.case_id: got for case, got in C.sweep()
                if case.kernel == "hist"}
    assert not isinstance(verdicts["hist-bn2048-w7-b32-l128-8"], ValueError)
    assert isinstance(verdicts["hist-bn2048-w8-b32-l128-8"], ValueError)


def test_a_broken_cand_encoding_is_caught(monkeypatch):
    real = hamming.cand_encoding
    monkeypatch.setattr(hamming, "cand_encoding",
                        lambda pack, w, block_n: (torch.int32, torch.int32,
                                                  0x3FFFFFFF))
    assert any(f.startswith("sentinel-collision") for f in C.run())

    def strict(pack, w, block_n):
        if pack != "none":
            raise ValueError("refused")
        return real(pack, w, block_n)
    monkeypatch.setattr(hamming, "cand_encoding", strict)
    assert any(f.startswith("sentinel-over-strict") for f in C.run())


def test_check_launch_flags_each_limit():
    ok = C.Launch("k", (2 ** 31 - 1, 65535, 65535), 1024, C.MAX_SMEM - 8, 8)
    assert C.check_launch(ok, "ok") == []
    assert C.check_launch(C.Launch("k", (1, 1, 1), 256, C.MAX_SMEM, 1),
                          "s")[0].startswith("smem-over-budget")
    assert C.check_launch(C.Launch("k", (1, 65536, 1), 256, 0),
                          "y")[0].startswith("grid-y-z")
    assert C.check_launch(C.Launch("k", (2 ** 31, 1, 1), 256, 0),
                          "x")[0].startswith("grid-y-z")
    assert C.check_launch(C.Launch("k", (1, 1, 1), 1025, 0),
                          "t")[0].startswith("threads")


def test_fits_reckonings():
    # every W <= 32 at every block_n <= 8,192 (the kernels' own comment)
    for fits in (C.topk_hist_fits, C.topk_hist_dma_fits,
                 C.topk_fused_fits):
        for w in range(1, 33):
            for block_n in (128, 1024, 4096, 8192):
                assert fits(w, block_n), (fits.__name__, w, block_n)
        # a 16-bit kept-row id names at most 65,536 rows
        assert not fits(1, 65537)
    assert C.widest_w(C.topk_hist_dma_fits, 8192, 128) <= \
        C.widest_w(C.topk_hist_fits, 8192, 128)
    # a chunk of 32 queries of W words: 4 * 32 * W <= 232,448 bytes
    assert C.distance_fits(1816) and not C.distance_fits(1817)
    # the serving shape takes chunks of 8 queries; wide codes, whose
    # lane-private counters do not fit beside the tile, the wide counters
    assert C.choose_select(1, 4096, 128) == (False, 8)
    assert C.choose_select(12, 2048, 2048)[0] is False
    assert C.choose_select(13, 2048, 2048)[0] is True


def test_launch_geometry_at_the_serving_shape():
    """Tiny-1M's scan: 4 tables of 1.06M one-word codes, 32 queries,
    block_n 4,096, l 128."""
    n = 1_060_000
    hist = C.launch_scan("hist", 4, n, 1, 32, 128, 4096)
    assert hist.grid == (4 * 259 * 4, 1, 1) and hist.threads == 256
    assert hist.dynamic_smem <= C.MAX_SMEM
    dma = C.launch_scan("hist_dma", 4, n, 1, 32, 128, 4096)
    # four warp groups take the 32 queries in one pass
    assert dma.threads == 1024 and dma.grid[0] <= 4 * 259
    # one resident block a multiprocessor: a persistent grid of 132
    assert C.launch_scan("hist_dma", 4, n, 1, 32, 128, 4096,
                         per_sm=1).grid == (C.SMS, 1, 1)
    gen, prod = C.launch_hash(n, 385, 20, 4)
    assert gen.grid == (-(-385 * 80 // 256), 1, 1)
    assert prod.threads == 256 and prod.grid[1] == 1
    assert C.launch_lbh_chain(1000).static_smem == 8192
    assert C.launch_distance(n, 1, 33).grid == (-(-n // 256), 2, 1)
    with pytest.raises(ValueError):
        C.launch_scan("hist", 1, 10, 1, 1, 0, 256)          # l below 1
    with pytest.raises(ValueError):
        C.launch_scan("fused", 1, 10, 8, 1, 4, 256, pack="8")


# -- the hash product's plans ----------------------------------------------

# (n, k, G) of the query micro-batches: news20's 20 normals, tiny1m's 10
# and a batch of 32; a tile's grid fills none of them
@pytest.mark.parametrize("n,k,g", [(20, 16, 1), (10, 20, 1), (32, 20, 1)])
def test_query_shapes_take_the_chain_plan(n, k, g):
    p = C.choose_product(n, k, g)
    assert p.chain and p.tm == C.CHAIN
    # blocks of 4 rows x 4 columns: a warp of their 32 chains (each the u
    # or the v product of a row and column) and one that fills the ring
    assert p.cols == g * k and p.threads == 64 and p.ncg == 8
    assert p.rg == 4 and p.row_blocks == -(-n // 4)
    assert p.passes == -(-g * k // 4)
    assert p.row_blocks * p.passes <= C.SMS
    # one block an SM: the widest stage that fits the ring's budget
    assert p.td == 512 and p.smem <= C.CHAIN_SMEM
    gen, prod = C.launch_hash(n, 385, k, g)
    assert prod.threads == 64 and prod.grid == (p.row_blocks, p.passes, 1)
    # the generation also copies x's rows, padded, for the bulk copies
    assert gen.grid == (-(-(385 * g * k + n * 385) // 256), 1, 1)


# today's fill plans, field by field: news20's fit, tiny1m's fit, a card of
# the four-card fit, an insert batch of 2,000 rows
@pytest.mark.parametrize("n,k,g,want", [
    (18_846, 16, 1, (2, 2, 32, 8, 16, 1, 295, 25600)),
    (1_060_000, 20, 1, (4, 4, 51, 5, 20, 1, 5197, 68608)),
    (19_840_505, 20, 1, (4, 4, 51, 5, 20, 1, 97258, 68608)),
    (2000, 20, 1, (1, 1, 12, 20, 20, 1, 167, 19456)),
])
def test_fill_shapes_keep_their_plans(n, k, g, want):
    p = C.choose_product(n, k, g)
    assert not p.chain
    assert (p.tm, p.tn, p.rg, p.ncg, p.cols, p.passes, p.row_blocks,
            p.smem) == want
    assert (p.threads, p.td) == (C.THREADS, 32)


def test_chain_ring_shrinks_where_blocks_share_an_sm():
    """1,000 rows of 20 columns: 250 x 5 blocks, 10 an SM, so the ring
    takes 64 d a stage and all of them are resident at once; any number of
    columns takes the chain plan (a block holds 4 of them)."""
    p = C.choose_product(1000, 20, 1)
    assert p.chain and (p.row_blocks, p.passes, p.td) == (250, 5, 64)
    assert 10 * (p.smem + C.SMEM_RESERVED) <= C.SMEM_PER_SM
    wide = C.choose_product(32, 20, 7)
    assert wide.chain and wide.passes == 35
    assert C.chain_plan(3, 1, 1).rg == 3


@pytest.mark.parametrize("g", [1, 4, 7])
def test_every_product_launch_is_named_for_hash_roofline(g):
    """The benchmark finds the seeded hash's device time by name: each
    launch of kernel 1, at every plan, holds one of its fragments; kernel
    4's product keeps ``bilinear_hash_kernel``."""
    from perfbench.metrics import hash_roofline
    for n, d, k in ((10, 385, 20), (20, 26_215, 16), (32, 385, 20),
                    (2000, 385, 20), (1_060_000, 385, 20)):
        for launch in C.launch_hash(n, d, k, g):
            assert any(f in launch.kernel for f in hash_roofline.FRAGMENTS)
        factors = [la.kernel for la in C.launch_hash(n, d, k)]
        assert factors[-1] == "bilinear_hash_kernel"
        assert factors[:-1] == (["bilinear_hash_transpose_kernel"]
                                if C.choose_product(n, k, 1).chain else [])


def test_the_hash_kernels_sweep_holds_every_contract():
    cases = [(case, got) for case, got in C.sweep()
             if case.kernel in ("bilinear_hash", "bilinear_hash_seeded")]
    assert len(cases) >= 30
    chains = 0
    for case, got in cases:
        assert not isinstance(got, ValueError), case.case_id
        for launch in (got if isinstance(got, list) else [got]):
            assert C.check_launch(launch, case.case_id) == []
            chains += launch.threads < C.THREADS
    assert chains >= 10


# -- the capture sentinel --------------------------------------------------

class _Graphs:
    captures = 0


def test_capture_counter_fails_on_a_capture_in_the_window():
    cc = CaptureCounter({"graphs": (_Graphs, "captures")})
    before = cc.snapshot()
    with cc.assert_no_capture():
        pass
    _Graphs.captures += 1                     # outside: fine
    assert cc.deltas(before) == {"graphs": 1}
    with pytest.raises(AssertionError, match="capture-stable"):
        with cc.assert_no_capture():
            _Graphs.captures += 2
    assert cc.deltas(before) == {"graphs": 3}


def test_capture_targets_are_the_ports_counters():
    from repro_torch.core.learning import BitLoop
    from repro_torch.kernels.lbh_grad import lbh_chain
    targets = capture_targets()
    assert targets["core.learning.BitLoop.captures"] == (BitLoop, "captures")
    assert targets["kernels.lbh_grad.lbh_chain.captured"] == (lbh_chain,
                                                              "captured")
    cc = CaptureCounter()
    snap = cc.snapshot()
    assert set(snap) == set(targets)
    with cc.assert_no_capture():          # CPU work captures nothing
        hamming.hamming_distance(torch.zeros((4, 1), dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32))
