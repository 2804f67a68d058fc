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
