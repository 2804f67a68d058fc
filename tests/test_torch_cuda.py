"""Each CUDA kernel of the port against its plain PyTorch version, on the card,
and the LM path there: the fp32 decode-vs-forward and card-vs-CPU checks at
full width (qwen3-1.7b, and deepseek-moe-16b's MoE layer and 3 of its
layers), ``ActivationIndexer`` codes at d = 2,048.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
this machine has no usable card (decided when the test runs, never at
import).  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the scans and distances are integer work and must match bit
for bit; both
hashes may differ from their plain versions only in bits whose projection
lies within the float32 rounding bound of zero
(kernels.ref.sign_flip_ratios); the LBH chain within its float32 rounding
bound (kernels.ref.lbh_chain_bound).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.functions import seeded_projections  # noqa: E402
from repro_torch.core.indexer import IndexConfig  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.bilinear_hash import (  # noqa: E402
    FACTORS_LIBRARY, LIBRARY as HASH_LIB, bilinear_hash, bilinear_hash_plain,
    bilinear_hash_seeded, bilinear_hash_seeded_plain)
from repro_torch.kernels.hamming import (  # noqa: E402
    DISTANCE_LIBRARY, FUSED_LIBRARY, LIBRARY as SCAN_LIB, hamming_distance,
    hamming_distance_batch, hamming_distance_batch_plain,
    hamming_distance_plain, hamming_topk_fused, hamming_topk_fused_plain,
    hamming_topk_hist, hamming_topk_hist_dma, hamming_topk_hist_plain)
from repro_torch.kernels.lbh_grad import (  # noqa: E402
    LIBRARY as CHAIN_LIB, lbh_chain, lbh_chain_plain)
from repro_torch.kernels.ref import (lbh_chain_bound,  # noqa: E402
                                     sign_flip_ratios)
from repro_torch.serving.multi_table import MultiTableIndex  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


LIBS = (HASH_LIB, SCAN_LIB, FACTORS_LIBRARY, CHAIN_LIB, FUSED_LIBRARY,
        DISTANCE_LIBRARY)


def test_kernels_build_for_sm90a(cuda):
    _build.build(LIBS)
    for name in LIBS:
        assert _build.library_path(name).exists()
        assert "sm_90a" in _build.build_log(name)


@pytest.mark.parametrize("n,d,k,seeds", [
    (1000, 385, 20, [1, 2, 3, 0xFFFFFFFF]),
    (777, 64, 48, [7, 8, 9]),
    (300, 2001, 64, [5]),
    (129, 3, 1, [11, 12]),
    # past the 3,504 features a whole-row tile once allowed; 26,215 is
    # newsgroups_like(d=26214) with its bias column
    (500, 3505, 20, [1, 2, 3, 4]),
    (300, 3505, 64, [6, 7]),
    (400, 26215, 20, [1, 2, 3, 4]),
    (200, 26215, 64, [8]),
    (32, 385, 20, [1, 2, 3, 4]),            # the query shape
    (2000, 385, 20, [1, 2, 3, 4]),          # an insert batch
    (70, 50, 300, [9, 10]),                 # several column passes
])
def test_hash_kernel_vs_plain(cuda, n, d, k, seeds):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    before = bilinear_hash_seeded.launches
    got = bilinear_hash_seeded(x, seeds, k)
    torch.cuda.synchronize()
    assert bilinear_hash_seeded.launches == before + 1
    want = bilinear_hash_seeded_plain(x, seeds, k)
    assert got.shape == want.shape == (len(seeds), n, -(-k // 32))
    factors = [seeded_projections(s, d, k, cuda) for s in seeds]
    ratios = sign_flip_ratios(x, factors, got, want)
    assert (ratios <= 1.0).all(), ratios.max()


def _scan_inputs(cuda, g, n, w, b, dead, seed=0, kind="random"):
    """Codes, queries and an active mask; kind "ties" repeats one code row
    (every live row at one distance per query), "dead_block" kills rows
    4096-8191."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**32, (g, n, w), dtype=np.uint32)
    codes[..., 0] &= np.uint32(0x3F)          # heavy ties at the cutoff
    if kind == "ties":
        codes[:] = codes[:, :1]
    q = rng.integers(0, 2**32, (g, b, w), dtype=np.uint32)
    act = (rng.random(n) >= dead).astype(np.int32)
    if kind == "dead_block":
        act[4096:8192] = 0
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(cuda)  # noqa: E731
    return t(codes), t(q), torch.from_numpy(act).to(cuda)


# (g, n, w, b, l, dead, block_n, kind) for the hist and argmin kernels
SCAN_CASES = [
    pytest.param(4, 20000, 1, 32, 128, 0.05, 4096, "random",
                 id="delta-20000-5pct"),
    pytest.param(2, 9000, 2, 7, 64, 0.1, 4096, "random", id="w2"),
    pytest.param(1, 300, 1, 5, 400, 0.0, 4096, "random", id="l-gt-n-b5"),
    pytest.param(3, 5000, 4, 3, 4096, 0.5, 4096, "random",
                 id="l-eq-block-w4"),
    pytest.param(1, 4096, 1, 2, 16, 1.0, 4096, "random", id="all-dead"),
    pytest.param(2, 12288, 1, 9, 40, 0.0, 4096, "dead_block",
                 id="one-dead-block"),
    pytest.param(1, 50000, 1, 1, 256, 0.0, 4096, "random", id="b1"),
    pytest.param(2, 9000, 1, 33, 128, 0.05, 4096, "random", id="b33"),
    pytest.param(1, 20000, 2, 64, 128, 0.0, 4096, "random", id="b64"),
    pytest.param(2, 5000, 1, 6, 100, 0.05, 4096, "ties", id="all-tie"),
    pytest.param(1, 3000, 7, 9, 128, 0.1, 4096, "random", id="w7"),
    pytest.param(2, 3000, 1, 12, 64, 0.05, 256, "random", id="block256"),
    pytest.param(1, 1000, 1, 3, 256, 0.0, 256, "random",
                 id="l-eq-block256"),
    pytest.param(1, 30000, 2, 10, 200, 0.05, 8192, "random",
                 id="block8192"),
]


def _kernel_vs_plain(cuda, kern, plain, select, pack, g, n, w, b, l, dead,
                     block_n, kind):
    """kern equals plain before the merge, bit for bit; after the merge
    its route equals the hist route and the CPU plain route."""
    codes, q, act = _scan_inputs(cuda, g, n, w, b, dead, seed=n + b,
                                 kind=kind)
    bn = ops._block_rows(n, block_n)
    l_k = min(l, bn)
    active = act if dead or kind == "dead_block" else None
    before = kern.launches
    kd, ki = kern(codes, q, l_k, bn, active, pack)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    pd, pi = plain(codes, q, l_k, bn, active, pack)
    assert kd.dtype == pd.dtype and ki.dtype == pi.dtype
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    act_b = None if active is None else active.bool()
    got = ops.hamming_topk_grouped(codes, q, l, block_n=block_n, pack=pack,
                                   active=act_b, select=select)
    hist = ops.hamming_topk_grouped(codes, q, l, block_n=block_n, pack=pack,
                                    active=act_b, select="hist")
    want = ops.hamming_topk_grouped(
        codes.cpu(), q.cpu(), l, block_n=block_n, pack=pack,
        active=None if act_b is None else act_b.cpu())
    for a, h, c in zip(got, hist, want):
        assert torch.equal(a, h) and torch.equal(a.cpu(), c)


@pytest.mark.parametrize("pack", ["none", "16", "8"])
@pytest.mark.parametrize("g,n,w,b,l,dead,block_n,kind", SCAN_CASES)
def test_scan_kernel_vs_plain(cuda, pack, g, n, w, b, l, dead, block_n,
                              kind):
    """The hist kernel against its plain version before the merge and the
    plain scan after it: tombstones, l > n, l == block_n, dead blocks,
    query counts off the kernel's chunk of 8, all rows tied, W up to 7."""
    _kernel_vs_plain(cuda, hamming_topk_hist, hamming_topk_hist_plain,
                     "hist", pack, g, n, w, b, l, dead, block_n, kind)


@pytest.mark.parametrize("pack", ["none", "16", "8"])
@pytest.mark.parametrize("g,n,w,b,l,dead,block_n,kind", SCAN_CASES)
def test_argmin_kernel_vs_plain(cuda, pack, g, n, w, b, l, dead, block_n,
                                kind):
    """The (distance, row)-order kernel against its plain version before
    the merge, bit for bit, and after the merge the hist kernel's output,
    on the hist kernel's cases."""
    _kernel_vs_plain(cuda, hamming_topk_fused, hamming_topk_fused_plain,
                     "argmin", pack, g, n, w, b, l, dead, block_n, kind)


@pytest.mark.parametrize("pack", ["none", "16"])
@pytest.mark.parametrize("select", ["hist", "argmin"])
def test_scan_kernels_wide_codes(cuda, pack, select):
    """W = 8: distances up to 256 no longer fit a byte, so the distance
    tile holds 16-bit entries (pack 8 cannot carry them and raises)."""
    kern, plain = ((hamming_topk_hist, hamming_topk_hist_plain)
                   if select == "hist" else
                   (hamming_topk_fused, hamming_topk_fused_plain))
    _kernel_vs_plain(cuda, kern, plain, select, pack, 2, 5000, 8, 9, 64,
                     0.05, 4096, "random")


@pytest.mark.parametrize("pack", ["none", "16", "8"])
@pytest.mark.parametrize("g,n,w,b,l,dead", [
    (4, 20000, 1, 32, 128, 0.05),
    (2, 9000, 2, 7, 64, 0.1),
    (1, 300, 1, 5, 400, 0.0),        # l > n
    (3, 5000, 4, 3, 4096, 0.5),      # l == block_n, W = 4
    (1, 4096, 1, 2, 16, 1.0),        # every row dead
    (2, 1_000_001, 1, 9, 40, 0.0),   # many steps per persistent block
    (1, 50000, 1, 1, 256, 0.0),      # B = 1: one query split over 8 warps
    (2, 9000, 1, 33, 128, 0.05),     # B = 33: the last chunk holds one
])
def test_dma_scan_kernel_vs_plain(cuda, pack, g, n, w, b, l, dead):
    """The pipelined hist kernel equals its plain version and the hist
    kernel before the merge, bit for bit, and after the merge the hist
    kernel's output."""
    codes, q, act = _scan_inputs(cuda, g, n, w, b, dead, seed=n + 1)
    bn = ops._block_rows(n, 4096)
    l_k = min(l, bn)
    active = act if dead else None
    before = hamming_topk_hist_dma.launches
    kd, ki = hamming_topk_hist_dma(codes, q, l_k, bn, active, pack)
    torch.cuda.synchronize()
    assert hamming_topk_hist_dma.launches == before + 1
    pd, pi = hamming_topk_hist_plain(codes, q, l_k, bn, active, pack)
    hd, hi = hamming_topk_hist(codes, q, l_k, bn, active, pack)
    assert kd.dtype == pd.dtype and ki.dtype == pi.dtype
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    assert torch.equal(kd, hd) and torch.equal(ki, hi)
    act_b = None if active is None else active.bool()
    got = ops.hamming_topk_grouped(codes, q, l, pack=pack, active=act_b,
                                   dma=True)
    want = ops.hamming_topk_grouped(codes, q, l, pack=pack, active=act_b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _dma_edge_cases():
    """(w, b, pack) of the pipelined scan's edge test: packs none/16/8
    where the pack holds 32 W (pack 8 only while W <= 7)."""
    return [(w, b, pack) for w in (1, 2, 3, 13, 32) for b in (1, 8, 33)
            for pack in ("none", "16", "8") if pack != "8" or w <= 7]


@pytest.mark.parametrize("w,b,pack", _dma_edge_cases())
def test_dma_scan_bulk_copy_edges(cuda, w, b, pack):
    """The pipelined kernel's bulk copies at their edges: two groups of
    n = 13,001 rows (odd, so n W % 4 != 0 for every W but 32, and the
    second group's codes start off a 16-byte boundary), a partial last
    row block, 5% tombstones, one query, one chunk and a chunk of one
    past 32: equal to the plain version and the hist kernel bit for
    bit."""
    n = 13_001
    codes, q, act = _scan_inputs(cuda, 2, n, w, b, 0.05, seed=w * 100 + b)
    before = hamming_topk_hist_dma.launches
    kd, ki = hamming_topk_hist_dma(codes, q, 100, 4096, act, pack)
    torch.cuda.synchronize()
    assert hamming_topk_hist_dma.launches == before + 1
    pd, pi = hamming_topk_hist_plain(codes, q, 100, 4096, act, pack)
    hd, hi = hamming_topk_hist(codes, q, 100, 4096, act, pack)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    assert torch.equal(kd, hd) and torch.equal(ki, hi)


def test_dma_scan_refuses_two_tiles_that_do_not_fit(cuda):
    """W = 4 at block_n = 8192, the shape whose two whole code tiles once
    did not fit a block: the pipelined kernel now streams sub-tiles, so it
    runs and equals its plain version and the hist kernel."""
    codes, q, _ = _scan_inputs(cuda, 1, 10000, 4, 3, 0.0)
    before = hamming_topk_hist_dma.launches
    hd, hi = hamming_topk_hist(codes, q, 16, 8192, None, "16")
    pd, pi = hamming_topk_hist_plain(codes, q, 16, 8192, None, "16")
    assert torch.equal(hd, pd) and torch.equal(hi, pi)
    kd, ki = hamming_topk_hist_dma(codes, q, 16, 8192, None, "16")
    torch.cuda.synchronize()
    assert hamming_topk_hist_dma.launches == before + 1
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.parametrize("pack", ["none", "16"])
@pytest.mark.parametrize("block_n", [2048, 4096, 8192])
@pytest.mark.parametrize("w", [13, 14, 32])
@pytest.mark.parametrize("select", ["hist", "argmin", "hist_dma"])
def test_wide_code_scans_vs_plain(cuda, select, w, block_n, pack):
    """Wide codes (the select's wide counters) at every block size up to
    8192, l = block_n, 5% tombstones, two query chunks: each kernel equals
    its plain version bit for bit, and the pipelined one the hist
    kernel."""
    kern, plain = {
        "hist": (hamming_topk_hist, hamming_topk_hist_plain),
        "argmin": (hamming_topk_fused, hamming_topk_fused_plain),
        "hist_dma": (hamming_topk_hist_dma, hamming_topk_hist_plain)}[select]
    n = 2 * block_n + 777
    codes, q, act = _scan_inputs(cuda, 2, n, w, 9, 0.05, seed=w + block_n)
    before = kern.launches
    kd, ki = kern(codes, q, block_n, block_n, act, pack)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    pd, pi = plain(codes, q, block_n, block_n, act, pack)
    assert kd.dtype == pd.dtype and ki.dtype == pi.dtype
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    if select == "hist_dma":
        hd, hi = hamming_topk_hist(codes, q, block_n, block_n, act, pack)
        assert torch.equal(kd, hd) and torch.equal(ki, hi)


@pytest.mark.parametrize("n,w,b", [
    (1_060_000, 1, 32),        # the serving shape
    (20011, 2, 7),
    (300, 7, 1),
    (5000, 4, 70),             # three query chunks, the last of 6
    (1, 1, 3),
])
def test_distance_kernels_vs_plain(cuda, n, w, b):
    """Kernels 6 and 7 equal their plain versions bit for bit, and row b of
    the batch equals the single-query kernel on query b."""
    rng = np.random.default_rng(n)
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(cuda)  # noqa: E731
    codes = t(rng.integers(0, 2**32, (n, w), dtype=np.uint32))
    qs = t(rng.integers(0, 2**32, (b, w), dtype=np.uint32))
    before = (hamming_distance.launches, hamming_distance_batch.launches)
    got = hamming_distance_batch(codes, qs)
    rows = [hamming_distance(codes, qs[i]) for i in range(b)]
    torch.cuda.synchronize()
    assert (hamming_distance.launches, hamming_distance_batch.launches) == (
        before[0] + b, before[1] + 1)
    assert got.shape == (b, n) and got.dtype == torch.int32
    assert torch.equal(got, hamming_distance_batch_plain(codes, qs))
    for i in range(b):
        assert torch.equal(rows[i], hamming_distance_plain(codes, qs[i]))
        assert torch.equal(rows[i], got[i])
    assert torch.equal(ops.hamming_distances_batch(codes, qs), got)


@pytest.mark.parametrize("mode", ["scan", "probe"])
def test_service_on_cuda_matches_cpu(cuda, mode):
    """Index and service on the card against the same on the CPU: codes
    equal but for near-zero bits; over the same codes, identical ids for
    every query whose codes agree in all tables."""
    from repro_torch.serving import batch_query as bq
    from repro_torch.serving.service import HashQueryService
    from repro_torch.utils.bits import from_numpy_u32, to_numpy_u32
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3000, 65)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ws = rng.normal(size=(40, 65)).astype(np.float32)
    cfg = IndexConfig(method="bh", bits=20, tables=4, batch=32)
    cpu = MultiTableIndex(cfg, device="cpu").fit(x)
    gpu = MultiTableIndex(cfg, device=cuda).fit(x)
    fams = [(f.u, f.v) for f in cpu.families]
    ratios = sign_flip_ratios(torch.from_numpy(x), fams,
                              from_numpy_u32(np.stack(gpu.codes)),
                              from_numpy_u32(np.stack(cpu.codes)))
    assert (ratios <= 1.0).all()
    qc = to_numpy_u32(bq.hash_queries_all(cpu.families, ws))
    qg = to_numpy_u32(bq.hash_queries_all(gpu.families, ws))
    ratios = sign_flip_ratios(torch.from_numpy(ws), fams,
                              from_numpy_u32(qg), from_numpy_u32(qc))
    assert (ratios <= 1.0).all()
    same = (qc == qg).all(axis=(0, 2))
    assert same.mean() >= 0.9
    gpu.restore(gpu.families, cpu.x_np, cpu.codes, cpu.active, cpu.ids_np,
                cpu._next_id)
    ans = [HashQueryService(index, mode=mode, scan_l=64).query_batch(ws)
           for index in (cpu, gpu)]
    for r_c, r_g, s in zip(*ans, same):
        if s:
            assert r_c.index == r_g.index
            assert np.array_equal(np.sort(r_c.candidates),
                                  np.sort(r_g.candidates))


@pytest.mark.parametrize("n,d,k", [
    (1000, 385, 20), (777, 64, 48), (300, 2001, 64), (129, 3, 1),
    (32, 385, 20), (5000, 100, 32),
    (500, 3505, 20), (300, 3505, 64), (400, 26215, 20), (200, 26215, 64),
    (60, 40, 1000),
])
def test_factor_hash_kernel_vs_plain(cuda, n, d, k):
    rng = np.random.default_rng(n + d)
    x, u, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda) for s in ((n, d), (d, k), (d, k)))
    before = bilinear_hash.launches
    got = bilinear_hash(x, u, v)
    torch.cuda.synchronize()
    assert bilinear_hash.launches == before + 1
    want = bilinear_hash_plain(x, u, v)
    assert got.shape == want.shape == (n, -(-k // 32))
    if k % 32:
        assert not (got[:, -1] >> (k % 32)).any()
    ratios = sign_flip_ratios(x, [(u, v)], got[None], want[None])
    assert (ratios <= 1.0).all(), ratios.max()


@pytest.mark.parametrize("m", [1, 3, 100, 777, 1000, 1001, 4096, 4099])
def test_lbh_chain_kernel_vs_plain(cuda, m):
    """Every element within the chain's rounding bound of the plain
    version, at m % 4 == 0 (16-byte rows) and not, one chunk of 1,024
    columns and several; a second run gives the same bits (one fixed
    summation order per row)."""
    rng = np.random.default_rng(m)
    p, q = (torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(cuda)
            for _ in range(2))
    r = torch.from_numpy(rng.normal(size=(m, m)).astype(np.float32)).to(cuda)
    r = (r + r.T) / 2
    before = lbh_chain.launches
    got = lbh_chain(p, q, r)
    torch.cuda.synchronize()
    assert lbh_chain.launches == before + 1
    for g, w, b in zip(got, lbh_chain_plain(p, q, r),
                       lbh_chain_bound(p, q, r)):
        assert ((g - w).abs() <= b).all()
    again = lbh_chain(p, q, r)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_nesterov_bit_makes_no_host_sync(cuda):
    """The per-bit loop keeps the best-iterate choice on the device."""
    from repro_torch.core import learning as TL
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(200, 40)).astype(np.float32)).to(
        cuda)
    r = torch.from_numpy(rng.normal(size=(200, 200)).astype(np.float32)).to(
        cuda)
    r = (r + r.T) / 2
    u0, v0 = x[0].clone(), x[1].clone()
    torch.cuda.synchronize()
    before = lbh_chain.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        u, v, costs = TL._nesterov_bit(u0, v0, x, r, 10, 0.03 / 200)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert lbh_chain.launches == before + 10
    assert costs.shape == (10,) and torch.isfinite(costs).all()


@pytest.mark.parametrize("m,d,steps", [(200, 40, 10), (1000, 385, 150)])
def test_graphed_nesterov_bit_equals_eager(cuda, m, d, steps):
    """A bit's steps replayed from one CUDA graph give the eager loop's
    best iterate and costs bit for bit, twice in a row (the static
    buffers take each replay's inputs); the warm-up launch counts apart,
    each replay adds its captured launches, and the caller's r is not
    written."""
    from repro_torch.core import learning as TL
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(
        cuda)
    r = torch.from_numpy(rng.normal(size=(m, m)).astype(np.float32)).to(
        cuda)
    r = (r + r.T) / 2
    r_before = r.clone()
    lr = 0.03 / m
    captures, warm = TL.BitLoop.captures, lbh_chain.warmup_launches
    loop = TL.BitLoop(x, steps, lr)
    assert TL.BitLoop.captures == captures + 1
    assert lbh_chain.warmup_launches == warm + 1
    assert loop.chain_launches == steps
    for i in range(2):
        u0, v0 = x[i].clone() * 0.1, x[i + 2].clone() * 0.1
        want = TL._nesterov_bit(u0, v0, x, r, steps, lr)
        before = lbh_chain.launches
        got = TL._nesterov_bit(u0, v0, x, r, steps, lr, loop)
        torch.cuda.synchronize()
        assert lbh_chain.launches == before + steps
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(r, r_before)


def test_learn_lbh_captures_once_per_call(cuda):
    """learn_lbh on the card captures one graph for its 20 bits and
    replays it once per bit."""
    from repro_torch.core import learning as TL
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(300, 65)).astype(np.float32)).to(
        cuda)
    u0, v0 = seeded_projections(7, 65, 20, cuda)
    captures, chain0 = TL.BitLoop.captures, lbh_chain.launches
    res = TL.learn_lbh(x, 20, u0, v0, steps=12)
    torch.cuda.synchronize()
    assert TL.BitLoop.captures == captures + 1
    assert lbh_chain.launches - chain0 == 20 * 12
    assert res.bit_costs.shape == (20, 12)
    assert torch.isfinite(res.bit_costs).all()


def test_hyperplane_index_fits_lbh_through_both_kernels(cuda):
    """fit on the card: LBH learning launches the chain once per Nesterov
    step, the database hash launches the factor kernel once; the learned
    family hashes like the CPU plain version over the same factors."""
    from repro_torch.core.indexer import HyperplaneIndex
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3000, 65)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cfg = IndexConfig(method="lbh", bits=20, lbh_sample=300, lbh_steps=12)
    chain0, hash0 = lbh_chain.launches, bilinear_hash.launches
    idx = HyperplaneIndex(cfg, device=cuda).fit(x)
    torch.cuda.synchronize()
    assert lbh_chain.launches - chain0 == 20 * 12
    assert bilinear_hash.launches - hash0 == 1
    xt = torch.from_numpy(x)
    u, v = idx.family.u.cpu(), idx.family.v.cpu()
    ratios = sign_flip_ratios(xt, [(u, v)], idx.codes.cpu()[None],
                              bilinear_hash_plain(xt, u, v)[None])
    assert (ratios <= 1.0).all()
    w = rng.normal(size=65).astype(np.float32)
    assert idx.query(w).nonempty
    assert 0 <= idx.query_scan(w, 64)[0] < 3000


def _lsm_pair(cuda, select, **kw):
    from repro_torch.serving.lsm import LSMMultiTableIndex
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6000, 65)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cfg = dict(method="bh", bits=20, tables=4, batch=32, lsm_delta_min=256,
               lsm_delta_threshold=0.1, lsm_step_rows=1024,
               lsm_delta_fused_rows=300, fused_select=select)
    cfg.update(kw)
    lsm = LSMMultiTableIndex(IndexConfig(**cfg), device=cuda).fit(x)
    mono = MultiTableIndex(IndexConfig(**cfg), device=cuda).fit(
        x, families=lsm.families)
    return lsm, mono, rng


@pytest.mark.parametrize("select", ["hist", "argmin"])
def test_lsm_stream_on_cuda_matches_monolithic(cuda, select):
    """The LSM index on the card under inserts, deletes and automatic
    compactions: per-table Hamming lists and answers identical to the
    monolithic index over the same rows; both segments go through the
    selected scan kernel once the delta passes lsm_delta_fused_rows."""
    lsm, mono, rng = _lsm_pair(cuda, select)
    ws = rng.normal(size=(32, 65)).astype(np.float32)
    scan = hamming_topk_fused if select == "argmin" else hamming_topk_hist
    before = scan.launches
    for step in range(8):
        xa = rng.normal(size=(250, 65)).astype(np.float32)
        ids = lsm.insert(xa)
        assert np.array_equal(ids, mono.insert(xa))
        dead = np.concatenate([ids[:20], rng.choice(6000, 30, replace=False)
                               + 0])
        dead = dead[mono.active[mono.ids_to_rows(dead)]]
        lsm.delete(dead)
        mono.delete(dead)
        a = lsm.query_scan_batch(ws, l=128, topk=3)
        b = mono.query_scan_batch(ws, l=128, topk=3)
        assert np.array_equal(a.ids_topk, b.ids_topk)
        assert np.array_equal(a.margins_topk, b.margins_topk)
        for ca, cb in zip(a.candidates, b.candidates):
            assert np.array_equal(ca, cb)
        for got, want in zip(lsm.scan_table_topk(ws, l=128),
                             mono.scan_table_topk(ws, l=128)):
            assert np.array_equal(got, want)
    assert lsm.compactions >= 1
    assert scan.launches - before > 2 * 8      # base and delta, each query


def test_async_lsm_with_compactor_on_cuda(cuda):
    """The async front end over the LSM index with the background
    compactor: writes and query futures interleave; every answer equals
    the synchronous service's on a replayed monolithic index."""
    from repro_torch.serving.async_service import AsyncHashQueryService
    from repro_torch.serving.service import HashQueryService
    lsm, mono, rng = _lsm_pair(cuda, "hist", lsm_auto=False,
                               lsm_step_rows=512)
    ws = rng.normal(size=(64, 65)).astype(np.float32)
    sync = HashQueryService(mono, mode="scan", scan_l=128)
    svc = AsyncHashQueryService(lsm, mode="scan", scan_l=128,
                                deadline_ms=2.0)
    lsm.start_compactor()
    try:
        for step in range(10):
            xa = rng.normal(size=(300, 65)).astype(np.float32)
            ids = svc.submit_insert(xa).result(timeout=60)
            assert np.array_equal(ids, mono.insert(xa))
            svc.submit_delete(ids[:10]).result(timeout=60)
            mono.delete(ids[:10])
            futs = [svc.submit(w) for w in ws]
            for f, r in zip(futs, sync.query_batch(ws)):
                got = f.result(timeout=60)
                assert (got.index, got.margin) == (r.index, r.margin)
    finally:
        lsm.stop_compactor()
        svc.close()
    assert lsm.compactions >= 1



def test_refresh_captured_on_a_worker_while_scans_run(cuda, monkeypatch):
    """A refresh with wait=False re-learns LBH on its worker thread, each
    table's bits one CUDA graph captured there, while this thread keeps
    scanning (hash and scan kernels on its own stream, host copies).  The
    refresh succeeds, every answer meanwhile is well formed, the graphed
    families equal the eager loop's bit for bit, and the new generation
    answers like a fresh index installed over the same rows."""
    from repro_torch.core import learning as TL
    from repro_torch.core.indexer import make_family
    from repro_torch.serving.lsm import LSMMultiTableIndex
    from repro_torch.serving.service import HashQueryService
    rng = np.random.default_rng(21)
    x = rng.normal(size=(20_000, 65)).astype(np.float32)
    ws = rng.normal(size=(32, 65)).astype(np.float32)
    cfg = IndexConfig(method="bh", bits=20, tables=2, lsm_auto=False,
                      lbh_sample=400, lbh_steps=30)
    lsm = LSMMultiTableIndex(cfg, device=cuda).fit(x)
    svc = HashQueryService(lsm, mode="scan", scan_l=64)
    svc.query_batch(ws)
    mgr = svc.refresher
    seen = []
    learn = mgr._learn_families

    def seam(shadow_cfg, pool):
        seen.append((shadow_cfg, pool.clone()))
        return learn(shadow_cfg, pool)

    mgr._learn_families = seam
    captures, chain0 = TL.BitLoop.captures, lbh_chain.launches
    scans0 = hamming_topk_hist.launches
    assert svc.refresh(wait=False)
    answered = 0
    while mgr.stats()["busy"]:
        for r in svc.query_batch(ws):
            assert 0 <= r.index < 20_000 and np.isfinite(r.margin)
        answered += 1
    mgr.wait_idle(120)
    torch.cuda.synchronize()
    st = mgr.stats()
    assert (st["refreshes_done"], st["refreshes_failed"],
            st["last_error"]) == (1, 0, None)
    assert lsm.generation == 1 and answered > 0
    assert TL.BitLoop.captures == captures + 2
    assert lbh_chain.launches - chain0 == 2 * 20 * 30
    assert hamming_topk_hist.launches > scans0
    # the eager loop on the same inputs: no BitLoop, autograd steps
    (shadow_cfg, pool), = seen
    monkeypatch.setattr(TL, "BitLoop", lambda *a, **k: None)
    for t, fam in enumerate(lsm.families):
        eager = make_family(shadow_cfg, pool, t)
        assert torch.equal(fam.u, eager.u) and torch.equal(fam.v, eager.v)
    fresh = LSMMultiTableIndex(cfg, device=cuda)
    fresh._install(x, lsm.families)
    a = lsm.query_scan_batch(ws, l=64, topk=4)
    b = fresh.query_scan_batch(ws, l=64, topk=4)
    assert np.array_equal(a.ids_topk, b.ids_topk)
    assert np.array_equal(a.margins_topk, b.margins_topk)


def test_router_on_cuda_matches_fresh_index(cuda):
    """The replicated-shard router's scans run on its shard threads: the
    healthy, fail-over and degraded answers equal a fresh index's over the
    covered rows, and its first kernel uses from those threads count every
    launch."""
    from repro_torch.serving.cluster import ShardReplicaRouter
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.lsm import LSMMultiTableIndex
    rng = np.random.default_rng(22)
    x = rng.normal(size=(30_000, 65)).astype(np.float32)
    ws = rng.normal(size=(32, 65)).astype(np.float32)
    cfg = IndexConfig(method="bh", bits=20, tables=4, lsm_auto=False)
    plan = FaultPlan()
    router = ShardReplicaRouter(cfg, shards=2, replicas=2, fault_plan=plan,
                                deadline_ms=5000.0, device=cuda).fit(x)
    router_scans = 0
    try:
        for kill, rows in (((), np.arange(30_000)),
                           (((0, 1),), np.arange(30_000)),
                           (((1, 0), (1, 1)), np.arange(0, 30_000, 2))):
            for s, r in kill:
                plan.kill(s, r)
            scans0 = hamming_topk_hist.launches
            got = router.query_scan_batch(ws, l=128, topk=4)
            router_scans += hamming_topk_hist.launches - scans0
            ref = LSMMultiTableIndex(cfg, device=cuda).fit(x[rows])
            want = ref.query_scan_batch(ws, l=128, topk=4)
            assert got.coverage == rows.size / 30_000
            assert np.array_equal(got.ids_topk, np.where(
                want.ids_topk >= 0, rows[np.clip(want.ids_topk, 0, None)],
                -1))
            assert np.array_equal(got.margins_topk, want.margins_topk)
        # one scan a covered shard a query: 2 + 2 + 1
        assert router_scans == 5
        assert router.stats()["timeouts"] == 0
    finally:
        router.close()


@pytest.mark.parametrize("d", [65, 385, 26_215])
def test_margins_do_not_depend_on_candidate_position(cuda, d):
    """A row's exact margin is the same wherever it sits among the
    candidates: the same rows gathered one slot further along (every row
    start moved by d floats) give bit-identical margins, as the router's
    cross-shard re-rank needs."""
    from repro_torch.core.search import margin_batch, margin_rerank_batch
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32)).to(
        cuda)
    w = torch.from_numpy(rng.normal(size=(4, d)).astype(np.float32)).to(
        cuda)
    rows = torch.from_numpy(rng.integers(0, 500, (4, 37))).to(cuda)
    valid = torch.ones_like(rows, dtype=torch.bool)
    m0 = margin_batch(x, w, rows, valid)
    for shift in (1, 2, 3, 5):
        pad = torch.zeros((4, shift), dtype=rows.dtype, device=cuda)
        m = margin_batch(x, w, torch.cat([pad, rows], 1),
                         torch.cat([valid[:, :shift], valid], 1))
        assert torch.equal(m[:, shift:], m0)
    top_m, top_i = margin_rerank_batch(x, w, rows, valid, 37)
    assert torch.equal(top_m, torch.gather(m0, 1, torch.argsort(
        m0, dim=1, stable=True)))


@pytest.mark.parametrize("pack", ["none", "16", "8"])
@pytest.mark.parametrize("select", ["hist", "argmin"])
@pytest.mark.parametrize("shards", [2, 3])
def test_grouped_sharded_scan_on_card(cuda, shards, select, pack):
    """The row-sharded scan with S shards co-located on the card equals
    its plain version (the same mesh on the CPU) bit for bit, ragged
    shards, l > a shard's rows and ties included, with one kernel launch
    per shard."""
    from repro_torch.core.search import hamming_topk_grouped_sharded
    from repro_torch.utils.mesh import make_mesh
    rng = np.random.default_rng(shards)
    for n, l in ((70_001, 40), (1001, 600)):
        codes = rng.integers(0, 2**32, (2, n, 1), dtype=np.uint32)
        codes[:, ::3] = codes[:, :1]            # ties across shard ends
        qs = rng.integers(0, 2**32, (2, 5, 1), dtype=np.uint32)
        c_cpu = torch.from_numpy(codes.view(np.int32))
        q_cpu = torch.from_numpy(qs.view(np.int32))
        want = hamming_topk_grouped_sharded(
            c_cpu, q_cpu, l, make_mesh((shards,), ("data",),
                                       devices=["cpu"] * shards),
            select=select, pack=pack)
        kern = hamming_topk_hist if select == "hist" else hamming_topk_fused
        before = kern.launches
        got = hamming_topk_grouped_sharded(
            c_cpu.to(cuda), q_cpu.to(cuda), l,
            make_mesh((shards,), ("data",), devices=["cuda:0"] * shards),
            select=select, pack=pack)
        torch.cuda.synchronize()
        assert kern.launches == before + shards
        assert got[0].device.type == "cuda"
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def test_index_mesh_scan_on_card(cuda):
    """MultiTableIndex and the LSM index (base tombstones: the overscan)
    answer a co-located card mesh exactly as without one."""
    from repro_torch.serving.lsm import LSMMultiTableIndex
    from repro_torch.utils.mesh import make_mesh
    rng = np.random.default_rng(11)
    x = rng.normal(size=(30_001, 64)).astype(np.float32)
    ws = rng.normal(size=(32, 64)).astype(np.float32)
    cfg = IndexConfig(method="bh", bits=20, tables=4, lsm_auto=False)
    for shards in (2, 3):
        mesh = make_mesh((shards,), ("data",), devices=["cuda:0"] * shards)
        for cls in (MultiTableIndex, LSMMultiTableIndex):
            idx = cls(cfg, device=cuda).fit(x)
            if cls is LSMMultiTableIndex:
                idx.delete(rng.choice(30_001, 3_000, replace=False))
                idx.insert(x[:5_000] + 0.01)
            b = idx.query_scan_batch(ws, l=128, topk=4)
            before = hamming_topk_hist.launches
            a = idx.query_scan_batch(ws, l=128, topk=4, mesh=mesh)
            torch.cuda.synchronize()
            # one launch per shard, plus the delta's own scan
            assert hamming_topk_hist.launches - before == shards + (
                cls is LSMMultiTableIndex)
            assert np.array_equal(a.ids_topk, b.ids_topk)
            assert np.array_equal(a.margins_topk, b.margins_topk)
            assert np.array_equal(a.table_hits, b.table_hits)
            for ca, cb in zip(a.candidates, b.candidates):
                assert np.array_equal(ca, cb)


def _qwen3_two_layers(device, dtype=torch.float32, seed=0):
    """qwen3-1.7b at full width, depth cut to 2 layers, seeded weights."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import Transformer, init_params, model_spec
    cfg = dataclasses.replace(get_arch("qwen3-1.7b"), num_layers=2)
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = init_params(model_spec(cfg), dtype, generator=gen, device=device)
    return cfg, tree, Transformer(cfg, tree)


def test_lm_decode_matches_forward_full_width(cuda):
    """fp32 on the card, 2 layers of qwen3-1.7b at full width: a decode
    step after a 16-token prefill reproduces the teacher-forced logits
    (relative error < 3e-3, the JAX package's bound), and the card's
    forward logits agree with the CPU's over the same weights (< 1e-4)."""
    from repro_torch.core.functions import strict_fp32
    from repro_torch.models import Transformer, decode_step, forward
    from repro_torch.models.layers import tree_map
    cfg, tree, model = _qwen3_two_layers(cuda)
    tok = torch.randint(0, cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    with strict_fp32(), torch.inference_mode():
        _, caches, _ = forward(cfg, model, {"tokens": tok[:, :16]},
                               mode="prefill", cache_len=32)
        dec, _ = decode_step(cfg, model, tok[:, 16], caches, 16)
        full, _, _ = forward(cfg, model, {"tokens": tok})
    ref = full[:, 16]
    assert ((dec - ref).abs().max() / ref.abs().max()).item() < 3e-3
    cpu = Transformer(cfg, tree_map(lambda t: t.cpu(), tree))
    with torch.inference_mode():
        want, _, _ = forward(cfg, cpu, {"tokens": tok.cpu()})
    err = (full.cpu() - want).abs().max() / want.abs().max()
    assert err.item() < 1e-4


def test_lm_bf16_card_matches_cpu_full_width(cuda):
    """bf16 on the card, 2 layers of qwen3-1.7b at full width: logits and
    aux["normed"] come in bf16 and lie nearer the CPU's bf16 forward over
    the same weights (held to the JAX package's bf16 forward by
    test_torch_models.py) than the CPU's bf16 forward lies to its fp32
    one (the lower-precision control)."""
    from repro_torch.core.functions import strict_fp32
    from repro_torch.models import Transformer, forward
    from repro_torch.models.layers import tree_map
    cfg, tree, model = _qwen3_two_layers(cuda, dtype=torch.bfloat16)
    tok = torch.randint(0, cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(3))
    cpu16 = Transformer(cfg, tree_map(lambda t: t.cpu(), tree))
    cpu32 = Transformer(cfg, tree, dtype=torch.float32, device="cpu")
    with strict_fp32(), torch.inference_mode():
        got = forward(cfg, model, {"tokens": tok.to(cuda)})
        want = forward(cfg, cpu16, {"tokens": tok})
        ref = forward(cfg, cpu32, {"tokens": tok})
    for j in (0, 2):      # logits, then aux (its "normed")
        g, w, r = ((o[j] if j == 0 else o[j]["normed"]) for o in
                   (got, want, ref))
        assert g.dtype == w.dtype == torch.bfloat16
        control = (w.float() - r).abs().max() / r.abs().max()
        err = (g.float().cpu() - w.float()).abs().max() / w.float().abs().max()
        assert err.item() <= control.item()


@pytest.mark.parametrize("method", ["bh", "lbh"])
def test_activation_indexer_codes_vs_plain_at_d2048(cuda, method):
    """ActivationIndexer over 2-layer full-width qwen3-1.7b activations
    (d = 2,048): the index's codes (kernel 1 for seeded BH; kernels 8 and
    4 for LBH) equal the plain hash on the same activations but for bits
    within the float32 rounding bound of zero."""
    from repro_torch.core.indexer import ActivationIndexer
    from repro_torch.models import forward
    cfg, _, model = _qwen3_two_layers(cuda, dtype=torch.bfloat16)

    @torch.inference_mode()
    def embed(tokens):
        _, _, aux = forward(cfg, model, {"tokens": tokens},
                            return_logits=False)
        return aux["normed"].float().mean(dim=1)

    corpus = torch.randint(0, cfg.vocab_size, (1500, 32),
                           generator=torch.Generator().manual_seed(2))
    icfg = IndexConfig(method=method, bits=20, radius=4, lbh_sample=500,
                       lbh_steps=30)
    seeded0, factor0, chain0 = (bilinear_hash_seeded.launches,
                                bilinear_hash.launches, lbh_chain.launches)
    ai = ActivationIndexer(embed, icfg, batch_size=64, device=cuda)
    idx = ai.build(corpus.to(cuda))
    torch.cuda.synchronize()
    x = ai.embeddings
    assert x.shape == (1500, 2048) and x.dtype == torch.float32
    fam = idx.family
    if method == "bh":
        assert bilinear_hash_seeded.launches - seeded0 == 1
        want = bilinear_hash_seeded_plain(x, [fam.seed], 20)
    else:
        assert bilinear_hash.launches - factor0 == 1
        assert lbh_chain.launches - chain0 == 20 * 30
        want = bilinear_hash_plain(x, fam.u, fam.v)[None]
    ratios = sign_flip_ratios(x, [(fam.u, fam.v)], idx.codes[None], want)
    assert (ratios <= 1.0).all()
    w = x[:64].mean(0) - x[64:128].mean(0)
    i, m = idx.query_scan(w, 256)
    assert 0 <= i < 1500 and np.isfinite(m)


def test_moe_layer_on_card_matches_cpu(cuda):
    """The MoE FFN of deepseek-moe-16b at full width (E 64, top 6, d 2,048,
    moe_d_ff 1,408; one layer's expert weights, 1 / sqrt(d) router) on
    B 8 x S 128 tokens at the published capacity factor, where tokens
    drop: top-k ids with ties come in the CPU's order (lower id first);
    the dispatch's integers equal the CPU's bit for bit; fp32 output
    against the CPU's within 1e-5 relative; bf16 output repeats itself
    bit for bit."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.functions import strict_fp32
    from repro_torch.models import moe
    from repro_torch.models.layers import init_params, tree_map
    cfg = get_arch("deepseek-moe-16b")
    gen = torch.Generator().manual_seed(5)
    p = init_params(moe.moe_spec(cfg), torch.float32, generator=gen,
                    device="cpu")
    p["router"] = (torch.randn(p["router"].shape, generator=gen)
                   / cfg.d_model ** 0.5)
    x = torch.randn(8, 128, cfg.d_model, generator=gen)
    tied = (torch.randint(0, 4, (512, 64), generator=gen) / 4).float()
    for k in (1, 6):
        for a, b in zip(moe.top_k(tied.to(cuda), k), moe.top_k(tied, k)):
            assert torch.equal(a.cpu(), b)
    ids = moe.top_k(torch.softmax(x @ p["router"], -1), 6)[1]
    got = moe._dispatch(cfg, ids.to(cuda))
    want = moe._dispatch(cfg, ids)
    assert not bool(want[3].all())                  # some tokens drop
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    pc = tree_map(lambda t: t.to(cuda), p)
    with strict_fp32(), torch.inference_mode():
        want = moe.apply_moe(cfg, p, x)
        y = moe.apply_moe(cfg, pc, x.to(cuda))
        p16 = tree_map(lambda t: t.to(torch.bfloat16), pc)
        x16 = x.to(cuda, torch.bfloat16)
        y16a = moe.apply_moe(cfg, p16, x16)
        y16b = moe.apply_moe(cfg, p16, x16)
    err = (y.cpu() - want).abs().max() / want.abs().max()
    assert err.item() <= 1e-5
    assert y16a.dtype == torch.bfloat16 and torch.equal(y16a, y16b)


def test_moe_model_decode_matches_forward_on_card(cuda):
    """fp32 on the card, deepseek-moe-16b at full width cut to 3 layers
    (the dense prelude and two stacked MoE blocks) at the drop-free
    capacity factor E / k: a decode step after a 16-token prefill
    reproduces the teacher-forced logits (< 3e-3).  The card against the
    CPU is held per layer by test_moe_layer_on_card_matches_cpu and, over
    the full model's weights, by chip_smoke.py's phase 21."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.functions import strict_fp32
    from repro_torch.models import (Transformer, decode_step, forward,
                                    init_params, model_spec)
    cfg = get_arch("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg, num_layers=3, capacity_factor=(
        cfg.num_experts / cfg.experts_per_token))
    gen = torch.Generator(device=cuda).manual_seed(2)
    model = Transformer(cfg, init_params(model_spec(cfg), torch.float32,
                                         generator=gen, device=cuda))
    tok = torch.randint(0, cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    with strict_fp32(), torch.inference_mode():
        _, caches, _ = forward(cfg, model, {"tokens": tok[:, :16]},
                               mode="prefill", cache_len=32)
        dec, _ = decode_step(cfg, model, tok[:, 16], caches, 16)
        full, _, _ = forward(cfg, model, {"tokens": tok})
    ref = full[:, 16]
    assert ((dec - ref).abs().max() / ref.abs().max()).item() < 3e-3
