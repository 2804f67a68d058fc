"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
this machine has no usable card (decided when the test runs, never at
import).  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the scan is integer work and must match bit for bit; the hash
may differ from its plain version only in bits whose projection lies
within the float32 rounding bound of zero (kernels.ref.sign_flip_ratios).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.functions import seeded_projections  # noqa: E402
from repro_torch.core.indexer import IndexConfig  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.bilinear_hash import (  # noqa: E402
    LIBRARY as HASH_LIB, bilinear_hash_seeded, bilinear_hash_seeded_plain)
from repro_torch.kernels.hamming import (  # noqa: E402
    LIBRARY as SCAN_LIB, hamming_topk_hist, hamming_topk_hist_plain)
from repro_torch.kernels.ref import sign_flip_ratios  # noqa: E402
from repro_torch.serving.multi_table import MultiTableIndex  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_kernels_build_for_sm90a(cuda):
    _build.build([HASH_LIB, SCAN_LIB])
    for name in (HASH_LIB, SCAN_LIB):
        assert _build.library_path(name).exists()
        assert "sm_90a" in _build.build_log(name)


@pytest.mark.parametrize("n,d,k,seeds", [
    (1000, 385, 20, [1, 2, 3, 0xFFFFFFFF]),
    (777, 64, 48, [7, 8, 9]),
    (300, 2001, 64, [5]),
    (129, 3, 1, [11, 12]),
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


def _scan_inputs(cuda, g, n, w, b, dead, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**32, (g, n, w), dtype=np.uint32)
    codes[..., 0] &= np.uint32(0x3F)          # heavy ties at the cutoff
    q = rng.integers(0, 2**32, (g, b, w), dtype=np.uint32)
    act = (rng.random(n) >= dead).astype(np.int32)
    t = lambda a: torch.from_numpy(a.view(np.int32)).to(cuda)  # noqa: E731
    return t(codes), t(q), torch.from_numpy(act).to(cuda)


@pytest.mark.parametrize("pack", ["none", "16", "8"])
@pytest.mark.parametrize("g,n,w,b,l,dead", [
    (4, 20000, 1, 32, 128, 0.0),
    (2, 9000, 2, 7, 64, 0.1),
    (1, 300, 1, 5, 400, 0.0),        # l > n
    (3, 5000, 4, 3, 4096, 0.5),      # l == block_n
    (1, 4096, 1, 2, 16, 1.0),        # every row dead
])
def test_scan_kernel_vs_plain(cuda, pack, g, n, w, b, l, dead):
    codes, q, act = _scan_inputs(cuda, g, n, w, b, dead)
    bn = ops._block_rows(n, 4096)
    l_k = min(l, bn)
    active = act if dead else None
    before = hamming_topk_hist.launches
    kd, ki = hamming_topk_hist(codes, q, l_k, bn, active, pack)
    torch.cuda.synchronize()
    assert hamming_topk_hist.launches == before + 1
    pd, pi = hamming_topk_hist_plain(codes, q, l_k, bn, active, pack)
    assert kd.dtype == pd.dtype and ki.dtype == pi.dtype
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    got = ops.hamming_topk_grouped(codes, q, l, pack=pack,
                                   active=None if active is None
                                   else active.bool())
    want = ops.hamming_topk_grouped(codes.cpu(), q.cpu(), l, pack=pack,
                                    active=None if active is None
                                    else active.bool().cpu())
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_argmin_select_raises_on_cuda(cuda):
    codes, q, _ = _scan_inputs(cuda, 1, 100, 1, 2, 0.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.hamming_topk_grouped(codes, q, 8, select="argmin")


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
