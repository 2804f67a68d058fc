"""The port's kernel modules on the CPU (each kernel's plain version plus
the shared wrapper code) against the JAX package's kernels, which run here
in Pallas interpret mode through ``repro.kernels.ops`` as
tests/test_kernels.py runs them.

Tolerances, stated per check:
- scan: every (distance, id) pair identical after the merge, ties to the
  lowest id, sentinels and every candidate pack included; the block-local
  layout before the merge is compared at equal block_n;
- seeded and materialised hash: a bit may differ only where a projection
  lies within the float32 rounding bound of zero
  (``kernels.ref.sign_flip_ratios`` <= 1);
- LBH chain given the same p, q, R: within ``kernels.ref.lbh_chain_bound``
  (the m-term sum R b in another order, a few ulp of tanh); the full
  gradient, whose projections X u, X v are also summed in another order,
  within 1e-5 of its largest |entry|;
- margins: rtol 1e-5, plus the float32 rounding bound of the d-term dot
  product, (d + 8)·2^-23·Σ_j |x_j w_j| / ||w||, as an absolute term: torch
  and XLA sum over d in another order, and a small margin is the
  difference of large terms.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import search as jsearch  # noqa: E402
from repro.kernels import hamming as jhamming  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.functions import seeded_projections  # noqa: E402
from repro_torch.kernels import bilinear_hash as tbh  # noqa: E402
from repro_torch.kernels import hamming as thamming  # noqa: E402
from repro_torch.kernels import lbh_grad as tlbh  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.utils.bits import (flip_packed, from_numpy_u32,  # noqa: E402
                                    np_hamming_packed)

PACKS = ("none", "16", "8")


# -- seeded hash -------------------------------------------------------------

# (g, k, n, d): the first six keep their ids; the wide-d cases are the
# widths past 3,504, which the CUDA kernels once refused
SEEDED_CASES = [pytest.param(g, k, 300, 97, id=f"{g}-{k}")
                for g in (1, 3) for k in (20, 48, 64)] + [
    pytest.param(2, 20, 64, 3505, id="wide-d3505"),
    pytest.param(1, 40, 61, 4001, id="wide-d4001"),
]


@pytest.mark.parametrize("g,k,n,d", SEEDED_CASES)
def test_seeded_hash_vs_jax_within_near_zero_bound(g, k, n, d):
    rng = np.random.default_rng(10 * k + g)
    x = rng.normal(size=(n, d)).astype(np.float32)
    seeds = [int(s) for s in rng.integers(0, 2**32, g)]
    want = from_numpy_u32(np.asarray(jops.bilinear_hash_seeded_grouped(
        jnp.asarray(x), jnp.asarray(seeds, jnp.uint32), k)))
    xt = torch.from_numpy(x)
    got = tops.bilinear_hash_seeded_grouped(xt, seeds, k)
    assert got.dtype == torch.int32 and got.shape == want.shape
    # pad bits past k are 0
    rem = k % 32
    if rem:
        assert not (got[..., -1] >> rem).any()
    factors = [seeded_projections(s, d, k) for s in seeds]
    ratios = tref.sign_flip_ratios(xt, factors, got, want)
    assert (ratios <= 1.0).all(), ratios.max()
    # the single-table oracle agrees with the grouped wrapper exactly
    for i, s in enumerate(seeds):
        assert torch.equal(tref.bilinear_hash_seeded_ref(xt, s, k), got[i])


def test_seeds_on_device_copied_once_per_seed_list():
    """The seeded hash's seed list goes to the device once: the same list
    gives the same tensor back, holding the seeds' uint32 bits."""
    seeds = [1, 0xFFFFFFFF, 7]
    first = tbh.seeds_on_device(seeds, torch.device("cpu"))
    assert tbh.seeds_on_device(list(seeds), torch.device("cpu")) is first
    assert first.dtype == torch.int32
    assert first.tolist() == tbh.seeds_as_int32(seeds) == [1, -1, 7]
    assert tbh.seeds_on_device([1, 2], torch.device("cpu")) is not first


def test_sign_flip_ratios_flags_a_bit_far_from_zero():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(20, 16)).astype(np.float32))
    codes = tops.bilinear_hash_seeded_grouped(x, [5], 20)
    bad = codes.clone()
    bad[0, 3, 0] ^= 1 << 7            # a bit no rounding could flip
    assert tref.sign_flip_ratios(x, [seeded_projections(5, 16, 20)],
                                 codes, codes).numel() == 0
    ratios = tref.sign_flip_ratios(x, [seeded_projections(5, 16, 20)],
                                   codes, bad)
    assert ratios.numel() == 1 and ratios.item() > 1.0


# -- materialised-factor hash -----------------------------------------------

@pytest.mark.parametrize("k,n,d", [
    pytest.param(20, 333, 97, id="20"),
    pytest.param(32, 333, 97, id="32"),
    pytest.param(64, 333, 97, id="64"),
    pytest.param(20, 64, 3505, id="wide-d3505"),
    pytest.param(33, 61, 4001, id="wide-d4001"),
])
def test_bilinear_hash_plain_vs_jax_within_near_zero_bound(k, n, d):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(n, d)).astype(np.float32)
    u = rng.normal(size=(d, k)).astype(np.float32)
    v = rng.normal(size=(d, k)).astype(np.float32)
    want = from_numpy_u32(np.asarray(jops.bilinear_hash(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(v))))
    xt, ut, vt = (torch.from_numpy(a) for a in (x, u, v))
    got = tbh.bilinear_hash_plain(xt, ut, vt)
    assert got.dtype == torch.int32 and got.shape == want.shape == (
        n, -(-k // 32))
    assert torch.equal(tops.bilinear_hash(xt, ut, vt), got)  # CPU route
    if k % 32:
        assert not (got[:, -1] >> (k % 32)).any()           # pad bits 0
    ratios = tref.sign_flip_ratios(xt, [(ut, vt)], got[None], want[None])
    assert (ratios <= 1.0).all(), ratios.max()


# -- LBH gradient chain --------------------------------------------------------

@pytest.mark.parametrize("m", [100, 512, 777])
def test_lbh_chain_and_grad_vs_jax(m):
    rng = np.random.default_rng(m)
    d = 48
    x = rng.normal(size=(m, d)).astype(np.float32)
    u = (0.3 * rng.normal(size=(d,))).astype(np.float32)
    v = (0.3 * rng.normal(size=(d,))).astype(np.float32)
    r = rng.normal(size=(m, m)).astype(np.float32)
    r = (r + r.T) / 2
    p, q = x @ u, x @ v
    jsq, jsp = (np.asarray(a) for a in jops.lbh_chain(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(r)))
    pt, qt, rt = (torch.from_numpy(a) for a in (p, q, r))
    tsq, tsp = tlbh.lbh_chain_plain(pt, qt, rt)
    bq, bp = tref.lbh_chain_bound(pt, qt, rt)
    assert (np.abs(tsq.numpy() - jsq) <= bq.numpy()).all()
    assert (np.abs(tsp.numpy() - jsp) <= bp.numpy()).all()
    for a, b in zip(tops.lbh_chain(pt, qt, rt), (tsq, tsp)):   # CPU route
        assert torch.equal(a, b)
    jgu, jgv = (np.asarray(a) for a in jops.lbh_grad(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(v), jnp.asarray(r)))
    tgu, tgv = tops.lbh_grad(torch.from_numpy(x), torch.from_numpy(u),
                             torch.from_numpy(v), rt)
    for got, want in ((tgu, jgu), (tgv, jgv)):
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    rgu, rgv = tref.lbh_grad_ref(torch.from_numpy(x), torch.from_numpy(u),
                                 torch.from_numpy(v), rt)
    assert torch.equal(rgu, tgu) and torch.equal(rgv, tgv)


def test_lbh_chain_bound_flags_a_wrong_chain():
    """The bound is tight enough to see a chain that forgets (1 - b^2)."""
    rng = np.random.default_rng(0)
    m = 100
    p, q = (torch.from_numpy(rng.normal(size=m).astype(np.float32))
            for _ in range(2))
    r = torch.from_numpy(rng.normal(size=(m, m)).astype(np.float32))
    r = (r + r.T) / 2
    sq, _ = tlbh.lbh_chain_plain(p, q, r)
    bq, _ = tref.lbh_chain_bound(p, q, r)
    wrong = (r @ torch.tanh(0.5 * p * q)) * q
    assert ((wrong - sq).abs() > bq).any()


# -- fused scan --------------------------------------------------------------

def _scan_vs_jax(codes, qs, l, active=None, packs=PACKS, block_n=4096,
                 jax_packs=("16",)):
    """Port ops/search paths vs JAX ops (interpret) and JAX hist; all must
    be identical.  Returns the merged (dists, ids)."""
    cj, qj = jnp.asarray(codes), jnp.asarray(qs)
    aj = None if active is None else jnp.asarray(active)
    want_d, want_i = (np.asarray(a) for a in jsearch.hamming_topk_grouped_hist(
        cj, qj, l, aj))
    for pack in jax_packs:
        for select in ("hist", "argmin"):
            jd, ji = jops.hamming_topk_grouped(cj, qj, l, pack=pack,
                                               active=aj, block_n=block_n,
                                               select=select)
            assert np.array_equal(np.asarray(jd), want_d)
            assert np.array_equal(np.asarray(ji), want_i)
    ct, qt = from_numpy_u32(codes), from_numpy_u32(qs)
    at = None if active is None else torch.from_numpy(active)
    paths = {f"ops_{sel}_p{p}": tops.hamming_topk_grouped(
        ct, qt, l, pack=p, active=at, block_n=block_n, select=sel)
        for p in packs for sel in ("hist", "argmin")}
    for p in packs:
        paths[f"ops_hist_dma_p{p}"] = tops.hamming_topk_grouped(
            ct, qt, l, pack=p, active=at, block_n=block_n, select="hist",
            dma=True)
    paths["search_hist"] = tsearch.hamming_topk_grouped_hist(ct, qt, l, at)
    paths["search_lax"] = tsearch.hamming_topk_grouped(ct, qt, l,
                                                       select="argmin",
                                                       active=at)
    for name, (d, i) in paths.items():
        assert d.dtype == i.dtype == torch.int32, name
        assert np.array_equal(d.numpy(), want_d), name
        assert np.array_equal(i.numpy(), want_i), name
    return want_d, want_i


@pytest.mark.parametrize("w", [1, 2, 4, 13, 32])
def test_scan_every_pack_and_width(w):
    """Every pack that is legal at the width (pack 8 carries distances
    below 255, so W <= 7), W = 13 and 32 being the wide codes whose
    kernels take the wide-counter select."""
    rng = np.random.default_rng(w)
    codes = rng.integers(0, 2**32, (2, 700, w), dtype=np.uint32)
    codes[..., 0] &= np.uint32(0xF)          # few distinct values: ties
    qs = rng.integers(0, 2**32, (2, 5, w), dtype=np.uint32)
    packs = tuple(p for p in PACKS if p != "8" or 32 * w < 0xFF)
    _scan_vs_jax(codes, qs, 40, packs=packs, block_n=256,
                 jax_packs=packs if w == 1 else ("16",))


def test_scan_constant_codes_ties_to_lowest_id():
    rng = np.random.default_rng(1)
    codes = np.broadcast_to(rng.integers(0, 2**32, (1, 1, 1),
                                         dtype=np.uint32), (3, 900, 1)).copy()
    qs = rng.integers(0, 2**32, (3, 4, 1), dtype=np.uint32)
    d, i = _scan_vs_jax(codes, qs, 64, block_n=256)
    assert np.array_equal(i, np.broadcast_to(np.arange(64), i.shape))


def test_scan_l_equals_block_n():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 2**32, (2, 1000, 1), dtype=np.uint32)
    qs = rng.integers(0, 2**32, (2, 3, 1), dtype=np.uint32)
    _scan_vs_jax(codes, qs, 256, block_n=256)


def test_scan_l_exceeds_n():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 2**32, (2, 100, 2), dtype=np.uint32)
    qs = rng.integers(0, 2**32, (2, 3, 2), dtype=np.uint32)
    d, i = _scan_vs_jax(codes, qs, 300)
    assert (d[..., 100:] == tsearch.DIST_SENTINEL).all()
    assert (i[..., 100:] == -1).all()


def test_scan_saturated_and_zero_distances():
    rng = np.random.default_rng(4)
    k = 64
    codes = rng.integers(0, 2**32, (2, 500, 2), dtype=np.uint32)
    flipped = np.asarray(flip_packed(from_numpy_u32(codes[:, :3]), k)
                         .numpy().view(np.uint32))
    qs = np.concatenate([codes[:, 10:12], flipped], axis=1)  # d = 0 and k
    d, _ = _scan_vs_jax(codes, qs, 30, block_n=256)
    assert (d[:, :2, 0] == 0).all()


@pytest.mark.parametrize("n,l", [(700, 40), (50, 80)])     # l > n too
def test_single_table_topk_vs_jax(n, l):
    """hamming_topk{,_batch} of search (plain) and ops (the scan kernel's
    route, G = 1) against JAX's: identical (distance, id) pairs."""
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 2**32, (n, 2), dtype=np.uint32)
    codes[:, 0] &= np.uint32(0xFF)                         # ties
    qs = rng.integers(0, 2**32, (5, 2), dtype=np.uint32)
    cj, qj = jnp.asarray(codes), jnp.asarray(qs)
    ct, qt = from_numpy_u32(codes), from_numpy_u32(qs)
    want_b = [np.asarray(a) for a in jsearch.hamming_topk_batch(cj, qj, l)]
    want_1 = [np.asarray(a) for a in jsearch.hamming_topk(cj, qj[0], l)]
    for a, b in zip(want_b, jops.hamming_topk_batch(cj, qj, l,
                                                    block_n=256)):
        assert np.array_equal(a, np.asarray(b))
    for got in (tsearch.hamming_topk_batch(ct, qt, l),
                tops.hamming_topk_batch(ct, qt, l, block_n=256)):
        for a, b in zip(got, want_b):
            assert a.dtype == torch.int32 and np.array_equal(a.numpy(), b)
    for got in (tsearch.hamming_topk(ct, qt[0], l),
                tops.hamming_topk(ct, qt[0], l, block_n=256)):
        for a, b in zip(got, want_1):
            assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("kind", ["partial", "sparse", "all_dead"])
def test_scan_active_masks(kind):
    rng = np.random.default_rng(5)
    n = 1100
    codes = rng.integers(0, 2**32, (2, n, 1), dtype=np.uint32)
    codes[..., 0] &= np.uint32(0xFF)
    qs = rng.integers(0, 2**32, (2, 6, 1), dtype=np.uint32)
    live_p = {"partial": 0.5, "sparse": 0.02, "all_dead": 0.0}[kind]
    active = rng.random(n) < live_p
    d, i = _scan_vs_jax(codes, qs, 48, active=active, block_n=256)
    live = np.flatnonzero(active)
    assert np.isin(i[i >= 0], live).all()
    assert ((d == tsearch.DIST_SENTINEL) == (i < 0)).all()


@pytest.mark.parametrize("dma", [False, True])
@pytest.mark.parametrize("pack", PACKS)
def test_block_local_layout_equals_jax_kernel(pack, dma):
    """Before the merge, at equal block_n: the same (G, grid, B, l) block
    candidates, dtypes and sentinel slots as the Pallas kernel, with
    dma=False (kernel 2's wrapper) and dma=True (kernel 3's)."""
    rng = np.random.default_rng(6)
    g, n, w, b, l, bn = 2, 600, 1, 8, 40, 256
    codes = rng.integers(0, 2**32, (g, n, w), dtype=np.uint32)
    codes[..., 0] &= np.uint32(0x3F)
    qs = rng.integers(0, 2**32, (g, b, w), dtype=np.uint32)
    active = (rng.random(n) < 0.7).astype(np.int32)
    n_pad = -(-n // bn) * bn
    cj = jnp.asarray(np.pad(codes, ((0, 0), (0, n_pad - n), (0, 0))))
    aj = jnp.asarray(np.pad(active, (0, n_pad - n))[:, None])
    jd, ji = jhamming.hamming_topk_hist_kernel(
        cj, jnp.asarray(qs), l, n, active=aj, block_n=bn, interpret=True,
        pack=pack, dma=dma)
    scan = thamming.hamming_topk_hist_dma if dma else \
        thamming.hamming_topk_hist
    td, ti = scan(from_numpy_u32(codes), from_numpy_u32(qs), l, bn,
                  torch.from_numpy(active), pack)
    assert str(td.dtype).split(".")[-1] == str(np.asarray(jd).dtype)
    assert str(ti.dtype).split(".")[-1] == str(np.asarray(ji).dtype)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("pack", PACKS)
@pytest.mark.parametrize("case", ["tombstones", "l_exceeds_n", "all_dead",
                                  "w2_ties"])
def test_fused_block_layout_equals_jax_kernel(pack, case):
    """Kernel 5's plain version before the merge, at equal block_n: the
    same (G, grid, B, l) candidates in distance order, dtypes and
    exhausted slots (pack sentinel, row 0) as the Pallas argmin kernel."""
    rng = np.random.default_rng(16)
    g, n, w, b, l, bn = 2, 600, 1, 8, 40, 256
    active = (rng.random(n) < 0.7).astype(np.int32)
    if case == "l_exceeds_n":
        n, l, active = 100, 256, (rng.random(100) < 0.8).astype(np.int32)
    elif case == "all_dead":
        active[256:512] = 0                      # block 1 has no live row
    elif case == "w2_ties":
        w = 2
    codes = rng.integers(0, 2**32, (g, n, w), dtype=np.uint32)
    codes[..., 0] &= np.uint32(0x3F)                     # many ties
    qs = rng.integers(0, 2**32, (g, b, w), dtype=np.uint32)
    n_pad = -(-n // bn) * bn
    cj = jnp.asarray(np.pad(codes, ((0, 0), (0, n_pad - n), (0, 0))))
    aj = jnp.asarray(np.pad(active, (0, n_pad - n))[:, None])
    jd, ji = jhamming.hamming_topk_fused_kernel(
        cj, jnp.asarray(qs), l, n, active=aj, block_n=bn, interpret=True,
        pack=pack)
    td, ti = thamming.hamming_topk_fused(
        from_numpy_u32(codes), from_numpy_u32(qs), l, bn,
        torch.from_numpy(active), pack)
    assert str(td.dtype).split(".")[-1] == str(np.asarray(jd).dtype)
    assert str(ti.dtype).split(".")[-1] == str(np.asarray(ji).dtype)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    _, _, sent = thamming.cand_encoding(pack, w, bn)
    exhausted = td.numpy() == sent
    assert exhausted.any() or case not in ("l_exceeds_n", "all_dead")
    assert (ti.numpy()[exhausted] == 0).all()
    # after the merge: identical to the hist select and to JAX's argmin
    at = torch.from_numpy(active.astype(bool))
    got = tops.hamming_topk_grouped(from_numpy_u32(codes),
                                    from_numpy_u32(qs), l, block_n=bn,
                                    active=at, pack=pack, select="argmin")
    want = tops.hamming_topk_grouped(from_numpy_u32(codes),
                                     from_numpy_u32(qs), l, block_n=bn,
                                     active=at, pack=pack, select="hist")
    jm = jops.hamming_topk_grouped(jnp.asarray(codes), jnp.asarray(qs), l,
                                   block_n=bn, active=jnp.asarray(
                                       active.astype(bool)),
                                   pack=pack, select="argmin")
    for a, bb, c in zip(got, want, jm):
        assert torch.equal(a, bb) and np.array_equal(a.numpy(), np.asarray(c))


@pytest.mark.parametrize("pack,w,block_n", [
    ("8", 8, 256), ("16", 1, 0x8001), ("8", 1, 0x8001), ("bogus", 1, 256),
    ("none", 99, 10**6), ("16", 1023, 256), ("8", 7, 0x8000)])
def test_cand_encoding_guards_match_jax(pack, w, block_n):
    def outcome(fn, name):
        try:
            d, i, s = fn(pack, w, block_n)
        except ValueError:
            return "raise"
        return name(d), name(i), s
    assert (outcome(thamming.cand_encoding,
                    lambda t: str(t).replace("torch.", ""))
            == outcome(jhamming.cand_encoding, lambda t: np.dtype(t).name))


def test_block_rows_matches_jax():
    for n in (1, 100, 256, 300, 4095, 4096, 10**6):
        for bn in (256, 4096):
            assert tops._block_rows(n, bn) == jops._block_rows(n, bn)


def test_select_and_pack_env(monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_SELECT", "argmin")
    monkeypatch.setenv("REPRO_CAND_PACK", "8")
    assert tsearch.env_fused_select() == "argmin"
    assert tsearch.env_cand_pack() == "8"
    assert tsearch.env_fused_select("hist") == "hist"
    with pytest.raises(ValueError):
        tsearch.env_cand_pack("4")
    with pytest.raises(ValueError):
        tsearch.env_fused_select("heap")


# -- distance kernels and the pipelined scan ---------------------------------

@pytest.mark.parametrize("n,w", [(1000, 1), (4096, 4), (100, 2), (1, 1),
                                 (2049, 7), (300, 1), (257, 3), (11, 2)])
def test_hamming_distances_vs_jax(n, w):
    """ops.hamming_distances (kernel 7's route) against JAX's, at the
    shapes of tests/test_kernels.py and n that no block size divides."""
    rng = np.random.default_rng(n + w)
    codes = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    q = rng.integers(0, 2**32, (w,), dtype=np.uint32)
    want = np.asarray(jops.hamming_distances(jnp.asarray(codes),
                                             jnp.asarray(q)))
    ct, qt = from_numpy_u32(codes), from_numpy_u32(q)
    got = tops.hamming_distances(ct, qt)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(thamming.hamming_distance_plain(ct, qt), got)
    assert torch.equal(tref.hamming_distance_ref(ct, qt), got)


@pytest.mark.parametrize("n,b,w", [(1000, 1, 1), (512, 32, 2), (100, 5, 2),
                                   (2049, 9, 4), (300, 40, 1)])
def test_hamming_distances_batch_vs_jax(n, b, w):
    """ops.hamming_distances_batch (kernel 6's route) against JAX's, (B, n)
    with row b equal to the single-query distances of query b."""
    rng = np.random.default_rng(n + b)
    codes = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    qs = rng.integers(0, 2**32, (b, w), dtype=np.uint32)
    want = np.asarray(jops.hamming_distances_batch(jnp.asarray(codes),
                                                   jnp.asarray(qs)))
    ct, qt = from_numpy_u32(codes), from_numpy_u32(qs)
    got = tops.hamming_distances_batch(ct, qt)
    assert got.dtype == torch.int32 and got.shape == (b, n)
    assert np.array_equal(got.numpy(), want)
    for i in range(b):
        assert torch.equal(got[i], tops.hamming_distances(ct, qt[i]))


@pytest.mark.parametrize("pack", PACKS)
@pytest.mark.parametrize("case", ["w1", "w1_active", "w2", "w2_active",
                                  "l_exceeds_n"])
def test_dma_scan_vs_jax(pack, case):
    """ops.hamming_topk_grouped(dma=True) against JAX's with dma=True (the
    Pallas double-buffered kernel in interpret mode): identical (distance,
    id) pairs after the merge, and identical to dma=False."""
    rng = np.random.default_rng(len(case))
    g, n, b, l = 2, 700, 5, 40
    w = 2 if case.startswith("w2") else 1
    if case == "l_exceeds_n":
        n, l = 100, 300
    codes = rng.integers(0, 2**32, (g, n, w), dtype=np.uint32)
    codes[..., 0] &= np.uint32(0xF)                        # ties
    qs = rng.integers(0, 2**32, (g, b, w), dtype=np.uint32)
    active = (rng.random(n) < 0.6) if case.endswith("active") else None
    aj = None if active is None else jnp.asarray(active)
    at = None if active is None else torch.from_numpy(active)
    jd, ji = (np.asarray(a) for a in jops.hamming_topk_grouped(
        jnp.asarray(codes), jnp.asarray(qs), l, block_n=256, dma=True,
        active=aj, pack=pack))
    ct, qt = from_numpy_u32(codes), from_numpy_u32(qs)
    td, ti = tops.hamming_topk_grouped(ct, qt, l, block_n=256, dma=True,
                                       active=at, pack=pack)
    assert np.array_equal(td.numpy(), jd) and np.array_equal(ti.numpy(), ji)
    hd, hi = tops.hamming_topk_grouped(ct, qt, l, block_n=256, active=at,
                                       pack=pack)
    assert torch.equal(td, hd) and torch.equal(ti, hi)
    if case == "l_exceeds_n":
        assert (ti.numpy()[..., n:] == -1).all()


@pytest.mark.parametrize("n,l", [(1500, 40), (700, 256), (90, 60)])
def test_unfused_route_equals_fused_scan(n, l):
    """The unfused route of benchmarks/serving_scan.py (the full (B, n)
    distance matrix per table, then the lexicographic smallest l) equals
    the fused scan, lists and ids alike, for both hist kernels' routes."""
    rng = np.random.default_rng(n)
    g, b = 3, 6
    codes = rng.integers(0, 2**32, (g, n, 1), dtype=np.uint32)
    codes[..., 0] &= np.uint32(0x3F)                       # ties
    qs = rng.integers(0, 2**32, (g, b, 1), dtype=np.uint32)
    ct, qt = from_numpy_u32(codes), from_numpy_u32(qs)
    ids = torch.arange(n, dtype=torch.int32).expand(b, n)
    unfused = [tsearch.lex_smallest(tops.hamming_distances_batch(ct[i],
                                                                 qt[i]),
                                    ids, l) for i in range(g)]
    ud = torch.stack([d for d, _ in unfused])
    ui = torch.stack([i for _, i in unfused])
    for dma in (False, True):
        fd, fi = tops.hamming_topk_grouped(ct, qt, l, block_n=256, dma=dma)
        assert torch.equal(ud, fd) and torch.equal(ui, fi)
    jd, ji = jsearch.hamming_topk_grouped_hist(jnp.asarray(codes),
                                               jnp.asarray(qs), l)
    assert np.array_equal(ud.numpy(), np.asarray(jd))
    assert np.array_equal(ui.numpy(), np.asarray(ji))


def test_hamming_distance_ref():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 2**32, (50, 3), dtype=np.uint32)
    q = rng.integers(0, 2**32, (3,), dtype=np.uint32)
    got = tref.hamming_distance_ref(from_numpy_u32(codes), from_numpy_u32(q))
    assert np.array_equal(got.numpy(), np_hamming_packed(codes, q[None]))


# -- exact-margin re-rank ----------------------------------------------------

def _margin_bound(x, w, cand):
    """(B, C) float32 rounding bound of |w . x_c| / ||w|| for each slot."""
    terms = np.abs(x[cand] * w[:, None, :]).sum(-1)
    return (x.shape[1] + 8) * 2.0 ** -23 * terms / np.linalg.norm(
        w, axis=1, keepdims=True)


def test_margin_rerank_and_margin_batch_vs_jax():
    rng = np.random.default_rng(8)
    n, d, b, c = 400, 33, 6, 50
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(b, d)).astype(np.float32)
    cand = rng.integers(0, n, (b, c))
    valid = rng.random((b, c)) < 0.8
    jm, ji = jsearch.margin_rerank_batch(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(cand),
                                         jnp.asarray(valid), 5)
    tm, ti = tsearch.margin_rerank_batch(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(cand),
        torch.from_numpy(valid), 5)
    bound = _margin_bound(x, w, cand)
    want_m = np.asarray(jm)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    sel = _margin_bound(x, w, np.asarray(ji))
    assert np.all(np.abs(tm.numpy() - want_m)
                  <= 1e-5 * np.abs(want_m) + sel)
    cand_pad = np.where(valid, cand, -1)
    jmb = jsearch.margin_batch(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(cand_pad), jnp.asarray(valid))
    tmb = tsearch.margin_batch(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(cand_pad),
                               torch.from_numpy(valid))
    want_mb = np.asarray(jmb)
    assert np.isinf(tmb.numpy()[~valid]).all()
    assert np.isinf(want_mb[~valid]).all()
    assert np.all(np.abs(tmb.numpy()[valid] - want_mb[valid])
                  <= (1e-5 * np.abs(want_mb) + bound)[valid])


@pytest.mark.parametrize("l", [1, 7, 60])
def test_margin_rerank_single_query_vs_jax(l):
    rng = np.random.default_rng(l)
    n, d, c = 300, 41, 50
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    cand = rng.integers(0, n, c)
    cand[5] = cand[9]                  # a repeated id ties with itself
    jm, ji = (np.asarray(a) for a in jsearch.margin_rerank(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(cand), l))
    tm, ti = tsearch.margin_rerank(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(cand), l)
    assert ti.shape == tm.shape == (min(l, c),)
    assert np.array_equal(ti.numpy(), ji)
    bound = _margin_bound(x, w[None], ji[None])[0]
    assert np.all(np.abs(tm.numpy() - jm) <= 1e-5 * np.abs(jm) + bound)


def test_margin_batch_rows_do_not_depend_on_the_batch():
    """The multiply + reduce keeps a row's margin independent of the rows
    around it: a batch of B equals B single queries bit for bit."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(300, 65)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(7, 65)).astype(np.float32))
    cand = torch.from_numpy(rng.integers(0, 300, (7, 40)))
    valid = torch.ones(7, 40, dtype=torch.bool)
    full = tsearch.margin_batch(x, w, cand, valid)
    for i in range(7):
        one = tsearch.margin_batch(x, w[i:i + 1], cand[i:i + 1],
                                   valid[i:i + 1])
        assert torch.equal(one[0], full[i])
