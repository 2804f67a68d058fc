"""The port's kernel modules on the CPU (each kernel's plain version plus
the shared wrapper code) against the JAX package's kernels, which run here
in Pallas interpret mode through ``repro.kernels.ops`` as
tests/test_kernels.py runs them.

Tolerances, stated per check:
- scan: every (distance, id) pair identical after the merge, ties to the
  lowest id, sentinels and every candidate pack included; the block-local
  layout before the merge is compared at equal block_n;
- seeded hash: a bit may differ only where a projection lies within the
  float32 rounding bound of zero (``kernels.ref.sign_flip_ratios`` <= 1);
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
from repro_torch.kernels import hamming as thamming  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.utils.bits import (flip_packed, from_numpy_u32,  # noqa: E402
                                    np_hamming_packed)

PACKS = ("none", "16", "8")


# -- seeded hash -------------------------------------------------------------

@pytest.mark.parametrize("k", [20, 48, 64])
@pytest.mark.parametrize("g", [1, 3])
def test_seeded_hash_vs_jax_within_near_zero_bound(k, g):
    rng = np.random.default_rng(10 * k + g)
    n, d = 300, 97
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
        jd, ji = jops.hamming_topk_grouped(cj, qj, l, pack=pack, active=aj,
                                           block_n=block_n)
        assert np.array_equal(np.asarray(jd), want_d)
        assert np.array_equal(np.asarray(ji), want_i)
    ct, qt = from_numpy_u32(codes), from_numpy_u32(qs)
    at = None if active is None else torch.from_numpy(active)
    paths = {f"ops_p{p}": tops.hamming_topk_grouped(
        ct, qt, l, pack=p, active=at, block_n=block_n) for p in packs}
    paths["search_hist"] = tsearch.hamming_topk_grouped_hist(ct, qt, l, at)
    paths["search_lax"] = tsearch.hamming_topk_grouped(ct, qt, l,
                                                       select="argmin",
                                                       active=at)
    paths["ops_argmin_cpu"] = tops.hamming_topk_grouped(
        ct, qt, l, select="argmin", active=at)
    for name, (d, i) in paths.items():
        assert d.dtype == i.dtype == torch.int32, name
        assert np.array_equal(d.numpy(), want_d), name
        assert np.array_equal(i.numpy(), want_i), name
    return want_d, want_i


@pytest.mark.parametrize("w", [1, 2, 4])
def test_scan_every_pack_and_width(w):
    rng = np.random.default_rng(w)
    codes = rng.integers(0, 2**32, (2, 700, w), dtype=np.uint32)
    codes[..., 0] &= np.uint32(0xF)          # few distinct values: ties
    qs = rng.integers(0, 2**32, (2, 5, w), dtype=np.uint32)
    _scan_vs_jax(codes, qs, 40, block_n=256,
                 jax_packs=PACKS if w == 1 else ("16",))


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


@pytest.mark.parametrize("pack", PACKS)
def test_block_local_layout_equals_jax_kernel(pack):
    """Before the merge, at equal block_n: the same (G, grid, B, l) block
    candidates, dtypes and sentinel slots as the Pallas kernel."""
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
        pack=pack)
    td, ti = thamming.hamming_topk_hist(
        from_numpy_u32(codes), from_numpy_u32(qs), l, bn,
        torch.from_numpy(active), pack)
    assert str(td.dtype).split(".")[-1] == str(np.asarray(jd).dtype)
    assert str(ti.dtype).split(".")[-1] == str(np.asarray(ji).dtype)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


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
