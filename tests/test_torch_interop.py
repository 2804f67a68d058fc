"""Carrying the JAX package's state into the port, and the port's copies of
the JAX package's pure-numpy modules held to their originals.

Tolerances: the seeded family's factors are regenerated by the port's
generator, within 4 ulp of JAX's (torch's and XLA's float32 log / cos
differ by a few ulp); everything else is compared exactly.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import functions as JF  # noqa: E402
from repro.core import tables as jtables  # noqa: E402
from repro.core.indexer import IndexConfig as JConfig  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.serving import MultiTableIndex as JIndex  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import functions as TF  # noqa: E402
from repro_torch.core import tables as ttables  # noqa: E402
from repro_torch.core.indexer import IndexConfig as TConfig  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


def _ulps(a, b):
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def test_families_from_numpy_every_kind():
    key = jax.random.PRNGKey(3)
    seeded = JF.SeededBHHash.create(key, 40, 20)
    bh = JF.BHHash.create(jax.random.fold_in(key, 1), 40, 20)
    specs = [
        {"kind": "seeded_bh", "seed": seeded.seed, "u": np.asarray(seeded.u),
         "v": np.asarray(seeded.v)},
        {"kind": "bh", "u": np.asarray(bh.u), "v": np.asarray(bh.v)},
        {"kind": "lbh", "u": np.asarray(bh.v), "v": np.asarray(bh.u)},
    ]
    fams = interop.families_from_numpy(specs, device="cpu")
    assert [type(f) for f in fams] == [TF.SeededBHHash, TF.BHHash,
                                       TF.LBHHash]
    assert fams[0].seed == seeded.seed
    assert _ulps(fams[0].u.numpy(), np.asarray(seeded.u)).max() <= 4
    assert _ulps(fams[0].v.numpy(), np.asarray(seeded.v)).max() <= 4
    assert np.array_equal(fams[1].u.numpy(), np.asarray(bh.u))
    assert np.array_equal(fams[2].v.numpy(), np.asarray(bh.u))
    assert all(f.k == 20 and f.device.type == "cpu" for f in fams)
    ah = JF.AHHash.create(key, 40, 20)
    eh = JF.EHHash.create(key, 40, 6, sample_dims=9)
    ah_t, eh_t, eh_full = interop.families_from_numpy([
        {"kind": "ah", "u": np.asarray(ah.u), "v": np.asarray(ah.v)},
        {"kind": "eh", "mats": np.asarray(eh.mats),
         "dims": np.asarray(eh.dims)},
        {"kind": "eh", "mats": np.asarray(eh.mats)[:, :4, :4],
         "dims": None}], device="cpu")
    assert type(ah_t) is TF.AHHash and ah_t.k == 20
    assert np.array_equal(ah_t.v.numpy(), np.asarray(ah.v))
    assert type(eh_t) is TF.EHHash and eh_t.k == 6
    assert np.array_equal(eh_t.mats.numpy(), np.asarray(eh.mats))
    assert np.array_equal(eh_t.dims.numpy(), np.asarray(eh.dims))
    assert eh_full.dims is None and eh_full.mats.shape == (6, 4, 4)


@pytest.mark.parametrize("spec,match", [
    ({"kind": "bogus", "u": np.zeros((3, 2)), "v": np.zeros((3, 2))},
     "kind"),
    ({"kind": "bh", "u": np.zeros((3, 2)), "v": np.zeros((3, 4))}, "equal"),
    ({"kind": "eh", "mats": np.zeros((2, 3, 4))}, r"\(k, d, d\)"),
])
def test_families_from_numpy_rejects_bad_specs(spec, match):
    with pytest.raises(ValueError, match=match):
        interop.families_from_numpy([spec], device="cpu")


def test_index_from_numpy_holds_the_jax_state():
    corpus = jsyn.tiny1m_like(n_labeled=300, n_unlabeled=500, d=24,
                              classes=3, seed=1)
    cfg = dict(method="bh", bits=20, tables=3, radius=2,
               compact_threshold=None)
    jidx = JIndex(JConfig(**cfg)).fit(corpus.x)
    jidx.insert(corpus.x[:40])
    jidx.delete(np.arange(0, 200, 3))
    specs = [{"kind": "seeded_bh", "seed": f.seed, "u": np.asarray(f.u),
              "v": np.asarray(f.v)} for f in jidx.families]
    tidx = interop.index_from_numpy(TConfig(**cfg), specs, jidx.x_np,
                                    jidx.codes, jidx.active, jidx.ids_np,
                                    jidx._next_id, device="cpu")
    assert tidx.num_tables == 3 and tidx.device.type == "cpu"
    for a, b in zip(tidx.codes, jidx.codes):
        assert a.dtype == np.uint32 and np.array_equal(a, b)
    assert np.array_equal(tidx.ids_to_rows(np.arange(10)),
                          jidx.ids_to_rows(np.arange(10)))
    # the bucket tables hold the same live rows under the same keys
    keys = ttables.keys_of(jidx.codes[0][:50])
    for tt, jt in zip(tidx.tables, jidx.tables):
        assert tt.num_buckets == jt.num_buckets
        got = tt.lookup_many(keys, 2, 4096, 16)
        want = jt.lookup_many(keys, 2, 4096, 16)
        for g, w in zip(got, want):
            assert np.array_equal(np.sort(g), np.sort(w))
    st_t, st_j = tidx.stats(), jidx.stats()
    for k in ("tables", "n", "rows", "dead_fraction", "bits",
              "buckets_total"):
        assert st_t[k] == st_j[k], k


def test_tables_copy_matches_original():
    rng = np.random.default_rng(2)
    for k in (20, 40, 64):
        packed = rng.integers(0, 2**32, (500, -(-k // 32)), dtype=np.uint32)
        if k % 32:
            packed[:, -1] &= np.uint32((1 << (k % 32)) - 1)
        assert np.array_equal(ttables.keys_of(packed), jtables.keys_of(packed))
        assert np.array_equal(ttables.probe_masks(k, 2),
                              jtables.probe_masks(k, 2))
        tt = ttables.SingleHashTable(packed, k)
        jt = jtables.SingleHashTable(packed, k)
        tt.insert(packed[:20], np.arange(500, 520))
        jt.insert(packed[:20], np.arange(500, 520))
        tt.delete(np.arange(0, 100, 7))
        jt.delete(np.arange(0, 100, 7))
        keys = ttables.keys_of(packed[::25])
        for radius, mc in ((0, None), (2, 64)):
            got = tt.lookup_many(keys, radius, 4096, mc)
            want = jt.lookup_many(keys, radius, 4096, mc)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert tt.stats() == jt.stats()


def test_synthetic_copy_matches_original():
    t = tsyn.tiny1m_like(n_labeled=200, n_unlabeled=300, d=16, classes=4,
                         seed=5)
    j = jsyn.tiny1m_like(n_labeled=200, n_unlabeled=300, d=16, classes=4,
                         seed=5)
    assert np.array_equal(t.x, j.x) and np.array_equal(t.y, j.y)
    assert t.x.dtype == np.float32 and t.x.shape == (500, 17)
    t = tsyn.newsgroups_like(n=120, d=64, classes=4, topics_per_class=5,
                             seed=6)
    j = jsyn.newsgroups_like(n=120, d=64, classes=4, topics_per_class=5,
                             seed=6)
    assert np.array_equal(t.x, j.x) and np.array_equal(t.y, j.y)


def test_fit_own_families_matches_carried_codes():
    """A port index fitted with the JAX index's families (carried in)
    hashes the database like the JAX index, up to near-zero bits."""
    from repro_torch.kernels.ref import sign_flip_ratios
    from repro_torch.serving.multi_table import MultiTableIndex
    from repro_torch.utils.bits import from_numpy_u32
    corpus = jsyn.tiny1m_like(n_labeled=300, n_unlabeled=300, d=24,
                              classes=3, seed=2)
    cfg = dict(method="bh", bits=20, tables=2)
    jidx = JIndex(JConfig(**cfg)).fit(corpus.x)
    fams = interop.families_from_numpy(
        [{"kind": "seeded_bh", "seed": f.seed, "u": np.asarray(f.u),
          "v": np.asarray(f.v)} for f in jidx.families], device="cpu")
    tidx = MultiTableIndex(TConfig(**cfg), device="cpu").fit(
        corpus.x, families=fams)
    ratios = sign_flip_ratios(
        torch.from_numpy(corpus.x), [(f.u, f.v) for f in fams],
        from_numpy_u32(np.stack(tidx.codes)),
        from_numpy_u32(np.stack(jidx.codes)))
    assert (ratios <= 1.0).all()
    assert np.array_equal(tidx.ids_np, jidx.ids_np)
