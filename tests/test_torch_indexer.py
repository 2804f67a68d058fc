"""The port's single-table ``HyperplaneIndex`` against the JAX package's on
the CPU, for every family (ah, eh, bh, lbh): the JAX index is fitted, its
family is carried into the port (``repro_torch.interop``), and both answer
the same hyperplane queries through the probe table (``query``) and the
scan (``query_scan``).

Tolerances, stated per check (eps = 2^-23):
- codes hashed by each package on its own: a bit may differ only where its
  float score lies within the float32 rounding bound of zero — for BH/LBH
  ``kernels.ref.sign_flip_ratios``; for AH (d + 8)·eps·Σ|x_i u_i|; for EH
  (2d + 8)·eps·Σ|z_d M_de z_e| (a d-term product, then a d-term sum);
- over the same codes (the JAX codes carried in): answers identical for
  every query whose query code is identical in both packages, candidate
  lists identical, margins within rtol 1e-5 plus the float32 rounding bound
  of the d-term dot product (torch and XLA sum in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.indexer import HyperplaneIndex as JIndex  # noqa: E402
from repro.core.indexer import IndexConfig as JConfig  # noqa: E402
from repro.data.synthetic import tiny1m_like  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import functions as TF  # noqa: E402
from repro_torch.core.indexer import HyperplaneIndex as TIndex  # noqa: E402
from repro_torch.core.indexer import IndexConfig as TConfig  # noqa: E402
from repro_torch.kernels.ref import sign_flip_ratios  # noqa: E402
from repro_torch.serving.multi_table import MultiTableIndex  # noqa: E402
from repro_torch.utils.bits import (from_numpy_u32, to_numpy_u32,  # noqa: E402
                                    unpack_signs)

EPS = 2.0 ** -23
METHODS = ("ah", "eh", "bh", "lbh")


def _cfg(method):
    kw = dict(method=method, bits=24 if method == "ah" else 16, radius=2,
              lbh_sample=120, lbh_steps=15)
    if method == "eh":
        kw["eh_sample_dims"] = 12
    return kw


@pytest.fixture(scope="module")
def corpus():
    return tiny1m_like(n_labeled=400, n_unlabeled=1400, d=40, classes=4,
                       seed=3)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(4)
    return rng.normal(size=(24, corpus.x.shape[1])).astype(np.float32)


@pytest.fixture(scope="module")
def jax_indexes(corpus):
    return {m: JIndex(JConfig(**_cfg(m))).fit(corpus.x) for m in METHODS}


def _spec(fam):
    name = type(fam).__name__
    if name == "EHHash":
        return {"kind": "eh", "mats": np.asarray(fam.mats),
                "dims": None if fam.dims is None else np.asarray(fam.dims)}
    spec = {"kind": {"SeededBHHash": "seeded_bh", "BHHash": "bh",
                     "LBHHash": "lbh", "AHHash": "ah"}[name],
            "u": np.asarray(fam.u), "v": np.asarray(fam.v)}
    if name == "SeededBHHash":
        spec["seed"] = fam.seed
    return spec


def _bits_near_zero(fam, x, codes_a, codes_b):
    """True when every bit where the (n, W) codes differ has its float
    score within the float32 rounding bound of zero (module docstring)."""
    xt = torch.from_numpy(np.asarray(x, np.float32))
    a, b = from_numpy_u32(codes_a), from_numpy_u32(codes_b)
    if isinstance(fam, TF.BHHash):
        return bool((sign_flip_ratios(xt, [(fam.u, fam.v)], a[None],
                                      b[None]) <= 1.0).all())
    k = fam.k
    rows, cols = torch.nonzero(unpack_signs(a, k) != unpack_signs(b, k),
                               as_tuple=True)
    if rows.numel() == 0:
        return True
    z = xt[rows]
    if isinstance(fam, TF.AHHash):
        f = torch.where((cols % 2 == 0)[None, :], fam.u[:, cols // 2],
                        fam.v[:, cols // 2])                 # (d, e)
        terms = z * f.T
        bound = (x.shape[1] + 8) * EPS * terms.abs().sum(1)
    else:
        if fam.dims is not None:
            z = z[:, fam.dims]
        terms = z[:, :, None] * fam.mats[cols] * z[:, None, :]
        bound = (2 * z.shape[1] + 8) * EPS * terms.abs().sum((1, 2))
        terms = terms.sum(2)
    return bool((terms.sum(1).abs() <= bound).all())


@pytest.mark.parametrize("method", METHODS)
def test_fit_with_carried_family_hashes_like_jax(corpus, jax_indexes,
                                                 method):
    jidx = jax_indexes[method]
    fam, = interop.families_from_numpy([_spec(jidx.family)], device="cpu")
    tidx = TIndex(TConfig(**_cfg(method)), device="cpu").fit(corpus.x,
                                                            family=fam)
    assert tidx.family is fam
    want = np.asarray(jidx.codes)
    got = to_numpy_u32(tidx.codes)
    assert got.shape == want.shape
    assert _bits_near_zero(fam, corpus.x, got, want)
    assert tidx.table.n == corpus.x.shape[0]


def _margin_tol(x, w, i, m_want):
    terms = np.abs(x[i] * w).sum()
    return 1e-5 * abs(m_want) + (x.shape[1] + 8) * EPS * terms / max(
        np.linalg.norm(w), 1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_query_and_query_scan_match_jax_over_carried_codes(
        corpus, queries, jax_indexes, method):
    jidx = jax_indexes[method]
    tidx = interop.hyperplane_index_from_numpy(
        TConfig(**_cfg(method)), _spec(jidx.family), corpus.x,
        np.asarray(jidx.codes), device="cpu")
    agree = 0
    for w in queries:
        qj = np.asarray(jidx.family.hash_query(jnp.asarray(w)[None]))[0]
        qt = to_numpy_u32(tidx.family.hash_query(torch.from_numpy(w)[None]))[0]
        if not np.array_equal(qj, qt):
            continue
        agree += 1
        rj, rt = jidx.query(w), tidx.query(w)
        assert rt.nonempty == rj.nonempty and rt.index == rj.index
        assert np.array_equal(rt.candidates, rj.candidates)
        if rj.nonempty:
            assert abs(rt.margin - rj.margin) <= _margin_tol(
                corpus.x, w, rj.index, rj.margin)
        for l in (1, 16, 100):
            (ij, mj), (it, mt) = jidx.query_scan(w, l), tidx.query_scan(w, l)
            assert it == ij
            assert abs(mt - mj) <= _margin_tol(corpus.x, w, ij, mj)
    assert agree >= 0.9 * len(queries)


def test_query_scan_l_exceeds_n_and_no_rerank(corpus, queries):
    """l > n: the -1 tail is sliced off before the gather; rerank=False
    answers the first candidate with margin nan, as in JAX."""
    x = corpus.x[:40]
    cfg = dict(method="bh", bits=16, radius=2)
    jidx = JIndex(JConfig(**cfg)).fit(x)
    tidx = interop.hyperplane_index_from_numpy(
        TConfig(**cfg), _spec(jidx.family), x, np.asarray(jidx.codes),
        device="cpu")
    w = queries[0]
    assert tidx.query_scan(w, 64)[0] == jidx.query_scan(w, 64)[0]
    tidx.config.rerank = False
    jidx.config.rerank = False
    rt, rj = tidx.query(w), jidx.query(w)
    assert rt.index == rj.index and np.isnan(rt.margin) and np.isnan(
        rj.margin)


@pytest.mark.parametrize("method", METHODS)
def test_port_builds_every_family_itself(corpus, queries, method):
    """With no family passed in, the port makes its own (LBH learned on the
    port), and a single-table index and table 0 of a multi-table index
    built from one config get the same family and codes."""
    cfg = TConfig(**_cfg(method))
    idx = TIndex(cfg, device="cpu").fit(corpus.x)
    expect = {"ah": TF.AHHash, "eh": TF.EHHash, "bh": TF.SeededBHHash,
              "lbh": TF.LBHHash}[method]
    assert type(idx.family) is expect and idx.family.k == cfg.bits
    assert isinstance(idx.family, TF.FAMILIES[method])
    multi = MultiTableIndex(cfg, tables=2, device="cpu").fit(corpus.x)
    assert np.array_equal(multi.codes[0], to_numpy_u32(idx.codes))
    assert not np.array_equal(multi.codes[1], multi.codes[0])
    res = idx.query(queries[0])
    assert res.nonempty and 0 <= res.index < corpus.x.shape[0]
    i, m = idx.query_scan(queries[0], 32)
    assert 0 <= i < corpus.x.shape[0] and np.isfinite(m)


def test_unseeded_bh_raises_and_unknown_method_raises(corpus):
    with pytest.raises(NotImplementedError, match="interop"):
        TIndex(TConfig(method="bh", seeded_projections=False),
               device="cpu").fit(corpus.x[:50])
    with pytest.raises(ValueError, match="unknown method"):
        TIndex(TConfig(method="xx"), device="cpu").fit(corpus.x[:50])


@pytest.mark.parametrize("method", ["ah", "eh"])
def test_near_zero_check_flags_a_far_bit(corpus, method):
    """The AH / EH bound is not vacuous: bit 0 flipped at the row whose
    bit-0 score is farthest from zero is flagged."""
    x = corpus.x[:200]
    idx = TIndex(TConfig(**_cfg(method)), device="cpu").fit(x)
    fam = idx.family
    codes = to_numpy_u32(idx.codes)
    assert _bits_near_zero(fam, x, codes, codes.copy())
    xt = torch.from_numpy(x)
    score = (xt @ fam.u[:, 0] if method == "ah"
             else ((xt[:, fam.dims] @ fam.mats[0]) * xt[:, fam.dims]).sum(1))
    bad = codes.copy()
    bad[int(score.abs().argmax()), 0] ^= np.uint32(1)
    assert not _bits_near_zero(fam, x, codes, bad)


# -- ActivationIndexer over a reduced LM backbone (test_system's setup) ------

@pytest.fixture(scope="module")
def activation_pair():
    """The JAX package's ``test_activation_indexer_over_backbone`` setup
    (reduced qwen3-1.7b, 96 sequences of 16 tokens, seeded BH, 16 bits)
    and the port's over the same weights and tokens."""
    import jax
    from repro.configs.registry import REDUCED as JREDUCED
    from repro.core.indexer import ActivationIndexer as JActIndexer
    from repro.models import forward as jforward
    from repro.models import init_params as jinit
    from repro.models import model_spec as jspec
    from repro_torch.configs.registry import REDUCED
    from repro_torch.core.indexer import ActivationIndexer
    from repro_torch.models import forward

    cfg = JREDUCED["qwen3-1.7b"]
    params = jinit(jax.random.PRNGKey(0), jspec(cfg), jnp.float32)

    @jax.jit
    def jembed(tokens):
        _, _, aux = jforward(cfg, params, {"tokens": tokens}, mode="train",
                             return_logits=False)
        return aux["normed"].mean(axis=1)

    model = interop.params_from_numpy(
        REDUCED["qwen3-1.7b"], jax.tree.map(np.asarray, params),
        device="cpu")

    def tembed(tokens):
        _, _, aux = forward(model.cfg, model, {"tokens": tokens},
                            return_logits=False)
        return aux["normed"].mean(dim=1)

    corpus = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (96, 16)).astype(np.int32)
    icfg = dict(method="bh", bits=16, radius=3)
    jai = JActIndexer(jembed, JConfig(**icfg), batch_size=32)
    jai.build(jnp.asarray(corpus))
    tai = ActivationIndexer(tembed, TConfig(**icfg), batch_size=32,
                            device="cpu")
    tai.build(torch.from_numpy(corpus).long())
    return jai, tai


def test_activation_indexer_embeddings_match_jax(activation_pair):
    jai, tai = activation_pair
    want = np.asarray(jai.embeddings)
    got = tai.embeddings.numpy()
    assert got.shape == want.shape == (96, 128)
    assert tai.embeddings.dtype == torch.float32
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert tai.index.x is tai.embeddings and tai.embed_s > 0


def test_activation_indexer_codes_match_jax(activation_pair):
    """With the JAX family carried across (the port seeds its own family
    from ``table_seed``, the JAX package from its PRNG key), the port's
    codes over its embeddings agree with the JAX codes but for near-zero
    bits."""
    jai, tai = activation_pair
    fam, = interop.families_from_numpy([_spec(jai.index.family)],
                                       device="cpu")
    assert type(tai.index.family) is type(fam) is TF.SeededBHHash
    want = np.asarray(jai.index.codes)
    emb = tai.embeddings.numpy()
    carried = TIndex(TConfig(method="bh", bits=16, radius=3),
                     device="cpu").fit(emb, family=fam)
    assert _bits_near_zero(fam, emb, to_numpy_u32(carried.codes), want)


def test_activation_indexer_query_scan_matches_jax(activation_pair):
    jai, tai = activation_pair
    tidx = interop.hyperplane_index_from_numpy(
        TConfig(method="bh", bits=16, radius=3), _spec(jai.index.family),
        tai.embeddings, np.asarray(jai.index.codes), device="cpu")
    emb = tai.embeddings.numpy()
    for w in np.random.default_rng(8).normal(size=(8, 128)).astype(
            np.float32):
        ij, mj = jai.index.query_scan(w, l=8)
        it, mt = tidx.query_scan(w, l=8)
        assert it == ij
        assert abs(mt - mj) <= _margin_tol(emb, w, ij, mj)
        assert 0 <= ij < 96 and np.isfinite(mj)
