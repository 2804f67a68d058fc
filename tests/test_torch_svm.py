"""The port's SVMs and active-learning loop (``repro_torch.svm``) against
the JAX package's ``repro.svm`` on the CPU, from the same numpy inputs.

Tolerances, stated per check:
- SVM weights after 50-100 Nesterov steps: within 1e-5 of their largest
  |entry| (float32 sums over n and d in another order, compounded over the
  steps; a wrong gradient term is an error of order 1);
- average precision: the ranking (a stable argsort) identical, the AP
  within 1e-6 (a float32 sum of at most n terms in another order);
- the AL loop: every pick identical (integer stage: the same numpy draws,
  argmins and hash lookups; the LBH selector over the JAX index carried in
  through ``repro_torch.interop``), nonempty counts identical, MAP within
  1e-4 relative and the mean margins |x.w|/||w|| within sqrt(d)·1e-5
  absolute (unit rows x, weights that differ by 1e-5 of their largest
  entry as above).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.synthetic import tiny1m_like  # noqa: E402
from repro.svm import active as JA  # noqa: E402
from repro.svm import linear_svm as JS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.indexer import IndexConfig as TConfig  # noqa: E402
from repro_torch.serving.service import HashQueryService  # noqa: E402
from repro_torch.svm import active as TA  # noqa: E402
from repro_torch.svm import linear_svm as TS  # noqa: E402

AL = dict(iterations=6, init_per_class=3, svm_steps=20, eval_every=3,
          seed=5)


@pytest.fixture(scope="module")
def corpus():
    return tiny1m_like(n_labeled=300, n_unlabeled=900, d=32, classes=4,
                       seed=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, frac=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= frac * np.abs(want).max()


def test_svm_loss_vs_jax(corpus):
    rng = np.random.default_rng(0)
    w = rng.normal(size=corpus.x.shape[1]).astype(np.float32)
    y = np.where(corpus.y == 2, 1.0, -1.0).astype(np.float32)
    mask = (rng.random(corpus.x.shape[0]) < 0.2).astype(np.float32)
    want = float(JS.svm_loss(jnp.asarray(w), jnp.asarray(corpus.x),
                             jnp.asarray(y), jnp.asarray(mask), 1e-3))
    got = TS.svm_loss(_t(w), _t(corpus.x), _t(y), _t(mask), 1e-3).item()
    assert abs(got - want) <= 1e-5 * abs(want)


def test_train_svm_vs_jax(corpus):
    rng = np.random.default_rng(1)
    w0 = (0.1 * rng.normal(size=corpus.x.shape[1])).astype(np.float32)
    y = np.where(corpus.y == 1, 1.0, -1.0).astype(np.float32)
    mask = (rng.random(corpus.x.shape[0]) < 0.1).astype(np.float32)
    want = JS.train_svm(jnp.asarray(w0), jnp.asarray(corpus.x),
                        jnp.asarray(y), jnp.asarray(mask), steps=50)
    got = TS.train_svm(_t(w0), _t(corpus.x), _t(y), _t(mask), steps=50)
    _close(got, want)


def test_train_ova_vs_jax(corpus):
    rng = np.random.default_rng(2)
    mask = rng.random(corpus.x.shape[0]) < 0.1
    w0 = np.zeros((4, corpus.x.shape[1]), np.float32)
    want = JS.train_ova(jnp.asarray(w0), jnp.asarray(corpus.x),
                        jnp.asarray(corpus.y), jnp.asarray(mask), 4,
                        steps=100)
    got = TS.train_ova(_t(w0), _t(corpus.x), _t(corpus.y), _t(mask), 4,
                       steps=100)
    _close(got, want)
    # one weight tensor for all classes: class c alone gives the same row
    y = np.where(corpus.y == 2, 1.0, -1.0).astype(np.float32)
    one = TS.train_svm(_t(w0[2]), _t(corpus.x), _t(y), _t(mask), steps=100)
    _close(one, got[2].numpy(), 1e-6)


@pytest.mark.parametrize("ties", [False, True])
def test_average_precision_vs_jax(ties):
    rng = np.random.default_rng(3)
    n = 500
    scores = rng.normal(size=n).astype(np.float32)
    if ties:
        scores = np.round(scores * 2) / 2          # heavy ties
        scores[::7] = -np.inf                      # masked rows
    pos = rng.random(n) < 0.3
    order_j = np.asarray(jnp.argsort(-jnp.asarray(scores)))
    order_t = torch.argsort(-_t(scores), stable=True).numpy()
    assert np.array_equal(order_t, order_j)
    want = float(JS.average_precision(jnp.asarray(scores), jnp.asarray(pos)))
    got = TS.average_precision(_t(scores), _t(pos)).item()
    assert abs(got - want) <= 1e-6
    # leading axes are independent rankings
    batch = TS.average_precision(_t(np.stack([scores, -scores])),
                                 _t(np.stack([pos, pos])))
    assert batch[0].item() == got
    assert batch[1].item() == TS.average_precision(_t(-scores),
                                                   _t(pos)).item()


class _Recorder:
    """Wraps a selector of either package and records its picks."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.picks = []

    @property
    def index(self):
        return getattr(self.inner, "index", None)

    def prepare(self, corpus):
        self.inner.prepare(corpus)
        return self

    def select_batch(self, w_all, unlabeled):
        picks, oks = self.inner.select_batch(w_all, unlabeled)
        self.picks.append([int(p) for p in picks])
        return picks, oks


def _compare_runs(res_t, rec_t, res_j, rec_j, d):
    assert rec_t.picks == rec_j.picks
    assert np.array_equal(res_t.nonempty, res_j.nonempty)
    assert np.array_equal(res_t.eval_iters, res_j.eval_iters)
    np.testing.assert_allclose(res_t.map_curve, res_j.map_curve, rtol=1e-4)
    for got, want in ((res_t.min_margins, res_j.min_margins),
                      (res_t.exhaustive_margins, res_j.exhaustive_margins)):
        np.testing.assert_allclose(got, want, rtol=0, atol=np.sqrt(d) * 1e-5)


@pytest.mark.parametrize("method", ["random", "exhaustive"])
def test_active_learning_baselines_pick_identically(corpus, method):
    rec_j = _Recorder(JA.make_selector(method, bits=16, radius=2, seed=2))
    res_j = JA.run_active_learning(corpus, rec_j, JA.ALConfig(**AL))
    rec_t = _Recorder(TA.make_selector(method, bits=16, radius=2, seed=2,
                                       device="cpu"))
    res_t = TA.run_active_learning(corpus, rec_t, TA.ALConfig(**AL),
                                   device="cpu")
    assert res_t.name == res_j.name == method
    assert len(rec_t.picks) == AL["iterations"]
    _compare_runs(res_t, rec_t, res_j, rec_j, corpus.x.shape[1])


class _CarriedSelector(TA.HashSelector):
    """The port's HashSelector over a JAX MultiTableIndex carried in."""

    def __init__(self, config, seed, jax_index):
        super().__init__(config, seed, device="cpu")
        self.jax_index = jax_index

    def prepare(self, corpus):
        j = self.jax_index
        specs = [{"kind": "lbh", "u": np.asarray(f.u), "v": np.asarray(f.v)}
                 for f in j.families]
        self.index = interop.index_from_numpy(
            self.config, specs, j.x_np, j.codes, j.active, j.ids_np,
            j._next_id, device="cpu")
        self.service = HashQueryService(self.index,
                                        max_batch=self.config.batch)
        return self


def test_lbh_hash_selector_over_carried_index_picks_identically(corpus):
    kw = dict(bits=16, radius=2, seed=2, lbh_sample=150, lbh_steps=20)
    jsel = JA.make_selector("lbh", **kw)
    rec_j = _Recorder(jsel)
    res_j = JA.run_active_learning(corpus, rec_j, JA.ALConfig(**AL))
    tsel = _CarriedSelector(
        TConfig(method="lbh", bits=16, radius=2, seed=2, lbh_sample=150,
                lbh_steps=20), 2, jsel.index)
    rec_t = _Recorder(tsel)
    res_t = TA.run_active_learning(corpus, rec_t, TA.ALConfig(**AL),
                                   device="cpu")
    assert res_t.name == "lbh"
    assert res_j.nonempty.sum() > 0          # the hash lookups did answer
    _compare_runs(res_t, rec_t, res_j, rec_j, corpus.x.shape[1])


@pytest.mark.parametrize("method", ["lbh", "ah"])
def test_hash_selector_fits_on_the_port(corpus, method):
    """make_selector builds and learns its index on the port (AH with
    doubled bits, as in JAX) and the loop runs to its end."""
    sel = TA.make_selector(method, bits=8, radius=2, seed=1, device="cpu",
                           lbh_sample=100, lbh_steps=10)
    res = TA.run_active_learning(corpus, sel, TA.ALConfig(**AL),
                                 device="cpu")
    assert sel.index.config.bits == (16 if method == "ah" else 8)
    assert res.fit_seconds > 0 and res.nonempty.sum() > 0
    assert res.map_curve.shape == (3,) and np.isfinite(res.map_curve).all()
    assert (res.min_margins >= res.exhaustive_margins - 1e-6).all()


def test_async_selector_is_not_ported_yet(corpus):
    """(Named when use_async raised; it is ported now.)  The async selector
    (a future per learner through AsyncHashQueryService) picks exactly
    what the synchronous selector picks, and a whole AL run through it
    equals the synchronous run and closes its flush thread."""
    kw = dict(bits=18, radius=3, tables=2, batch=8, device="cpu")
    sel_sync = TA.make_selector("bh", **kw).prepare(corpus)
    sel_async = TA.make_selector("bh", use_async=True, **kw).prepare(corpus)
    rng = np.random.default_rng(3)
    w_all = rng.normal(size=(5, corpus.x.shape[1])).astype(np.float32)
    unlabeled = np.ones(corpus.x.shape[0], dtype=bool)
    unlabeled[rng.choice(corpus.x.shape[0], 100, replace=False)] = False
    picks_s, oks_s = sel_sync.select_batch(w_all, unlabeled)
    picks_a, oks_a = sel_async.select_batch(w_all, unlabeled)
    sel_async.finish()
    assert oks_s == oks_a == [True] * 5   # no random fallback fired
    assert picks_s == picks_a
    assert sel_async.service.stats()["completed"] == 5
    sels = [TA.make_selector("bh", use_async=a, seed=2, **kw)
            for a in (False, True)]
    runs = [TA.run_active_learning(corpus, sel, TA.ALConfig(**AL),
                                   device="cpu") for sel in sels]
    assert sels[1].service._thread is None      # finish() closed it
    assert np.array_equal(runs[0].min_margins, runs[1].min_margins)
    assert np.array_equal(runs[0].nonempty, runs[1].nonempty)
    assert np.array_equal(runs[0].map_curve, runs[1].map_curve)
