"""The port's LBH learning (``repro_torch.core.learning``) against the JAX
package's ``repro.core.learning`` on the CPU: the same numpy inputs, and
for learning the JAX warm start (``BHHash.create(key)``) handed to the port,
since torch cannot replay jax.random.

Tolerances, stated per check (eps = 2^-23, one float32 ulp at 1):
- |cos| entries: (d + 16)·eps absolute — a d-term dot product of unit
  vectors summed in another order, plus a few ulp from the normalisation;
- the 5% thresholds: the same (d + 16)·eps (sorting two arrays whose
  entries differ by at most e moves each sorted entry by at most e) plus
  2^-20 for JAX's float32 mean over m·top terms;
- S: entries within 2·(d + 16)·eps, except where |cos| lies within that
  bound of a threshold (there S may jump between 2|cos| - 1 and ±1);
- surrogate cost and gradient: 1e-5 of the largest |term| — sums over m
  and d in another order (a wrong factor or sign is an error of 100%);
- learning: cost trajectories within 1e-4 of their largest |cost|, residue
  norms within rtol 1e-5; the learned factors within 1e-3 of their largest
  entry on every bit whose best iterate is the same step in both (the
  best-iterate choice among costs that tie within rounding may differ,
  and the kept costs must then tie); a hash bit may differ only where one
  of its projections x·u, x·v lies within the float32 rounding bound plus
  Σ_d |x_d|·|Δu_d| (the factor drift) of zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import learning as JL  # noqa: E402
from repro.core.functions import BHHash as JBH  # noqa: E402
from repro_torch.core import learning as TL  # noqa: E402
from repro_torch.core.functions import (bilinear_signs,  # noqa: E402
                                        seeded_projections)

EPS = 2.0 ** -23


def _clustered(seed, n=48, d=16, c=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(c, d)).astype(np.float32)
    x = centers[rng.integers(0, c, n)] + 0.15 * rng.normal(size=(n, d))
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_abs_cosine_vs_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(30, 40)).astype(np.float32)
    b = rng.normal(size=(70, 40)).astype(np.float32)
    b[3] = 0.0                               # a zero row: the 1e-12 clamp
    want = np.asarray(JL.abs_cosine(jnp.asarray(a), jnp.asarray(b)))
    got = TL.abs_cosine(_t(a), _t(b)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= (40 + 16) * EPS


@pytest.mark.parametrize("chunk", [7, 64])
def test_auto_thresholds_chunked_vs_jax_full_sort(monkeypatch, chunk):
    """The port takes per-row top-k tails of row chunks; JAX sorts the whole
    (m, n) matrix.  Chunk 7 does not divide m = 30."""
    monkeypatch.setattr(TL, "THRESHOLD_ROW_CHUNK", chunk)
    x_all = _clustered(1, n=900, d=24)
    x_m = x_all[::30]
    t1j, t2j = JL.auto_thresholds(jnp.asarray(x_m), jnp.asarray(x_all))
    t1t, t2t = TL.auto_thresholds(_t(x_m), _t(x_all))
    tol = (24 + 16) * EPS + 2.0 ** -20
    assert abs(t1t - t1j) <= tol and abs(t2t - t2j) <= tol
    assert 0.0 < t2t < t1t <= 1.0 + 1e-6


def test_similarity_matrix_vs_jax():
    x = _clustered(2, n=120, d=20)
    t1, t2 = 0.9, 0.3
    want = np.asarray(JL.similarity_matrix(jnp.asarray(x), t1, t2))
    got = TL.similarity_matrix(_t(x), t1, t2).numpy()
    c = np.asarray(JL.abs_cosine(jnp.asarray(x), jnp.asarray(x)))
    e = 2 * (20 + 16) * EPS
    near = (np.abs(c - t1) <= e) | (np.abs(c - t2) <= e)
    assert np.abs(got - want)[~near].max() <= e
    assert (np.diag(got) == 1).all()


def _symmetric(rng, m, scale=1.0):
    r = rng.normal(size=(m, m)).astype(np.float32) * scale
    return (r + r.T) / 2


@pytest.mark.parametrize("m,d", [(48, 16), (200, 33)])
def test_surrogate_cost_gradient_vs_jax_value_and_grad(m, d):
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, d)).astype(np.float32)
    uv = rng.normal(size=(2 * d,)).astype(np.float32) * 0.3
    r = _symmetric(rng, m)
    cj, gj = jax.value_and_grad(JL.surrogate_cost)(
        jnp.asarray(uv), jnp.asarray(x), jnp.asarray(r))
    y = _t(uv).requires_grad_(True)
    ct = TL.surrogate_cost(y, _t(x), _t(r))
    (gt,) = torch.autograd.grad(ct, y)
    gj = np.asarray(gj)
    assert abs(ct.item() - float(cj)) <= 1e-5 * np.abs(r).sum()
    assert np.abs(gt.numpy() - gj).max() <= 1e-5 * np.abs(gj).max()


@pytest.mark.parametrize("m,d", [(48, 16), (200, 33)])
def test_explicit_gradient_vs_jax_value_and_grad(m, d):
    """The gradient the card's graphed step body computes (no autograd)
    against JAX's value_and_grad of the surrogate, at 1e-5 of its largest
    entry, and equal bit for bit to the port's autograd gradient (the same
    operations in the same order)."""
    rng = np.random.default_rng(m + 1)
    x = rng.normal(size=(m, d)).astype(np.float32)
    uv = rng.normal(size=(2 * d,)).astype(np.float32) * 0.3
    r = _symmetric(rng, m)
    _, gj = jax.value_and_grad(JL.surrogate_cost)(
        jnp.asarray(uv), jnp.asarray(x), jnp.asarray(r))
    gj = np.asarray(gj)
    gt = TL.surrogate_grad(_t(uv), _t(x), _t(r))
    assert np.abs(gt.numpy() - gj).max() <= 1e-5 * np.abs(gj).max()
    y = _t(uv).requires_grad_(True)
    (ga,) = torch.autograd.grad(TL.surrogate_cost(y, _t(x), _t(r)), y)
    assert torch.equal(gt, ga)


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_nesterov_step_vs_jax_scan_body(steps):
    """The step the CUDA graph records (``nesterov_step``), chained from
    the warm start with the port's momentum schedule, against the same
    number of steps of JAX's scan body (``_nesterov_bit`` with that
    length): the best iterate and each step's cost at 1e-5 relative."""
    x = _clustered(8, n=64, d=20)
    m, d = x.shape
    t1, t2 = JL.auto_thresholds(jnp.asarray(x), jnp.asarray(x))
    r = 6 * np.asarray(JL.similarity_matrix(jnp.asarray(x), t1, t2))
    rng = np.random.default_rng(9)
    u0 = rng.normal(size=(d,)).astype(np.float32)
    v0 = rng.normal(size=(d,)).astype(np.float32)
    lr = 0.03 / m
    uj, vj, cj = JL._nesterov_bit(jnp.asarray(u0), jnp.asarray(v0),
                                  jnp.asarray(x), jnp.asarray(r), steps, lr)
    xt, rt = _t(x), _t(r)
    uv0 = torch.cat([_t(u0), _t(v0)])
    best_c = TL._cost(uv0, xt, rt)[0]
    xk, x_prev, best, costs = uv0, uv0, uv0, []
    for mu in TL._momentum(steps):
        x_new, c, best, best_c = TL.nesterov_step(
            xk, x_prev, mu, float(np.float32(lr)), best, best_c, xt, rt)
        costs.append(c.item())
        xk, x_prev = x_new, xk
    want = np.concatenate([np.asarray(uj), np.asarray(vj)])
    assert np.abs(best.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    cj = np.asarray(cj)
    assert np.abs(np.array(costs) - cj).max() <= 1e-5 * np.abs(cj).max()


@pytest.mark.parametrize("steps", [0, 1, 25])
def test_graph_body_equals_eager_loop(steps):
    """The straight-line body a ``BitLoop`` captures (``_loop``), run
    eagerly on the CPU, gives the eager autograd loop's best iterate and
    costs bit for bit."""
    x = _clustered(10)
    m, d = x.shape
    rng = np.random.default_rng(11)
    r = _t(_symmetric(rng, m))
    u0 = _t(rng.normal(size=(d,)))
    v0 = _t(rng.normal(size=(d,)))
    lr = 0.03 / m
    u, v, costs = TL._nesterov_bit(u0, v0, _t(x), r, steps, lr)
    best, costs_g = TL._loop(torch.cat([u0, v0]), _t(x), r,
                             TL._momentum(steps), float(np.float32(lr)))
    assert torch.equal(best, torch.cat([u, v]))
    assert costs_g.shape == (steps,) and torch.equal(costs_g, costs)


def test_bit_loop_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        TL.BitLoop(_t(_clustered(12)), 5, 0.01)


def test_nesterov_bit_vs_jax_given_warm_start():
    x = _clustered(3)
    m, d = x.shape
    k = 6
    t1, t2 = JL.auto_thresholds(jnp.asarray(x), jnp.asarray(x))
    r = k * np.asarray(JL.similarity_matrix(jnp.asarray(x), t1, t2))
    rng = np.random.default_rng(4)
    u0 = rng.normal(size=(d,)).astype(np.float32)
    v0 = rng.normal(size=(d,)).astype(np.float32)
    uj, vj, cj = JL._nesterov_bit(jnp.asarray(u0), jnp.asarray(v0),
                                  jnp.asarray(x), jnp.asarray(r), 25,
                                  0.03 / m)
    ut, vt, ct = TL._nesterov_bit(_t(u0), _t(v0), _t(x), _t(r), 25,
                                  0.03 / m)
    for got, want in ((ut, uj), (vt, vj)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max()
    cj = np.asarray(cj)
    assert ct.shape == cj.shape == (25,)
    assert np.abs(ct.numpy() - cj).max() <= 1e-3 * np.abs(cj).max()


def _signs(x, u, v):
    return np.where((x @ np.asarray(u)) * (x @ np.asarray(v)) >= 0, 1, -1)


def _bit_drift_ok(x, st, sj, ut, vt, uj, vj):
    """Every hash bit on which signs st (of factors ut, vt) and sj (of uj,
    vj) disagree has a projection within rounding + factor drift of zero.
    Returns (ok, number of differing bits)."""
    rows, cols = np.nonzero(st != sj)
    d = x.shape[1]
    xa = np.abs(x[rows])
    near = np.zeros(rows.size, dtype=bool)
    for fac_t, fac_j in ((np.asarray(ut), np.asarray(uj)),
                         (np.asarray(vt), np.asarray(vj))):
        drift = (xa * np.abs(fac_t - fac_j)[:, cols].T).sum(1)
        rnd = (d + 8) * EPS * (xa * np.abs(fac_j)[:, cols].T).sum(1)
        proj = np.abs((x[rows] * fac_j[:, cols].T).sum(1))
        near |= proj <= drift + rnd
    return bool(near.all()), rows.size


def test_learn_lbh_end_to_end_vs_jax():
    """m = 48, d = 16, k = 6, 25 steps, given JAX's warm start and sample."""
    x = _clustered(5)
    k, steps = 6, 25
    key = jax.random.PRNGKey(3)
    res_j = JL.learn_lbh(key, jnp.asarray(x), k, steps=steps)
    warm = JBH.create(key, x.shape[1], k)      # learn_lbh's own warm start
    res_t = TL.learn_lbh(_t(x), k, _t(np.asarray(warm.u)),
                         _t(np.asarray(warm.v)), steps=steps)
    assert abs(res_t.t1 - res_j.t1) <= (16 + 16) * EPS + 2.0 ** -20
    assert abs(res_t.t2 - res_j.t2) <= (16 + 16) * EPS + 2.0 ** -20
    np.testing.assert_allclose(res_t.residue_norms.numpy(),
                               np.asarray(res_j.residue_norms), rtol=1e-5)
    cj, ct = np.asarray(res_j.bit_costs), res_t.bit_costs.numpy()
    assert ct.shape == cj.shape == (k, steps)
    assert (np.abs(ct - cj).max(1) <= 1e-4 * np.abs(cj).max(1)).all()
    # The learner keeps the best iterate of a nonconvex trajectory.  Where
    # two iterates' costs tie within rounding, the packages may keep
    # different ones: then the kept costs tie, and only there may the
    # factors differ by more than rounding.
    same = ct.argmin(1) == cj.argmin(1)
    assert (np.abs(ct.min(1) - cj.min(1)) <= 1e-4 * np.abs(cj).max(1)).all()
    assert same.sum() >= k - 2
    for got, want in ((res_t.family.u, res_j.family.u),
                      (res_t.family.v, res_j.family.v)):
        want = np.asarray(want)[:, same]
        assert (np.abs(got.numpy()[:, same] - want).max()
                <= 1e-3 * np.abs(want).max())
    ut, vt = res_t.family.u.numpy(), res_t.family.v.numpy()
    uj, vj = np.asarray(res_j.family.u), np.asarray(res_j.family.v)
    x_test = np.concatenate([x, _clustered(50, n=400)])
    st = bilinear_signs(_t(x_test), res_t.family.u, res_t.family.v).numpy()
    ok, _ = _bit_drift_ok(x_test, st, _signs(x_test, uj, vj), ut, vt, uj, vj)
    assert ok


def test_bit_drift_check_flags_a_far_bit():
    """The drift check is not vacuous: with equal factors, a flipped bit
    far from zero is flagged."""
    x = _clustered(6)
    rng = np.random.default_rng(6)
    u = rng.normal(size=(16, 4)).astype(np.float32)
    v = rng.normal(size=(16, 4)).astype(np.float32)
    s = _signs(x, u, v)
    assert _bit_drift_ok(x, s, s.copy(), u, v, u, v) == (True, 0)
    far = np.minimum(np.abs(x @ u), np.abs(x @ v))
    i, j = np.unravel_index(np.argmax(far), far.shape)
    bad = s.copy()
    bad[i, j] *= -1
    assert _bit_drift_ok(x, s, bad, u, v, u, v) == (False, 1)


def test_port_learning_improves_gram_fit_over_its_warm_start():
    """The paper's claim on the port's own warm start and sample:
    ||BB^T/k - S||_F of the learned codes beats the seeded BH codes the
    learning started from (tests/test_learning.py holds JAX to it)."""
    x = _t(_clustered(7, n=240, d=32))
    k = 12
    u0, v0 = seeded_projections(123, 32, k)
    res = TL.learn_lbh(x, k, u0, v0, steps=80)
    s = TL.similarity_matrix(x, res.t1, res.t2)

    def gram_err(u, v):
        b = bilinear_signs(x, u, v).to(torch.float32)
        return torch.linalg.vector_norm(b @ b.T / k - s).item()

    learned = gram_err(res.family.u, res.family.v)
    assert learned < gram_err(u0, v0)
    # the last residue norm is k times the learned Gram-fit error
    assert abs(res.residue_norms[-1].item() / k - learned) <= 1e-4 * learned


def test_sample_rows_is_seeded_and_distinct():
    a = TL.sample_rows(1000, 100, 7)
    assert torch.equal(a, TL.sample_rows(1000, 100, 7))
    assert not torch.equal(a, TL.sample_rows(1000, 100, 8))
    assert a.unique().numel() == 100 and int(a.max()) < 1000
