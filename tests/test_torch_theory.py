"""The port's copy of the closed-form theory (core/theory.py, paper §3.3,
Fig. 2): the checks of tests/test_theory.py on the copy, and the copy held
to the JAX package's module (numpy only, so every value must be equal)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import theory as jtheory  # noqa: E402
from repro_torch.core import theory  # noqa: E402


def test_p1_orderings():
    """Fig. 2(a): BH collision prob is the highest at every r, = 2x AH."""
    r = np.linspace(0.0, (np.pi / 2) ** 2 * 0.9, 50)
    alpha = np.sqrt(r)
    p_ah, p_eh, p_bh = (theory.p_ah(alpha), theory.p_eh(alpha),
                        theory.p_bh(alpha))
    assert (p_bh >= p_eh - 1e-12).all()
    assert (p_eh >= p_ah - 1e-12).all()
    np.testing.assert_allclose(p_bh, 2 * p_ah, rtol=1e-12)


def test_collision_monotone_decreasing():
    alpha = np.linspace(0, np.pi / 2, 100)
    for f in (theory.p_ah, theory.p_eh, theory.p_bh):
        assert (np.diff(f(alpha)) <= 1e-12).all()


def test_rho_in_unit_interval_and_fig2b_ordering():
    """Fig. 2(b) at eps=3: rho_EH <= rho_BH <= rho_AH over small r."""
    r = np.linspace(0.01, 0.4, 20)
    rho_ah = theory.rho("ah", r, eps=3.0)
    rho_eh = theory.rho("eh", r, eps=3.0)
    rho_bh = theory.rho("bh", r, eps=3.0)
    for rho in (rho_ah, rho_eh, rho_bh):
        assert ((rho > 0) & (rho < 1)).all()
    assert (rho_bh <= rho_ah + 1e-9).all()
    assert (rho_eh <= rho_bh + 1e-9).all()


def test_query_cost_model():
    tables, k = theory.query_cost_model(10**6, "bh", 0.1, eps=3.0)
    assert tables >= 1 and k > 0


@pytest.mark.parametrize("method", ["ah", "eh", "bh"])
def test_theory_copy_matches_original(method):
    r = np.linspace(0.0, (np.pi / 2) ** 2 * 0.95, 64)
    alpha = np.sqrt(r)
    assert np.array_equal(theory.COLLISION[method](alpha),
                          jtheory.COLLISION[method](alpha))
    for eps in (1.0, 3.0):
        for got, want in zip(theory.p1_p2(method, r[1:], eps),
                             jtheory.p1_p2(method, r[1:], eps)):
            assert np.array_equal(got, want)
        # past the family's range rho is NaN on both (log of p <= 0)
        assert np.array_equal(theory.rho(method, r[1:], eps),
                              jtheory.rho(method, r[1:], eps),
                              equal_nan=True)
    for n in (10**4, 10**6):
        assert theory.query_cost_model(n, method, 0.1) == \
            jtheory.query_cost_model(n, method, 0.1)
