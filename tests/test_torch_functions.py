"""core/functions of the PyTorch port against the JAX package's.

Tolerances, stated per check:
- the generator's uint32 stream (``_fmix32`` chain) is compared bit for bit;
- its float32 Box-Muller output within 4 ulp: torch's and XLA's float32
  ``log`` / ``cos`` differ by a few ulp (measured: at most 3);
- hash bits may differ only where a projection lies within the float32
  rounding bound of zero (``kernels.ref.sign_flip_ratios`` <= 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import functions as JF  # noqa: E402
from repro_torch.core import functions as TF  # noqa: E402
from repro_torch.kernels.ref import sign_flip_ratios  # noqa: E402
from repro_torch.utils.bits import from_numpy_u32, to_numpy_u32  # noqa: E402

SEEDS = [0, 12345, 0xFFFFFFFF]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """ulp distance between float32 arrays (monotone integer mapping)."""
    def key(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def test_sgn_zero_is_plus_one():
    x = np.array([-2.0, -0.0, 0.0, 3.0], np.float32)
    assert np.array_equal(TF._sgn(torch.from_numpy(x)).numpy(),
                          np.asarray(JF._sgn(jnp.asarray(x))))


def test_fmix32_exact():
    rng = np.random.default_rng(0)
    h = np.concatenate([rng.integers(0, 2**32, 10000, dtype=np.uint32),
                        np.array([0, 1, 0x7FFFFFFF, 0x80000000,
                                  0xFFFFFFFF], np.uint32)])
    want = np.asarray(JF._fmix32(jnp.asarray(h)))
    got = TF._fmix32(torch.from_numpy(h.astype(np.int64)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    # python ints take the same path
    assert TF._fmix32(0xFFFFFFFF) == int(want[-1])


def _jax_stream(seed, tag, rows, cols):
    """The uint32 words behind JAX's seeded_gaussian, from its own _fmix32."""
    u32 = jnp.uint32
    s = JF._fmix32(u32(seed) + u32(tag) * u32(JF._GOLD))
    h = JF._fmix32(s ^ (jnp.asarray(rows).astype(u32) * u32(JF._FNV)))
    h = JF._fmix32(h ^ jnp.asarray(cols).astype(u32))
    return (np.asarray(JF._fmix32(h ^ u32(0x632BE59B))),
            np.asarray(JF._fmix32(h ^ u32(0x2545F491))))


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_stream_exact_and_gaussians_within_4_ulp(seed):
    d, k = 385, 64
    rows = np.arange(d, dtype=np.int32)[:, None]
    cols = np.arange(k, dtype=np.int32)[None, :]
    for tag in (0, 1):
        jb1, jb2 = _jax_stream(seed, tag, rows, cols)
        tb1, tb2 = TF.seeded_bits(seed, tag, torch.from_numpy(rows),
                                  torch.from_numpy(cols))
        assert np.array_equal(tb1.numpy().astype(np.uint32), jb1)
        assert np.array_equal(tb2.numpy().astype(np.uint32), jb2)
    ju, jv = (np.asarray(a) for a in JF.seeded_projections(seed, d, k))
    tu, tv = TF.seeded_projections(seed, d, k)
    assert tu.dtype == torch.float32 and tu.shape == (d, k)
    assert _ulps(tu.numpy(), ju).max() <= 4
    assert _ulps(tv.numpy(), jv).max() <= 4


def test_seeded_gaussian_positional():
    """A value depends only on (seed, tag, row, col): a sub-block of a
    larger draw equals the smaller draw, as the kernel relies on."""
    big_u, _ = TF.seeded_projections(7, 64, 96)
    small_u, _ = TF.seeded_projections(7, 16, 20)
    assert torch.equal(big_u[:16, :20], small_u)
    assert abs(big_u.mean().item()) < 0.05
    assert abs(big_u.std().item() - 1.0) < 0.05


def _bh_pair(rng, d, k, seeded):
    if seeded:
        seed = int(rng.integers(0, 2**32))
        j = JF.SeededBHHash(*JF.seeded_projections(seed, d, k), seed)
        t = TF.SeededBHHash.create(seed, d, k, device="cpu")
        assert t.seed == seed
        return j, t
    u = rng.normal(size=(d, k)).astype(np.float32)
    v = rng.normal(size=(d, k)).astype(np.float32)
    return (JF.BHHash(jnp.asarray(u), jnp.asarray(v)),
            TF.BHHash(torch.from_numpy(u), torch.from_numpy(v)))


@pytest.mark.parametrize("seeded", [True, False])
@pytest.mark.parametrize("k", [20, 48])
def test_bh_codes_within_near_zero_bound(seeded, k):
    rng = np.random.default_rng(k + seeded)
    d = 65
    x = rng.normal(size=(400, d)).astype(np.float32)
    jfam, tfam = _bh_pair(rng, d, k, seeded)
    xt = torch.from_numpy(x)
    for side in ("hash_database", "hash_query"):
        want = from_numpy_u32(np.asarray(getattr(jfam, side)(jnp.asarray(x))))
        got = getattr(tfam, side)(xt)
        assert got.dtype == torch.int32 and got.shape == want.shape
        ratios = sign_flip_ratios(xt, [(tfam.u, tfam.v)], got[None],
                                  want[None])
        assert (ratios <= 1.0).all(), ratios.max()


def test_query_code_is_flipped_database_code():
    rng = np.random.default_rng(3)
    fam = TF.SeededBHHash.create(99, 33, 20, device="cpu")
    w = torch.from_numpy(rng.normal(size=(50, 33)).astype(np.float32))
    q = TF.query_lookup_code(fam, w)
    assert torch.equal(q, TF.flip_database_code(fam.hash_database(w), 20))
    jq = np.asarray(JF.flip_database_code(
        jnp.asarray(to_numpy_u32(fam.hash_database(w))), 20))
    assert np.array_equal(to_numpy_u32(q), jq)


def test_lbh_family_evaluates_given_factors():
    rng = np.random.default_rng(4)
    u = rng.normal(size=(16, 12)).astype(np.float32)
    v = rng.normal(size=(16, 12)).astype(np.float32)
    x = rng.normal(size=(30, 16)).astype(np.float32)
    t = TF.LBHHash(torch.from_numpy(u), torch.from_numpy(v))
    j = JF.LBHHash(jnp.asarray(u), jnp.asarray(v))
    assert t.k == j.k == 12
    sign_t = t.signs_database(torch.from_numpy(x)).numpy()
    sign_j = np.asarray(j.signs_database(jnp.asarray(x)))
    prod = (x @ u) * (x @ v)
    # a sign may differ only where the product is within rounding of zero
    assert np.all((sign_t == sign_j) | (np.abs(prod) < 1e-4))


def test_table_seed_is_a_fixed_uint32_function():
    seeds = [TF.table_seed(0, t) for t in range(4)]
    assert len(set(seeds)) == 4
    assert all(0 <= s < 2**32 for s in seeds)
    assert seeds == [TF.table_seed(0, t) for t in range(4)]
    assert TF.table_seed(1, 0) != seeds[0]


def test_create_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.SeededBHHash.create(1, 8, 4)
