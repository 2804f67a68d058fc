"""utils/bits of the PyTorch port against the JAX package's: exact parity.

Inputs are made with numpy from a seed and fed to both; packed codes cross
as uint32 numpy arrays (the port carries them as int32 bit-views).
Tolerance: none, every result must be identical bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.utils import bits as jb  # noqa: E402
from repro_torch.utils import bits as tb  # noqa: E402


def _signs(rng, shape):
    return rng.choice(np.array([-1, 1], np.int8), shape)


def _u32(t):
    return tb.to_numpy_u32(t)


@pytest.mark.parametrize("k", [1, 20, 31, 32, 33, 48, 64, 100])
def test_pack_unpack_parity(k):
    rng = np.random.default_rng(k)
    signs = _signs(rng, (9, k))
    want = np.asarray(jb.pack_signs(jnp.asarray(signs)))
    got = tb.pack_signs(torch.from_numpy(signs))
    assert got.dtype == torch.int32 and tb.n_words(k) == jb.n_words(k)
    assert np.array_equal(_u32(got), want)
    # pad bits past k are 0 in both
    back = tb.unpack_signs(got, k)
    assert back.dtype == torch.int8
    assert np.array_equal(back.numpy(),
                          np.asarray(jb.unpack_signs(jnp.asarray(want), k)))
    assert np.array_equal(back.numpy(), signs)


def test_popcount_parity_all_bit_patterns():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.integers(0, 2**32, 4096, dtype=np.uint32),
        np.array([0, 1, 0x80000000, 0x7FFFFFFF, 0xFFFFFFFF, 0xAAAAAAAA,
                  0x55555555], np.uint32)])
    want = np.asarray(jb.popcount_u32(jnp.asarray(x)))
    got = tb.popcount_u32(tb.from_numpy_u32(x))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [1, 2, 4, 7])
def test_hamming_and_flip_parity(w):
    rng = np.random.default_rng(w)
    a = rng.integers(0, 2**32, (11, w), dtype=np.uint32)
    b = rng.integers(0, 2**32, (5, 1, w), dtype=np.uint32)
    want = np.asarray(jb.hamming_packed(jnp.asarray(a), jnp.asarray(b)))
    got = tb.hamming_packed(tb.from_numpy_u32(a), tb.from_numpy_u32(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tb.np_hamming_packed(a[:5], b[:, 0]),
                          jb.np_hamming_packed(a[:5], b[:, 0]))
    for k in (32 * w, 32 * w - 1, 32 * (w - 1) + 1):
        jflip = np.asarray(jb.flip_packed(jnp.asarray(a), k))
        tflip = _u32(tb.flip_packed(tb.from_numpy_u32(a), k))
        assert np.array_equal(tflip, jflip)


def test_flip_packed_does_not_write_its_input():
    a = tb.from_numpy_u32(np.array([[1, 2]], np.uint32))
    before = a.clone()
    tb.flip_packed(a, 40)
    assert torch.equal(a, before)


def test_numpy_boundary_roundtrip():
    x = np.array([[0, 0xFFFFFFFF, 0x80000000, 12345]], np.uint32)
    t = tb.from_numpy_u32(x)
    assert t.dtype == torch.int32
    assert np.array_equal(tb.to_numpy_u32(t), x)
