"""The port's chunked online-softmax attention
(``repro_torch.models.attention.flash_attention`` and its windowed branch)
against the JAX package's on the CPU, at sizes where every forward case
runs at least two query and two kv chunks: the function alone, its
gradients, the checks where the reference asserts, and the blocks and
whole models that call it at S = 1,024 (two default 512-token chunks).

Inputs come from a numpy seed.  Relative error is max|port - jax| /
max|jax|.  Tolerances:
- the function and the attention blocks in float32: 1e-5, as
  ``tests/test_torch_models.py`` holds ``gqa_forward`` (a few float32 ulp
  of reduction-order difference between torch and XLA);
- gradients in float32: 1e-4 (the same differences through the backward
  pass's longer sums);
- whole-model logits and ``aux["normed"]``: 1e-4, with RG-LRU blocks the
  larger of 1e-4 and the reference's own one-ulp move
  (``test_torch_models.jax_and_tols``);
- bf16 operands: the port's output must lie nearer the reference's bf16
  output, run op by op under ``jax.disable_jit``, than that lies to the
  reference's float32 output over the same (bf16-valued) operands.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from test_torch_models import jax_and_tols, rel, t  # noqa: E402

B, S, H, HD = 2, 64, 4, 16
LONG = 1024                      # two of the default 512-token chunks


def operands(seed, groups, v_dim, s=S, dtype=np.float32):
    """q (B, s, H, HD); k (B, s, H / groups, HD); v (.., v_dim)."""
    rng = np.random.default_rng(seed)
    kh = H // groups
    q = rng.normal(size=(B, s, H, HD)).astype(dtype)
    k = rng.normal(size=(B, s, kh, HD)).astype(dtype)
    v = rng.normal(size=(B, s, kh, v_dim)).astype(dtype)
    return q, k, v


def jax_flash(q, k, v, **kw):
    """The reference's ``flash_attention``; a v narrower than q is padded
    to q's width and the output sliced back, as its ``mla_forward``
    does (its kernel takes v at q's width only)."""
    vd, hd = v.shape[-1], q.shape[-1]
    vpad = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, hd - vd)))
    return JA.flash_attention(q, k, vpad, **kw)[..., :vd]


# -- the function --------------------------------------------------------------

# (window, v width, TILE_BYTES): TILE_BYTES = 1 puts every query chunk in
# a block of its own, so the port's block loop runs too
VARIANTS = {"plain": (None, HD, None), "narrow-v": (None, HD // 2, None),
            "narrow-v-blocks": (None, HD // 2, 1), "window": (12, HD, None),
            "window-narrow-v-blocks": (12, HD // 2, 1)}


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("q_offset", [0, 16])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flash_attention_matches_jax(monkeypatch, chunk, causal, groups,
                                     q_offset, variant):
    """S = 64 in chunks of 8 or 16: 4-8 query chunks, and 4-8 kv chunks
    (or windowed spans); v narrower than q and k in two variants."""
    window, v_dim, tile = VARIANTS[variant]
    if tile is not None:
        monkeypatch.setattr(TA, "TILE_BYTES", tile)
    q, k, v = operands(chunk + groups + q_offset, groups, v_dim)
    kw = dict(causal=causal, window=window, q_chunk=chunk, kv_chunk=chunk,
              q_offset=q_offset)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = TA.flash_attention(t(q), t(k), t(v), **kw)
    assert got.shape == want.shape == (B, S, H, v_dim)
    assert got.dtype == torch.float32
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("window", [None, 12])
def test_flash_attention_bf16_matches_jax_bf16(window):
    """bf16 operands: the output dtype is the reference's (q's, or k's
    for a window) and within the bf16 control (module docstring)."""
    q, k, v = operands(7, 2, HD)
    j16 = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    j32 = [a.astype(jnp.float32) for a in j16]
    kw = dict(window=window, q_chunk=16, kv_chunk=16)
    with jax.disable_jit():
        want16 = JA.flash_attention(*j16, **kw)
        want32 = JA.flash_attention(*j32, **kw)
    got = TA.flash_attention(*[t(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in j16], **kw)
    assert str(want16.dtype) == "bfloat16" and got.dtype == torch.bfloat16
    control = rel(want16.astype(jnp.float32), want32)
    assert rel(got.float(), want16.astype(jnp.float32)) <= control


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("groups", [1, 2])
def test_flash_attention_gradients_match_jax(window, groups):
    """d/d(q, k, v) of sum(out * w) against ``jax.grad`` of the reference,
    4 query and 4 kv chunks (or spans), v narrower than q and k."""
    q, k, v = operands(11 + groups, groups, HD // 2)
    w = np.random.default_rng(12).normal(size=(B, S, H, HD // 2)).astype(
        np.float32)
    kw = dict(window=window, q_chunk=16, kv_chunk=16, q_offset=0)

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, **kw) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    (TA.flash_attention(tq, tk, tv, **kw) * t(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert rel(got, ref) <= 1e-4, name


def test_raises_where_the_reference_asserts():
    """A query count that is not a multiple of the query chunk, or a key
    count not a multiple of the kv chunk (without a window): the
    reference asserts, the port raises ValueError."""
    q, k, v = operands(3, 1, HD, s=48)
    for kw in (dict(q_chunk=32), dict(kv_chunk=32),
               dict(q_chunk=32, window=12)):
        with pytest.raises(AssertionError):
            JA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
        with pytest.raises(ValueError, match="not a multiple"):
            TA.flash_attention(t(q), t(k), t(v), **kw)
    # a window takes no kv chunks: 48 keys in chunks of 32 are not checked
    TA.flash_attention(t(q), t(k), t(v), q_chunk=16, kv_chunk=32, window=12)


def test_one_kv_chunk_is_the_single_softmax():
    """With one chunk each way the online softmax is the plain one, and
    the default chunks at S = 1,024 agree with it within float32
    rounding."""
    q, k, v = operands(5, 2, HD, s=LONG)
    tq, tk, tv = t(q), t(k), t(v)
    one = TA.flash_attention(tq, tk, tv, q_chunk=LONG, kv_chunk=LONG)
    scores = torch.einsum("bqhd,bshd->bhqs", tq,
                          torch.repeat_interleave(tk, 2, dim=2)) / HD ** 0.5
    mask = torch.ones(LONG, LONG, dtype=torch.bool).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    plain = torch.einsum("bhqs,bshd->bqhd", p,
                         torch.repeat_interleave(tv, 2, dim=2))
    assert rel(one, plain) <= 1e-5
    assert rel(TA.flash_attention(tq, tk, tv), one) <= 1e-5


# -- the blocks and the models at S = 1,024 --------------------------------------

def _params(name, seed):
    cfg = jreg.REDUCED[name]
    jp = JL.init_params(jax.random.PRNGKey(seed), JT.model_spec(cfg),
                        jnp.float32)
    return cfg, jp


@pytest.mark.parametrize("name,window", [("qwen3-1.7b", None),
                                         ("recurrentgemma-2b", 16)])
def test_gqa_forward_at_two_chunks(name, window):
    cfg, jp = _params(name, 1)
    body = jp["body"]["b0" if name == "qwen3-1.7b" else "b2"]["attn"]
    p = {k: np.asarray(v[0]) for k, v in body.items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, LONG, cfg.d_model)).astype(np.float32)
    pos = np.arange(LONG)[None]
    jy, jc = JA.gqa_forward(cfg, p, x, pos, window=window, make_cache=True,
                            cache_len=LONG)
    ty, tc = TA.gqa_forward(cfg, {k: t(v) for k, v in p.items()}, t(x),
                            t(pos), window=window, make_cache=True,
                            cache_len=LONG)
    assert rel(ty, jy) <= 1e-5
    for k in ("k", "v"):
        assert rel(tc[k], jc[k]) <= 1e-5


def test_mla_forward_at_two_chunks():
    cfg, jp = _params("minicpm3-4b", 3)
    p = {k: np.asarray(v[0]) for k, v in jp["body"]["b0"]["attn"].items()}
    x = np.random.default_rng(4).normal(size=(1, LONG, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(LONG)[None]
    jy, _ = JA.mla_forward(cfg, p, x, pos)
    ty, _ = TA.mla_forward(cfg, {k: t(v) for k, v in p.items()}, t(x),
                           t(pos))
    assert rel(ty, jy) <= 1e-5


@pytest.mark.parametrize("name", ["qwen3-1.7b", "recurrentgemma-2b",
                                  "minicpm3-4b"])
def test_forward_at_two_chunks(name):
    """The whole reduced model over one 1,024-token sequence."""
    cfg, jp = _params(name, 5)
    tm = interop.params_from_numpy(treg.REDUCED[name],
                                   jax.tree.map(np.asarray, jp),
                                   device="cpu")
    tok = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                            (1, LONG)).astype(np.int32)

    def run():
        jl, _, aux = JT.forward(cfg, jp, {"tokens": jnp.asarray(tok)})
        return jl, aux["normed"]

    want, tols = jax_and_tols(cfg, run)
    tl, _, aux = TT.forward(tm.cfg, tm, {"tokens": t(tok).long()})
    for what, got, w, tol in zip(("logits", "normed"), (tl, aux["normed"]),
                                 want, tols):
        assert rel(got, w) <= tol, what


def test_chunk_defaults_are_the_references():
    """The defaults the blocks call with (512 x 512) are the
    reference's."""
    for fn in (JA.flash_attention, TA.flash_attention):
        sig = inspect.signature(fn).parameters
        assert (sig["q_chunk"].default, sig["kv_chunk"].default,
                sig["causal"].default, sig["q_offset"].default) == \
            (512, 512, True, 0)
