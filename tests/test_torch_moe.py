"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the CPU.

Inputs come from a numpy seed: B = 2 rows of S = 16 tokens, E = 8
experts, top k = 2, d_model 128 (the reduced deepseek-moe-16b, one shared
expert), at capacity factors 8.0 (drop-free), 1.25 and 0.5 (tokens drop;
each such case asserts that some did).  Relative error is max|port - jax|
/ max|jax|.  Tolerances:
- top-k ids and the dispatch's integers (sort order, token, slot,
  validity): bit for bit;
- ``apply_moe`` in float32: 1e-5 (float32 reduction order differs between
  torch and XLA; the routing itself is identical);
- ``load_balance_loss``: 1e-6;
- bf16 (the same bf16 weights and input on both sides): the port's answer
  must lie nearer JAX's bf16 answer than JAX's bf16 answer lies to JAX's
  float32 one over those weights (the lower-precision control).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

NAME = "deepseek-moe-16b"
B, S = 2, 16


def rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def configs(**kw):
    """The reduced config in both packages, with kw replaced."""
    return (dataclasses.replace(jreg.REDUCED[NAME], **kw),
            dataclasses.replace(treg.REDUCED[NAME], **kw))


def weights(cfg, seed=0):
    """numpy weights of moe_spec's shapes; the router at 1/sqrt(d), so
    that routing is decisive rather than near uniform."""
    rng = np.random.default_rng(seed)

    def one(spec):
        return (rng.normal(size=spec.shape)
                / np.sqrt(spec.shape[-2])).astype(np.float32)
    return TL.tree_map(one, TM.moe_spec(cfg))


def as_torch(tree, dtype=torch.float32):
    return TL.tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


def as_jax(tree, dtype=jnp.float32):
    return TL.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def inputs(cfg, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def jax_dispatch(cfg, ids):
    """The JAX package's dispatch steps (``repro/models/moe.py``, from the
    capacity to the slot), on ids (B, S, k)."""
    b, s, k = ids.shape
    e = cfg.num_experts
    cap = max(1, math.ceil(cfg.capacity_factor * s * k / e))
    flat_ids = ids.reshape(b, s * k)
    sort_idx = jnp.argsort(flat_ids, axis=1)
    tok = sort_idx // k
    eid = jnp.take_along_axis(flat_ids, sort_idx, axis=1)
    first = jax.vmap(lambda row: jnp.searchsorted(row, row, side="left"))(eid)
    rank = jnp.arange(s * k, dtype=jnp.int32)[None, :] - first.astype(
        jnp.int32)
    valid = rank < cap
    slot = jnp.where(valid, eid * cap + rank, e * cap)
    return sort_idx, tok, slot, valid


def jax_ids(cfg, p, x):
    logits = jnp.einsum("bsd,de->bse", x, p["router"])
    return jax.lax.top_k(JM.router_probs(cfg, logits), cfg.experts_per_token)


def test_spec_matches_jax():
    jc, tc = configs()
    jspec = jax.tree.leaves(JM.moe_spec(jc), is_leaf=JL.is_spec)
    flat = []
    TL.tree_map(flat.append, TM.moe_spec(tc))
    assert [(s.shape, s.axes, s.init, s.scale) for s in flat] == [
        (s.shape, s.axes, s.init, s.scale) for s in jspec]


@pytest.mark.parametrize("score", ["softmax", "sigmoid"])
def test_router_probs_match_jax(score):
    jc, tc = configs(router_score=score)
    logits = 3 * np.random.default_rng(2).normal(size=(B, S, 8)).astype(
        np.float32)
    got = TM.router_probs(tc, torch.from_numpy(logits))
    assert rel(got, JM.router_probs(jc, logits)) <= 1e-6


def test_top_k_breaks_ties_as_lax_top_k():
    """Probabilities on a coarse grid tie often: the ids must come in
    lax.top_k's order, the lower id first among equal values."""
    rng = np.random.default_rng(3)
    probs = (rng.integers(0, 4, size=(64, 8)) / 4).astype(np.float32)
    for k in (1, 2, 6):
        jv, ji = jax.lax.top_k(probs, k)
        tv, ti = TM.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
def test_dispatch_matches_jax_bit_for_bit(cf):
    jc, tc = configs(capacity_factor=cf)
    p = weights(jc)
    _, ids = jax_ids(jc, as_jax(p), inputs(jc))
    want = jax_dispatch(jc, ids)
    got = TM._dispatch(tc, torch.from_numpy(np.array(ids)).long())
    for what, g, w in zip(("sort_idx", "tok", "slot", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), what)
    dropped = int((~got[3]).sum())
    if cf == 8.0:
        assert dropped == 0
    else:
        assert dropped > 0
    # a row of repeated ids: ranks count up within an expert, the stable
    # sort keeps the first-come assignments
    ids = np.zeros((1, 6, 2), np.int32)
    ids[0, :, 1] = 3
    want = jax_dispatch(jc, ids)
    got = TM._dispatch(tc, torch.from_numpy(ids).long())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("score", ["softmax", "sigmoid"])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
def test_apply_moe_matches_jax(score, cf):
    jc, tc = configs(capacity_factor=cf, router_score=score)
    assert (tc.num_experts, tc.experts_per_token, tc.d_model) == (8, 2, 128)
    p = weights(jc)
    x = inputs(jc)
    want = JM.apply_moe(jc, as_jax(p), x)
    got = TM.apply_moe(tc, as_torch(p), torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert rel(got, want) <= 1e-5
    _, ids = jax_ids(jc, as_jax(p), x)
    dropped = int((~np.asarray(jax_dispatch(jc, ids)[3])).sum())
    assert (dropped == 0) == (cf == 8.0), dropped


def test_apply_moe_decode_shape_never_drops():
    """S = 1 (a decode step): capacity 1, and a token's k experts are
    distinct, so nothing drops; the answer equals JAX's."""
    jc, tc = configs(capacity_factor=1.25)
    assert TM.capacity(tc, 1) == 1
    p = weights(jc)
    x = inputs(jc)[:, :1]
    want = JM.apply_moe(jc, as_jax(p), x)
    got = TM.apply_moe(tc, as_torch(p), torch.from_numpy(x))
    assert rel(got, want) <= 1e-5
    _, ids = jax_ids(jc, as_jax(p), x)
    assert bool(np.asarray(jax_dispatch(jc, ids)[3]).all())


def test_load_balance_loss_matches_jax():
    jc, tc = configs()
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(B * S, 8)).astype(np.float32)
    ids = np.array(jax.lax.top_k(logits, 2)[1])
    want = JM.load_balance_loss(jc, logits, ids)
    got = TM.load_balance_loss(tc, torch.from_numpy(logits),
                               torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_apply_moe_bf16_within_bf16_gap(cf):
    jc, tc = configs(capacity_factor=cf)
    p = weights(jc)
    x = inputs(jc)
    x16 = jnp.asarray(x, jnp.bfloat16)
    want16 = JM.apply_moe(jc, as_jax(p, jnp.bfloat16), x16)
    want32 = JM.apply_moe(jc, TL.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16).astype(jnp.float32), p),
        x16.astype(jnp.float32))
    got = TM.apply_moe(tc, as_torch(p, torch.bfloat16),
                       torch.from_numpy(x).to(torch.bfloat16))
    assert str(want16.dtype) == "bfloat16" and got.dtype == torch.bfloat16
    control = rel(np.asarray(want16.astype(jnp.float32)), want32)
    assert control > 0
    assert rel(got, want16.astype(jnp.float32)) <= control
