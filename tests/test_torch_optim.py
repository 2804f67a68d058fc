"""The port's optimizer (``repro_torch.optim``) against the JAX package's
on the CPU: the mirrors of ``tests/test_optim_ckpt.py``'s optimizer tests,
``apply_updates`` for each moment dtype given the same gradients, and the
compressed gradient all-reduce (the mirror of
``tests/test_distribution.py::test_compressed_psum_error_feedback``).

Tolerances:
- the schedule, the global norm and float32 / bfloat16 moments and
  parameters after ``apply_updates``: a few float32 ulp (torch's and XLA's
  pow, sqrt and reductions round apart), stated per assertion;
- int8 moments with the reference's uniforms injected: the codes equal
  but where floor(x / scale + u) sits within float32 rounding of an
  integer (at most one code step, in < 1e-3 of the elements); the
  scales within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.optim import adamw as JO  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.optim.grad_compress import (compressed_psum,  # noqa: E402
                                             init_residuals)
from repro_torch.utils.mesh import make_mesh  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))


def rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1),
       st.sampled_from([(256,), (3, 512), (5,), (7, 100), (2, 3, 1024)]))
def test_quantize_roundtrip_error(seed, shape):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) * 10
    q, s = TO.quantize_blockwise(x)
    assert q.shape == x.shape and q.dtype == torch.int8
    back = TO.dequantize_blockwise(q, s)
    err = (back - x).abs().max().item()
    assert err <= x.abs().max().item() / 127 + 1e-6


@pytest.mark.parametrize("shape", [(256,), (3, 512), (5,), (7, 100),
                                   (2, 3, 1024), ()])
def test_quantize_matches_jax(shape):
    """Codes bit for bit (round to nearest, and stochastic with the same
    uniforms), scales within 1e-6."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=shape) * 10).astype(np.float32)
    u = rng.random(size=shape).astype(np.float32)
    jq, js = JO.quantize_blockwise(jnp.asarray(x))
    tq, ts = TO.quantize_blockwise(t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert rel(ts, js) <= 1e-6 and ts.shape == js.shape
    assert rel(TO.dequantize_blockwise(tq, ts),
               JO.dequantize_blockwise(jq, js)) <= 1e-6
    # stochastic: the reference draws uniform(key, shape); feed those
    key = jax.random.PRNGKey(3)
    ju = np.asarray(jax.random.uniform(key, shape))
    jq2, _ = JO.quantize_blockwise(jnp.asarray(x), key)
    tq2, _ = TO.quantize_blockwise(t(x), t(ju))
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    del u


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_converges(moment_dtype):
    """Minimize ||x - target||^2: every moment dtype converges."""
    target = torch.linspace(-2, 2, 512)
    params = {"x": torch.zeros(512)}
    cfg = TO.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=5,
                         total_steps=200, moment_dtype=moment_dtype)
    state = TO.init_opt_state(params, cfg)
    for _ in range(150):
        g = {"x": 2 * (params["x"] - target)}
        params, state, metrics = TO.apply_updates(params, g, state, cfg)
    assert float((params["x"] - target).abs().mean()) < 0.05
    assert int(state["step"]) == 150


def test_schedule_shape():
    cfg = TO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    assert TO.schedule(cfg, 0) == 0.0
    assert TO.schedule(cfg, 10) == pytest.approx(1.0, rel=1e-3)
    assert TO.schedule(cfg, 100) == pytest.approx(0.1, rel=1e-2)
    jcfg = JO.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=40)
    tcfg = TO.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=40)
    for step in range(0, 45):
        # float32 on both sides; cos may round an ulp apart
        assert TO.schedule(tcfg, step) == pytest.approx(
            float(JO.schedule(jcfg, jnp.int32(step))), rel=2e-7, abs=1e-12)


def _tree(rng, scale=1.0):
    """A JAX-layout tree with the shapes the models' leaves take: a
    256-block-divisible matrix, a ragged one, a vector, nested lists."""
    def a(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"w": a(4, 512), "blocks": [{"b": a(7), "u": a(3, 100)},
                                       {"b": a(7), "u": a(3, 100)}],
            "emb": a(6, 256)}


def _to_torch(tree):
    return jax.tree.map(lambda x: t(x), tree)


def _flat_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_apply_updates_matches_jax(moment_dtype):
    """Three steps from the same parameters with the same gradients (the
    JAX ones), so Adam's near-sign(g) first update cannot flip on a
    rounding: the parameters, the moments, the global norm and the lr.
    int8 takes the reference's uniforms, leaf by leaf in its tree order:
    uniform(fold_in(fold_in(PRNGKey(0), step), i), shape)."""
    rng = np.random.default_rng(11)
    params = _tree(rng)
    grads = [_tree(rng, 0.3 * (k + 1)) for k in range(3)]
    jcfg = JO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          moment_dtype=moment_dtype, grad_clip=1.0)
    tcfg = TO.AdamWConfig(**{f: getattr(jcfg, f) for f in
                             jcfg.__dataclass_fields__})
    jp = jax.tree.map(jnp.asarray, params)
    js = JO.init_opt_state(jp, jcfg)
    tp = _to_torch(params)
    ts = TO.init_opt_state(tp, tcfg)
    assert TO.tree_leaves(tp)[0] is tp["blocks"][0]["b"]   # sorted order

    def draws(step, i, shape):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                    step), i)
        return t(np.asarray(jax.random.uniform(key, shape)))

    for g in grads:
        jp, js, jm = JO.apply_updates(jp, jax.tree.map(jnp.asarray, g), js,
                                      jcfg)
        tp, ts, tm = TO.apply_updates(tp, _to_torch(g), ts, tcfg,
                                      uniforms=draws)
        assert rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 3
    for got, want in zip(TO.tree_leaves(tp), _flat_np(jp), strict=True):
        assert rel(got, want) <= 1e-6
    for kind in ("m", "v"):
        got = TO.tree_leaves(ts[kind])
        want = _flat_np(js[kind])
        assert len(got) == len(want)
        for g_, w in zip(got, want):
            if moment_dtype == "bfloat16":
                assert g_.dtype == torch.bfloat16
                assert rel(g_.float(), w.astype(np.float32)) <= 1e-2
            elif g_.dtype == torch.int8:
                d = np.abs(g_.numpy().astype(int) - w.astype(int))
                assert d.max() <= 1 and (d > 0).mean() < 1e-3, kind
            else:
                assert rel(g_, w) <= 1e-6, kind


def test_apply_updates_bf16_moments_match_jax_exactly_enough():
    """bfloat16 moments: each element the reference's bf16 value or one
    bf16 step from it (the float32 update before the cast rounds a few
    ulp apart), in < 1e-3 of the elements."""
    rng = np.random.default_rng(12)
    params, g = _tree(rng), _tree(rng, 0.5)
    jcfg = JO.AdamWConfig(moment_dtype="bfloat16")
    tcfg = TO.AdamWConfig(moment_dtype="bfloat16")
    jp = jax.tree.map(jnp.asarray, params)
    _, js, _ = JO.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                JO.init_opt_state(jp, jcfg), jcfg)
    tp = _to_torch(params)
    _, ts, _ = TO.apply_updates(tp, _to_torch(g), TO.init_opt_state(tp, tcfg),
                                tcfg)
    for kind in ("m", "v"):
        for got, want in zip(TO.tree_leaves(ts[kind]), _flat_np(js[kind])):
            a = got.view(torch.int16).numpy().astype(int)
            b = want.view(np.int16).astype(int)
            assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3


def test_int8_draws_are_seeded_by_step_and_leaf():
    """Without injected uniforms a step's draws come from (seed, step,
    leaf): two runs agree bit for bit, another seed differs."""
    def run(seed):
        tp = _to_torch(_tree(np.random.default_rng(1)))
        cfg = TO.AdamWConfig(moment_dtype="int8")
        st_ = TO.init_opt_state(tp, cfg)
        g = _to_torch(_tree(np.random.default_rng(2), 1e-3))
        for _ in range(2):
            TO.apply_updates(tp, g, st_, cfg, seed=seed)
        return [x.numpy().copy() for x in TO.tree_leaves(st_["m"])]
    a, b, c = run(0), run(0), run(1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(5), 3.0)
    assert rel(TO.global_norm(_to_torch(tree)),
               JO.global_norm(jax.tree.map(jnp.asarray, tree))) <= 1e-6


def test_compressed_psum_error_feedback():
    """4 shards co-located on the CPU: the int8 all-reduce's mean within
    5% of the exact mean's scale (the reference's bound), the residuals
    the quantisation error, and the codes crossing to the merge device."""
    mesh = make_mesh((4,), ("dp",), devices=["cpu"] * 4)
    g = np.random.default_rng(0).normal(size=(4, 256)).astype(np.float32)
    grads = [{"w": t(g[i:i + 1])} for i in range(4)]
    res = [init_residuals({"w": torch.zeros(256)}) for _ in range(4)]
    mean_g, new_r = compressed_psum(grads, res, mesh)
    exact = g.mean(0)
    err = np.abs(mean_g["w"].numpy() - exact).max()
    assert err < 0.05 * np.abs(exact).max() + 1e-3, err
    for i in range(4):
        q, s = TO.quantize_blockwise(t(g[i:i + 1]))
        np.testing.assert_allclose(
            new_r[i]["w"].numpy(),
            g[i:i + 1] - TO.dequantize_blockwise(q, s).numpy(), atol=1e-7)
    # error feedback: the same gradients again with the residuals carried;
    # the mean over both rounds is nearer the exact one than one round's
    mean2, _ = compressed_psum(grads, new_r, mesh)
    two = (mean_g["w"] + mean2["w"]).numpy() / 2
    assert np.abs(two - exact).max() <= err
    with pytest.raises(ValueError, match="mesh of 4"):
        compressed_psum(grads[:3], res[:3], mesh)
