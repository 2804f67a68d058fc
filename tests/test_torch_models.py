"""The port's LM modules (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package's on the CPU, in float32.

Inputs come from a numpy seed; JAX weights (``repro.models.init_params``)
carry across through ``repro_torch.interop.params_from_numpy``.  Relative
error is max|port - jax| / max|jax| throughout.  Tolerances:
- layer primitives and the attention block: 1e-5 (a few float32 ulp of
  reduction-order difference between torch and XLA);
- whole-model logits, ``aux["normed"]`` and decode-step logits: 1e-4
  (the same differences carried through every layer);
- the port's decode step against its own teacher-forced forward: 3e-3,
  the bound of the JAX package's ``tests/test_models_smoke.py``;
- bf16 (the same bf16 weights on both sides): the port's answer must lie
  nearer JAX's bf16 answer than JAX's bf16 answer lies to JAX's float32
  one over those weights (the lower-precision control; the port sits at
  0.14-0.81 of it for these archs and seeds, a rounding step moved or
  dropped takes it past 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

DENSE = ("qwen3-1.7b", "qwen2.5-3b", "minitron-8b")
B, S = 2, 16


def rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    """name -> (cfg, JAX params, port Transformer), the reduced configs."""
    out = {}
    for i, name in enumerate(DENSE):
        cfg = jreg.REDUCED[name]
        jp = JL.init_params(jax.random.PRNGKey(i), JT.model_spec(cfg),
                            jnp.float32)
        tm = interop.params_from_numpy(treg.REDUCED[name],
                                       jax.tree.map(np.asarray, jp),
                                       device="cpu")
        out[name] = (cfg, jp, tm)
    return out


def tokens(cfg, seed, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)


# -- configs -----------------------------------------------------------------

def test_configs_are_copies():
    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)
    for name in jreg.ARCHS:
        assert (dataclasses.asdict(treg.get_arch(name))
                == dataclasses.asdict(jreg.get_arch(name)))
        assert (dataclasses.asdict(treg.REDUCED[name])
                == dataclasses.asdict(jreg.REDUCED[name]))
        assert ([dataclasses.asdict(c) for c in tbase.cells_for(
            treg.ARCHS[name])] == [dataclasses.asdict(c) for c in
                                   jbase.cells_for(jreg.ARCHS[name])])
    assert ({k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()})
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch("nope")


def test_model_spec_matches_jax():
    for name in jreg.REDUCED:
        cfg = treg.REDUCED[name]
        if name not in DENSE:
            with pytest.raises(NotImplementedError, match="item 11"):
                TT.model_spec(cfg)
            continue
        jspec = jax.tree.leaves(JT.model_spec(jreg.REDUCED[name]),
                                is_leaf=JL.is_spec)
        flat = []
        TL.tree_map(flat.append, TT.model_spec(cfg))
        assert [(s.shape, s.axes, s.init, s.scale) for s in flat] == [
            (s.shape, s.axes, s.init, s.scale) for s in jspec]


# -- layer primitives --------------------------------------------------------

def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=(2, 5, 64)) + 1).astype(np.float32)
    g = rng.normal(size=64).astype(np.float32)
    bt = rng.normal(size=64).astype(np.float32)
    assert rel(TL.rms_norm(t(x), t(g), 1e-6),
               JL.rms_norm(x, g, 1e-6)) <= 1e-5
    assert rel(TL.layer_norm(t(x), t(g), t(bt), 1e-5),
               JL.layer_norm(x, g, bt, 1e-5)) <= 1e-5
    # bf16 input: the float32 upcast, then the cast back
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = TL.rms_norm(xb, t(g), 1e-6)
    want = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), g, 1e-6)
    assert got.dtype == torch.bfloat16
    assert rel(got.float(), np.asarray(want, np.float32)) <= 1e-2


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(rng.integers(0, 4000, (2, 7)), (2, 7)).copy()
    got = TL.apply_rope(t(x), t(pos), theta)
    assert rel(got, JL.apply_rope(x, pos, theta)) <= 1e-5
    # the halves rotate, not even/odd pairs: position 0 is the identity
    assert torch.equal(TL.apply_rope(t(x), torch.zeros(2, 7,
                                                       dtype=torch.long),
                                     theta), t(x))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("gated", [True, False])
def test_ffn_matches_jax(act, gated):
    cfg = dataclasses.replace(jreg.REDUCED["qwen3-1.7b"], mlp_act=act,
                              mlp_gated=gated)
    rng = np.random.default_rng(2)
    spec = JL.ffn_spec(cfg, 48, 96)
    p = {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(
        np.float32) for k, s in spec.items()}
    assert sorted(TL.ffn_spec(cfg, 48, 96)) == sorted(spec)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    got = TL.apply_ffn(cfg, {k: t(v) for k, v in p.items()}, t(x))
    assert rel(got, JL.apply_ffn(cfg, p, x)) <= 1e-5


def test_init_params_distributions():
    cfg = treg.REDUCED["qwen2.5-3b"]
    gen = torch.Generator().manual_seed(0)
    tree = TL.init_params(TT.model_spec(cfg), torch.float32, generator=gen,
                          device="cpu")
    assert float(tree["embed"].std()) == pytest.approx(0.02, rel=0.05)
    body = tree["body"]["b0"]
    # fan_in of a stacked spec is its first dim (the layer count), as in
    # the JAX package
    n_rep = body["attn"]["w_q"].shape[0]
    assert float(body["attn"]["w_q"].std()) == pytest.approx(
        1 / np.sqrt(n_rep), rel=0.05)
    assert not body["attn"]["b_q"].any()
    assert not body["ln1"]["gamma"].any()
    again = TL.init_params(TT.model_spec(cfg), torch.bfloat16,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert again["embed"].dtype == torch.bfloat16
    assert torch.equal(again["embed"], tree["embed"].to(torch.bfloat16))


# -- attention ---------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("window", [None, 5])
def test_gqa_forward_and_prefill_cache(models, name, window):
    cfg, jp, tm = models[name]
    rng = np.random.default_rng(3)
    p = {k: np.asarray(v[0]) for k, v in jp["body"]["b0"]["attn"].items()}
    if cfg.qkv_bias:
        p = {k: (v + rng.normal(size=v.shape).astype(np.float32)
                 if k.startswith("b_") else v) for k, v in p.items()}
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    jy, jc = JA.gqa_forward(cfg, p, x, pos, window=window, make_cache=True,
                            cache_len=S + 4)
    ty, tc = TA.gqa_forward(cfg, {k: t(v) for k, v in p.items()}, t(x),
                            t(pos), window=window, make_cache=True,
                            cache_len=S + 4)
    assert rel(ty, jy) <= 1e-5
    for k in ("k", "v"):
        assert rel(tc[k], jc[k]) <= 1e-5


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("window", [None, 6])
def test_gqa_decode(models, name, window):
    """Several decode steps from a prefill cache; with window=6 and 8
    slots-worth of steps the ring wraps."""
    cfg, jp, tm = models[name]
    rng = np.random.default_rng(4)
    p = {k: np.asarray(v[1]) for k, v in jp["body"]["b0"]["attn"].items()}
    s0, cache_len = 5, 14
    x = rng.normal(size=(B, s0, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s0), (B, s0)).copy()
    tp = {k: t(v) for k, v in p.items()}
    _, jc = JA.gqa_forward(cfg, p, x, pos, window=window, make_cache=True,
                           cache_len=cache_len)
    _, tc = TA.gqa_forward(cfg, tp, t(x), t(pos), window=window,
                           make_cache=True, cache_len=cache_len)
    for step in range(8):
        xt = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        jy, jc = JA.gqa_decode(cfg, p, xt, jc, s0 + step, window=window)
        ty, tc = TA.gqa_decode(cfg, tp, t(xt), tc, s0 + step, window=window)
        assert rel(ty, jy) <= 1e-5, step
        assert rel(tc["k"], jc["k"]) <= 1e-5


def test_decode_past_the_cache_raises(models):
    _, _, tm = models["qwen3-1.7b"]
    cfg = tm.cfg
    cache = TT.init_cache(cfg, 1, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="past the cache"):
        TT.decode_step(cfg, tm, torch.zeros(1, dtype=torch.long), cache, 4)


def test_a_config_other_than_the_models_raises(models):
    """cfg travels beside the model, as in the JAX signatures; any other
    config than the one the model was built from is refused."""
    _, _, tm = models["qwen3-1.7b"]
    other = dataclasses.replace(tm.cfg, num_layers=tm.cfg.num_layers - 1)
    tok = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="does not match the model"):
        TT.forward(other, tm, {"tokens": tok})
    with pytest.raises(ValueError, match="does not match the model"):
        TT.decode_step(other, tm, tok[:, 0],
                       TT.init_cache(tm.cfg, 1, 4, torch.float32,
                                     device="cpu"), 0)
    with pytest.raises(ValueError, match="does not match the model"):
        TT.forward(treg.REDUCED["qwen2.5-3b"], tm, {"tokens": tok})


# -- whole model -------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_forward_matches_jax(models, name):
    cfg, jp, tm = models[name]
    tok = tokens(cfg, 5)
    jl, _, jaux = JT.forward(cfg, jp, {"tokens": jnp.asarray(tok)})
    tl, caches, taux = TT.forward(tm.cfg, tm, {"tokens": t(tok).long()})
    assert caches is None
    assert rel(tl, jl) <= 1e-4
    assert rel(taux["normed"], jaux["normed"]) <= 1e-4
    assert rel(taux["hidden"], jaux["hidden"]) <= 1e-4
    none, _, aux2 = TT.forward(tm.cfg, tm, {"tokens": t(tok).long()},
                               return_logits=False)
    assert none is None and torch.equal(aux2["normed"], taux["normed"])


@pytest.mark.parametrize("name", DENSE)
def test_prefill_then_decode_matches_jax(models, name):
    cfg, jp, tm = models[name]
    tok = tokens(cfg, 6)
    half = S // 2
    _, jc, _ = JT.forward(cfg, jp, {"tokens": jnp.asarray(tok[:, :half])},
                          mode="prefill", cache_len=S)
    _, tc, _ = TT.forward(tm.cfg, tm, {"tokens": t(tok[:, :half]).long()},
                          mode="prefill", cache_len=S)
    # the JAX body caches are stacked (n_rep, ...); the port's one per layer
    for kv in ("k", "v"):
        want = np.asarray(jc["body"][0][kv])
        got = torch.stack([c[kv] for c in tc])
        assert rel(got, want) <= 1e-4
    jd, jc = JT.decode_step(cfg, jp, jnp.asarray(tok[:, half]), jc, half)
    td, tc = TT.decode_step(tm.cfg, tm, t(tok[:, half]).long(), tc, half)
    assert rel(td, jd) <= 1e-4
    jd2, _ = JT.decode_step(cfg, jp, jnp.asarray(tok[:, half + 1]), jc,
                            half + 1)
    td2, _ = TT.decode_step(tm.cfg, tm, t(tok[:, half + 1]).long(), tc,
                            half + 1)
    assert rel(td2, jd2) <= 1e-4


@pytest.mark.parametrize("name", DENSE)
def test_bf16_matches_jax_bf16(models, name):
    """bf16 weights: logits, aux["normed"], the prefill caches and the
    decode-step logits come in JAX's dtypes and within the bf16 control
    (module docstring)."""
    cfg, jp, _ = models[name]
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    tm = interop.params_from_numpy(treg.REDUCED[name],
                                   jax.tree.map(np.asarray, jp),
                                   device="cpu", dtype=torch.bfloat16)
    assert torch.equal(tm.embed.float(), t(jp32["embed"]))
    tok = tokens(cfg, 5)
    half = S // 2

    def run_jax(params):
        lg, _, aux = JT.forward(cfg, params, {"tokens": jnp.asarray(tok)})
        _, c, _ = JT.forward(cfg, params,
                             {"tokens": jnp.asarray(tok[:, :half])},
                             mode="prefill", cache_len=S)
        dec, _ = JT.decode_step(cfg, params, jnp.asarray(tok[:, half]), c,
                                half)
        return (lg, aux["normed"], dec), c["body"][0]["k"].dtype

    (j16, cache_dt), (j32, _) = run_jax(jp16), run_jax(jp32)
    lg, _, aux = TT.forward(tm.cfg, tm, {"tokens": t(tok).long()})
    _, c, _ = TT.forward(tm.cfg, tm, {"tokens": t(tok[:, :half]).long()},
                         mode="prefill", cache_len=S)
    dec, _ = TT.decode_step(tm.cfg, tm, t(tok[:, half]).long(), c, half)
    assert str(cache_dt) == "bfloat16"
    assert all(x[kv].dtype == torch.bfloat16 for x in c for kv in "kv")
    for what, got, want16, want32 in zip(
            ("logits", "normed", "decode logits"), (lg, aux["normed"], dec),
            j16, j32):
        assert str(want16.dtype) == "bfloat16" and got.dtype == torch.bfloat16
        control = rel(want16.astype(jnp.float32), want32)
        assert rel(got.float(), want16.astype(jnp.float32)) <= control, what


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_forward(models, name):
    """The port's decode with caches reproduces its teacher-forced
    logits (the JAX package's property)."""
    _, _, tm = models[name]
    cfg = tm.cfg
    tok = t(tokens(cfg, 7)).long()
    half = S // 2
    _, caches, _ = TT.forward(cfg, tm, {"tokens": tok[:, :half]},
                              mode="prefill", cache_len=S)
    dec, _ = TT.decode_step(cfg, tm, tok[:, half], caches, half)
    full, _, _ = TT.forward(cfg, tm, {"tokens": tok})
    assert rel(dec, full[:, half].numpy()) < 3e-3


def test_unported_archs_raise():
    for name, cfg in treg.REDUCED.items():
        if name in DENSE:
            continue
        with pytest.raises(NotImplementedError, match="item 11"):
            TT.plan_segments(cfg)
        with pytest.raises(NotImplementedError, match="item 11"):
            TT.init_cache(cfg, 1, 4, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        TT.block_spec(treg.REDUCED["mamba2-780m"], "ssm")


def test_params_from_numpy_checks_every_leaf(models):
    cfg, jp, _ = models["qwen2.5-3b"]
    tree = jax.tree.map(np.asarray, jp)
    tm = interop.params_from_numpy(cfg, tree, device="cpu")
    n_leaves = len(jax.tree.leaves(tree))
    n_rep = cfg.num_layers
    stacked = len(jax.tree.leaves(tree["body"]))
    assert len(list(tm.parameters())) == n_leaves - stacked + n_rep * stacked
    assert tm.blocks[1].attn["w_q"].shape == (cfg.d_model,
                                              cfg.num_heads * cfg.head_dim)
    np.testing.assert_array_equal(tm.blocks[1].attn.w_q.numpy(),
                                  tree["body"]["b0"]["attn"]["w_q"][1])
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="keys"):
        interop.params_from_numpy(cfg, extra, device="cpu")
    missing = dict(tree)
    missing.pop("unembed", None)
    missing["body"] = {"b0": {k: v for k, v in tree["body"]["b0"].items()
                              if k != "ln2"}}
    with pytest.raises(ValueError, match="keys"):
        interop.params_from_numpy(cfg, missing, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["body"]["b0"]["ffn"]["w_up"] = bad["body"]["b0"]["ffn"]["w_up"][:1]
    with pytest.raises(ValueError, match="shape"):
        interop.params_from_numpy(cfg, bad, device="cpu")
