"""The port's recurrent blocks (``repro_torch.models.rglru``, the RG-LRU of
recurrentgemma-2b; ``repro_torch.models.ssm``, the Mamba-2 SSD mixer of
mamba2-780m) against the JAX package's on the CPU.

Weights are the JAX package's init of one (unstacked) block of the reduced
configs (``repro.models.init_params``, the "rglru_lambda" init included),
carried across as numpy arrays; inputs come from a numpy seed at unit
scale.  Relative error is max|port - jax| / max|jax|.  Tolerances:
- float32 blocks, caches and decode steps: 1e-5 (float32 reduction order:
  the reference's associative scan and three-operand einsums pair their
  products in another order than the port's doubling scan and pairwise
  products);
- the doubling scan against a sequential float64 recurrence: 1e-6;
- bf16 (the same bf16 weights and input on both sides): the port's answer
  must lie nearer JAX's bf16 answer than JAX's bf16 answer lies to JAX's
  float32 one over those weights (the lower-precision control).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

B = 2
RG = "recurrentgemma-2b"
MB = "mamba2-780m"


def rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def t(a):
    return torch.from_numpy(np.array(a))


def block(name, spec_fn, seed=0):
    """(JAX cfg, port cfg, numpy params) of one block of the reduced
    config, drawn by the JAX package's init."""
    jcfg, tcfg = jreg.REDUCED[name], treg.REDUCED[name]
    jp = JL.init_params(jax.random.PRNGKey(seed), spec_fn(jcfg), jnp.float32)
    return jcfg, tcfg, {k: np.asarray(v) for k, v in jp.items()}


def inputs(cfg, s, seed):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


# -- specs and init ----------------------------------------------------------

def test_specs_match_jax():
    for name, jfn, tfn in ((RG, JR.rglru_spec, TR.rglru_spec),
                           (MB, JS.ssm_spec, TS.ssm_spec)):
        for reg in ("REDUCED", "ARCHS"):
            jcfg = getattr(jreg, reg)[name]
            tcfg = getattr(treg, reg)[name]
            want = jfn(jcfg)
            got = tfn(tcfg)
            assert list(got) == list(want)
            for k in want:
                w, g = want[k], got[k]
                assert (g.shape, g.axes, g.init, g.scale) == (
                    w.shape, w.axes, w.init, w.scale), (name, k)


def test_rglru_lambda_init():
    """logit(u), u uniform on (0.9, 0.999), drawn in float32: sigmoid of
    the draws lies in that range, spreads across it, and the bf16 draw is
    the float32 draw rounded."""
    spec = {"lam": TL.ParamSpec((4096,), ("rnn",), "rglru_lambda")}
    lam = TL.init_params(spec, torch.float32,
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")["lam"]
    a = torch.sigmoid(lam.double())
    assert lam.dtype == torch.float32
    assert 0.9 - 1e-6 <= a.min().item() and a.max().item() <= 0.999 + 1e-6
    assert a.min().item() < 0.905 and a.max().item() > 0.994
    assert abs(a.mean().item() - 0.9495) < 0.005
    lam16 = TL.init_params(spec, torch.bfloat16,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")["lam"]
    assert torch.equal(lam16, lam.to(torch.bfloat16))


# -- RG-LRU ------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 13, 33])
def test_linear_scan_matches_sequential(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (B, s, 24))
    b = rng.normal(size=(B, s, 24))
    h, want = np.zeros((B, 24)), []
    for i in range(s):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    got = TR.linear_scan(t(a.astype(np.float32)), t(b.astype(np.float32)))
    assert rel(got, np.stack(want, 1)) <= 1e-6


@pytest.mark.parametrize("s", [1, 13, 32])
def test_rglru_forward_matches_jax(s):
    jcfg, tcfg, p = block(RG, JR.rglru_spec)
    x = inputs(jcfg, s, 1)
    jy, jc = JR.rglru_forward(jcfg, p, x, make_cache=True)
    ty, tc = TR.rglru_forward(tcfg, {k: t(v) for k, v in p.items()}, t(x),
                              make_cache=True)
    assert rel(ty, jy) <= 1e-5
    assert tc["h"].dtype == torch.float32
    assert rel(tc["h"], jc["h"]) <= 1e-5
    assert rel(tc["conv"], jc["conv"]) <= 1e-5
    none, nc = TR.rglru_forward(tcfg, {k: t(v) for k, v in p.items()}, t(x))
    assert nc is None and torch.equal(none, ty)


@pytest.mark.parametrize("s", [1, 13, 32])
def test_rglru_decode_matches_jax(s):
    """Five decode steps from the prefill cache of s positions."""
    jcfg, tcfg, p = block(RG, JR.rglru_spec, seed=1)
    tp = {k: t(v) for k, v in p.items()}
    x = inputs(jcfg, s + 5, 2)
    _, jc = JR.rglru_forward(jcfg, p, x[:, :s], make_cache=True)
    _, tc = TR.rglru_forward(tcfg, tp, t(x[:, :s]), make_cache=True)
    for i in range(s, s + 5):
        jy, jc = JR.rglru_decode(jcfg, p, x[:, i:i + 1], jc)
        ty, tc = TR.rglru_decode(tcfg, tp, t(x[:, i:i + 1]), tc)
        assert rel(ty, jy) <= 1e-5, i
        assert rel(tc["h"], jc["h"]) <= 1e-5, i
        assert rel(tc["conv"], jc["conv"]) <= 1e-5, i


def test_rglru_decode_continues_forward():
    """The port's prefill-then-decode reproduces its own forward at the
    decoded positions (float32, within 1e-5)."""
    _, tcfg, p = block(RG, JR.rglru_spec, seed=2)
    tp = {k: t(v) for k, v in p.items()}
    x = t(inputs(tcfg, 12, 3))
    full, _ = TR.rglru_forward(tcfg, tp, x)
    _, cache = TR.rglru_forward(tcfg, tp, x[:, :7], make_cache=True)
    for i in range(7, 12):
        y, cache = TR.rglru_decode(tcfg, tp, x[:, i:i + 1], cache)
        assert rel(y, full[:, i:i + 1].numpy()) <= 1e-5, i


def test_causal_conv_with_state_matches_jax():
    """The conv over a sequence split in two, the second part taking the
    first's trailing state, equals the conv over the whole (and JAX's)."""
    jcfg, tcfg, p = block(RG, JR.rglru_spec, seed=3)
    tp = {k: t(v) for k, v in p.items()}
    xi = np.random.default_rng(4).normal(
        size=(B, 11, jcfg.rnn_width)).astype(np.float32)
    whole, st_whole = TR._causal_conv(tp, t(xi))
    a, st = TR._causal_conv(tp, t(xi[:, :6]))
    b, st2 = TR._causal_conv(tp, t(xi[:, 6:]), st)
    assert st.shape == (B, jcfg.conv_width - 1, jcfg.rnn_width)
    assert rel(torch.cat([a, b], 1), whole.numpy()) <= 1e-6
    assert torch.equal(st2, st_whole)
    jst = JR._causal_conv(p, xi[:, :6])[1]
    jb, jst2 = JR._causal_conv(p, xi[:, 6:], jst)
    assert rel(b, jb) <= 1e-5 and rel(st2, jst2) == 0.0


def test_gates_upcast_bf16_weights():
    """float32 xc against bf16 gate weights: jnp.einsum promotes, and so
    does the port (torch.einsum alone refuses mixed dtypes)."""
    jcfg, tcfg, p = block(RG, JR.rglru_spec, seed=4)
    p16 = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    xc = np.random.default_rng(5).normal(
        size=(B, 3, jcfg.rnn_width)).astype(np.float32)
    ja, jg = JR._gates(p16, xc)
    ta, tg = TR._gates({k: t(np.asarray(v, np.float32)).to(torch.bfloat16)
                        for k, v in p16.items()}, t(xc))
    assert str(ja.dtype) == "float32" and ta.dtype == torch.float32
    assert rel(ta, ja) <= 1e-5 and rel(tg, jg) <= 1e-5


def _bf16_control(jfn, tfn, jcfg, tcfg, p, xs):
    """(port bf16 vs JAX bf16, JAX bf16 vs JAX fp32) over the outputs of
    jfn / tfn on the same bf16 weights and inputs."""
    p16 = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    p32 = {k: v.astype(jnp.float32) for k, v in p16.items()}
    x16 = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    want16 = jfn(jcfg, p16, *x16)
    want32 = jfn(jcfg, p32, *[x.astype(jnp.float32) for x in x16])
    got = tfn(tcfg, {k: t(np.asarray(v, np.float32)).to(torch.bfloat16)
                     for k, v in p16.items()},
              *[t(np.asarray(x, np.float32)).to(torch.bfloat16)
                for x in x16])
    out = []
    for g, w16, w32 in zip(got, want16, want32, strict=True):
        assert str(w16.dtype) == str(g.dtype).split(".")[-1], (w16.dtype,
                                                               g.dtype)
        w16f = np.asarray(w16.astype(jnp.float32))
        out.append((rel(g.float(), w16f), rel(w16f, w32)))
    return out


def test_rglru_bf16_matches_jax_bf16():
    """bf16 prefill (output, cached h, conv state) then one decode step
    (output, h): each within the bf16 control; h stays float32."""
    jcfg, tcfg, p = block(RG, JR.rglru_spec, seed=5)
    x = inputs(jcfg, 13, 6)

    def run(mod):
        def fn(cfg, params, xa, xb):
            y, c = mod.rglru_forward(cfg, params, xa, make_cache=True)
            y2, c2 = mod.rglru_decode(cfg, params, xb, c)
            return y, c["h"], c["conv"], y2, c2["h"]
        return fn

    for err, control in _bf16_control(run(JR), run(TR), jcfg, tcfg, p,
                                      (x[:, :12], x[:, 12:])):
        assert err <= control, (err, control)


# -- Mamba-2 SSD -------------------------------------------------------------

def _ssd_inputs(cfg, s, seed):
    di, heads, n, hd = JS._dims(cfg)
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, s, heads, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, s, heads)))).astype(np.float32)
    a_log = rng.normal(size=heads).astype(np.float32)
    bm = rng.normal(size=(B, s, n)).astype(np.float32)
    cm = rng.normal(size=(B, s, n)).astype(np.float32)
    return xh, dt, a_log, bm, cm


@pytest.mark.parametrize("s,chunk", [(32, 8), (8, 8), (5, 8), (32, 32)])
def test_ssd_chunked_matches_jax(s, chunk):
    """chunk 8 at S 32 runs the inter-chunk recurrence over 4 chunks; S 8
    is one chunk, S 5 a chunk shorter than asked."""
    cfg = jreg.REDUCED[MB]
    args = _ssd_inputs(cfg, s, 7)
    jy, jh = JS.ssd_chunked(*args, chunk)
    ty, th = TS.ssd_chunked(*[t(a) for a in args], chunk)
    assert rel(ty, jy) <= 1e-5
    assert th.dtype == torch.float32 and rel(th, jh) <= 1e-5


def test_ssd_chunks_agree():
    """One chunk of 32 and four of 8 compute the same scan."""
    cfg = jreg.REDUCED[MB]
    args = [t(a) for a in _ssd_inputs(cfg, 32, 8)]
    y1, h1 = TS.ssd_chunked(*args, 32)
    y4, h4 = TS.ssd_chunked(*args, 8)
    assert rel(y4, y1.numpy()) <= 1e-5 and rel(h4, h1.numpy()) <= 1e-5


def test_ssd_refuses_a_partial_chunk():
    """S past the chunk and not a multiple of it: the reference asserts,
    the port raises ValueError (no padding)."""
    cfg = jreg.REDUCED[MB]
    args = _ssd_inputs(cfg, 12, 9)
    with pytest.raises(AssertionError):
        JS.ssd_chunked(*args, 8)
    with pytest.raises(ValueError, match="not a multiple of the chunk 8"):
        TS.ssd_chunked(*[t(a) for a in args], 8)
    _, tcfg, p = block(MB, JS.ssm_spec)
    with pytest.raises(ValueError, match="not a multiple"):
        TS.ssm_forward(tcfg, {k: t(v) for k, v in p.items()},
                       t(inputs(tcfg, 12, 0)), chunk=8)


@pytest.mark.parametrize("s,chunk", [(32, 8), (8, 8), (13, 256)])
def test_ssm_forward_matches_jax(s, chunk):
    jcfg, tcfg, p = block(MB, JS.ssm_spec)
    x = inputs(jcfg, s, 10)
    jy, jc = JS.ssm_forward(jcfg, p, x, make_cache=True, chunk=chunk)
    ty, tc = TS.ssm_forward(tcfg, {k: t(v) for k, v in p.items()}, t(x),
                            make_cache=True, chunk=chunk)
    assert rel(ty, jy) <= 1e-5
    for k in ("h", "conv_x", "conv_bc"):
        assert rel(tc[k], jc[k]) <= 1e-5, k


def test_ssm_decode_matches_jax():
    """Five decode steps from a 16-position prefill cache (two chunks of
    8), then the port's decode against its own forward."""
    jcfg, tcfg, p = block(MB, JS.ssm_spec, seed=1)
    tp = {k: t(v) for k, v in p.items()}
    x = inputs(jcfg, 21, 11)
    _, jc = JS.ssm_forward(jcfg, p, x[:, :16], make_cache=True, chunk=8)
    _, tc = TS.ssm_forward(tcfg, tp, t(x[:, :16]), make_cache=True, chunk=8)
    for i in range(16, 21):
        jy, jc = JS.ssm_decode(jcfg, p, x[:, i:i + 1], jc)
        ty, tc = TS.ssm_decode(tcfg, tp, t(x[:, i:i + 1]), tc)
        assert rel(ty, jy) <= 1e-5, i
        for k in ("h", "conv_x", "conv_bc"):
            assert rel(tc[k], jc[k]) <= 1e-5, (i, k)
    full, _ = TS.ssm_forward(tcfg, tp, t(x[:, :16]), chunk=8)
    _, c = TS.ssm_forward(tcfg, tp, t(x[:, :8]), make_cache=True, chunk=8)
    for i in range(8, 16):
        y, c = TS.ssm_decode(tcfg, tp, t(x[:, i:i + 1]), c)
        assert rel(y, full[:, i:i + 1].numpy()) <= 1e-5, i


def test_ssm_init_cache_matches_jax():
    jcfg, tcfg = jreg.REDUCED[MB], treg.REDUCED[MB]
    want = JS.ssm_init_cache(jcfg, 3, jnp.bfloat16)
    got = TS.ssm_init_cache(tcfg, 3, torch.bfloat16, device="cpu")
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()
    want = JR.rglru_init_cache(jreg.REDUCED[RG], 3, jnp.bfloat16)
    got = TR.rglru_init_cache(treg.REDUCED[RG], 3, torch.bfloat16,
                              device="cpu")
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_ssm_bf16_matches_jax_bf16():
    """bf16 prefill (output, h, conv states) over two chunks, then one
    decode step: each within the bf16 control."""
    jcfg, tcfg, p = block(MB, JS.ssm_spec, seed=2)
    x = inputs(jcfg, 17, 12)

    def run(mod):
        def fn(cfg, params, xa, xb):
            y, c = mod.ssm_forward(cfg, params, xa, make_cache=True,
                                   chunk=8)
            y2, c2 = mod.ssm_decode(cfg, params, xb, c)
            return y, c["h"], c["conv_x"], c["conv_bc"], y2, c2["h"]
        return fn

    for err, control in _bf16_control(run(JS), run(TS), jcfg, tcfg, p,
                                      (x[:, :16], x[:, 16:])):
        assert err <= control, (err, control)


def test_ssd_intermediates_stay_small(monkeypatch):
    """At mamba2-780m's width (48 heads x 64, N 128; B 8, S 128, one
    chunk) no operand or result of ``ssd_chunked``'s four einsums exceeds
    (B, c, l, l, P) float32, 25.2 MB; the left-to-right pairing of the
    reference's y_intra einsum would materialise (B, c, l, l, P, H), 1.6
    GB.
    Checked on the meta device, so nothing is allocated."""
    cfg = dataclasses.replace(treg.ARCHS[MB])
    di, heads, n, hd = TS._dims(cfg)
    b, s = 8, 128
    largest = []
    real = torch.einsum

    def watching(eq, *ops):
        out = real(eq, *ops)
        largest.append(max([out.numel()] + [o.numel() for o in ops]))
        return out

    monkeypatch.setattr(torch, "einsum", watching)
    meta = dict(device="meta", dtype=torch.float32)
    y, h = TS.ssd_chunked(torch.empty(b, s, heads, hd, **meta),
                          torch.empty(b, s, heads, **meta),
                          torch.empty(heads, **meta),
                          torch.empty(b, s, n, **meta),
                          torch.empty(b, s, n, **meta), 256)
    assert y.shape == (b, s, heads, hd) and h.shape == (b, heads, n, hd)
    cap = b * s * s * heads
    assert len(largest) == 4 and max(largest) <= cap
    assert cap * 4 < 26e6 and cap * hd * 4 > 1.6e9


def test_rglru_gate_conditioning_at_model_activations():
    """At the activations of the reduced recurrentgemma-2b under the
    reference init (stacked weights drawn at fan_in n_rep, so the gate
    pre-activations reach thousands and r_t saturates), a_t lies within a
    float32 ulp of 1 in places, where sqrt(1 - a^2) keeps no relative
    precision.  There the JAX package and the port, each in float32, lie
    about as far from a float64 evaluation of the same gates (~1.6e-4,
    past the 1e-5 block tolerance), which is why the whole-model outputs
    of that arch are held to the reference's own one-ulp sensitivity in
    test_torch_models.py: the port is no farther from float64 than the
    reference is (within 1.5x)."""
    from repro.models import transformer as JT
    jcfg = jreg.REDUCED[RG]
    jp = JL.init_params(jax.random.PRNGKey(6), JT.model_spec(jcfg),
                        jnp.float32)
    bp = jax.tree.map(lambda a: np.asarray(a[0]), jp["body"]["b0"])
    tok = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, 16))
    h_in = np.asarray(JL.apply_norm(jcfg, bp["ln1"],
                                    np.asarray(jp["embed"])[tok]))
    p = bp["rec"]
    xc = np.asarray(JR._causal_conv(p, h_in @ p["w_in"])[0])
    ja, jg = (np.asarray(v) for v in JR._gates(p, xc))
    ta, tg = (v.numpy() for v in TR._gates({k: t(v) for k, v in p.items()},
                                           t(xc)))

    def f64_gates():
        x = xc.astype(np.float64)

        def bdm(w):
            g, rb, _ = w.shape
            return np.einsum("...gi,gij->...gj",
                             x.reshape(x.shape[:-1] + (g, rb)),
                             w.astype(np.float64)).reshape(x.shape)

        def sig(v):
            return 1 / (1 + np.exp(-v))

        r = sig(bdm(p["w_a"]) + p["b_a"])
        i = sig(bdm(p["w_x"]) + p["b_x"])
        a = np.exp(8.0 * r * np.log(sig(p["lam"].astype(np.float64))))
        return a, np.sqrt(np.maximum(1 - a * a, 1e-12)) * i * x

    a64, g64 = f64_gates()
    jax_err = np.abs(jg - g64).max() / np.abs(g64).max()
    port_err = np.abs(tg - g64).max() / np.abs(g64).max()
    assert jax_err > 1e-5
    assert port_err <= 1.5 * jax_err
    assert np.abs(ja - a64).max() <= 2 ** -22
    assert np.abs(ta - a64).max() <= 2 ** -22
    assert ((a64 < 1) & (a64 > 1 - 2 ** -24)).any()
