"""The port's training path on the CPU against the JAX package's: the
losses (``softmax_xent``, ``chunked_xent``, ``lm_loss``), the gradient of
every leaf for all ten reduced archs, remat, microbatches, the whole
train step, the token stream and the loader, and ``launch.train``.

Inputs come from a numpy seed; JAX weights carry across through
``repro_torch.interop.params_from_numpy``, gradients come back through
``Transformer.grad_tree`` in the JAX tree layout.  Tolerances (relative:
max|port - jax| / max|jax| per array):
- the losses: 1e-5 (measured <= 3e-7);
- each gradient leaf: the larger of 1e-3 and twice how far JAX's own
  gradient moves when every parameter moves by one float32 rounding
  (x (1 +- 2^-23), signs from three seeds, the largest move): float32
  reduction order differs between torch and XLA in every matmul of
  forward and backward, and the reference's init drives activations into
  the thousands, so each side lies about one such move from the exact
  gradient.  deepseek-moe-16b's moves reach 1.0e-3 and the port differs
  by up to 1.1e-3 there (JAX compiled against JAX op by op: 8.0e-4);
  most leaves of the other archs lie below 1e-4.  With
  RG-LRU blocks (recurrentgemma-2b) also how far it moves when every a_t
  moves one float32 ulp toward 0 (``gates_one_ulp_down``): sqrt(1 - a^2)
  and its derivative keep no relative precision where a lies within an
  ulp of 1, and the gradients there move up to ~0.11 (the port's
  differ from JAX's by up to ~0.024);
- remat against none: bit for bit on the CPU (the recomputation is the
  same arithmetic); two microbatches against one: 1e-5 on the loss and
  the gradient norm;
- a whole train step against JAX's: the loss within 1e-5 and the
  gradient norm within 1e-4 (the gradients' conditioning above; measured
  1.6e-5, deepseek-v3-671b); not the parameters (Adam's first update is
  about sign(g) * lr, so a gradient near 0 that rounds apart flips a
  parameter by 2 lr).  So each step starts from the reference's
  parameters and state: after such flips deepseek-v3's next gradient
  norm moves by 7.5e-4.
"""
import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.data.tokens import SyntheticTokenStream as JStream  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.manager import _leaf_paths  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.data.tokens import SyntheticTokenStream  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

B, S = 2, 16
ALL = sorted(jreg.ARCHS)


def rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@contextlib.contextmanager
def gates_one_ulp_down():
    """JAX's RG-LRU gates with every a_t one float32 ulp nearer 0."""
    def nudged(p, xc):
        r_t = jax.nn.sigmoid(JR._block_diag_matmul(xc, p["w_a"]) + p["b_a"])
        i_t = jax.nn.sigmoid(JR._block_diag_matmul(xc, p["w_x"]) + p["b_x"])
        log_a = JR._C * r_t * jax.nn.log_sigmoid(
            p["lam"].astype(jnp.float32))
        a = jnp.exp(log_a)
        # one ulp down, the gradient passed through as identity
        a0 = jax.lax.stop_gradient(a)
        a = a - (a0 - jnp.nextafter(a0, jnp.float32(0)))
        gated = jnp.sqrt(jnp.maximum(1.0 - a * a, 1e-12)) * (i_t * xc)
        return a, gated

    real = JR._gates
    JR._gates = nudged
    try:
        yield
    finally:
        JR._gates = real


def batch_np(cfg, seed, b=B, s=S):
    """A seeded numpy batch: tokens or embeddings (with M-RoPE streams
    that differ), labels with a few ignored (-1)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
               .astype(np.int32)}
    else:
        out = {"embeds": rng.normal(size=(b, s, cfg.d_model))
               .astype(np.float32)}
        if cfg.m_rope_sections:
            pos = np.stack([np.zeros(s), np.arange(s) // 4, np.arange(s) % 4])
            out["mrope_positions"] = np.broadcast_to(
                pos[:, None, :], (3, b, s)).astype(np.int32).copy()
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out["labels"][0, 3] = -1
    out["labels"][-1, -2] = -1
    return out


def as_torch(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype.kind in "iu"
                else torch.from_numpy(v)) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_model(name, jp):
    tm = interop.params_from_numpy(treg.REDUCED[name],
                                   jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return tm.requires_grad_(True)


# -- losses ------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_xent_matches_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 5, 40)) * 4).astype(np.float32)
    labels = rng.integers(-1, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.2).astype(np.int32)
    for m in (None, mask):
        jl, jg = jax.value_and_grad(lambda x: JL.softmax_xent(
            x, labels, None if m is None else jnp.asarray(m),
            z_loss=z_loss))(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        tl = TL.softmax_xent(x, torch.from_numpy(labels).long(),
                             None if m is None else torch.from_numpy(m),
                             z_loss=z_loss)
        tl.backward()
        assert rel(tl, jl) <= 1e-6
        assert rel(x.grad, jg) <= 1e-5
    # every label ignored: loss 0 (the denominator is at least 1)
    none = TL.softmax_xent(torch.from_numpy(logits),
                           torch.full((3, 5), -1, dtype=torch.long))
    assert float(none) == 0.0


@pytest.mark.parametrize("chunk", [4, 8, 16, 5])
def test_chunked_xent_matches_jax(chunk):
    """Chunks that divide S (several, with recomputation in backward),
    one that does not (the whole sequence), ignored labels: the loss and
    the gradients of x and of the unembedding against JAX's."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 12)).astype(np.float32)
    w = rng.normal(size=(12, 30)).astype(np.float32)
    labels = rng.integers(-1, 30, (2, 16)).astype(np.int32)
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: JL.chunked_xent(a, labels, lambda h: h @ b,
                                     chunk=chunk), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = TL.chunked_xent(tx, torch.from_numpy(labels).long(),
                         lambda h: h @ tw, chunk=chunk)
    tl.backward()
    assert rel(tl, jl) <= 1e-6
    assert rel(tx.grad, jgx) <= 1e-5 and rel(tw.grad, jgw) <= 1e-5
    whole = TL.softmax_xent(torch.from_numpy(x) @ torch.from_numpy(w),
                            torch.from_numpy(labels).long())
    assert rel(tl, whole.detach().numpy()) <= 1e-6


@pytest.mark.parametrize("name", ALL)
def test_lm_loss_and_grads_match_jax(name):
    """``lm_loss`` (chunk 8: two chunks of S 16) and the gradient of every
    leaf against ``jax.value_and_grad``, in the JAX tree layout, every
    JAX leaf matched by name (deepseek-v3's MTP head included); each
    leaf's tolerance from JAX's own moves (module docstring)."""
    cfg = jreg.REDUCED[name]
    jp = JL.init_params(jax.random.PRNGKey(ALL.index(name)),
                        JT.model_spec(cfg), jnp.float32)
    batch = batch_np(cfg, 40 + ALL.index(name))

    def grad_fn():
        # a new jit each time: gates_one_ulp_down acts when it traces
        return jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(
            cfg, p, as_jax(batch), loss_chunk=8)))

    fn = grad_fn()
    jl, jg = fn(jp)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    moves = [0.0] * len(flat)
    for seed in range(3):
        signs = np.random.default_rng(seed)
        nudged = jax.tree.map(lambda a: a * (1 + np.float32(2**-23) * (
            signs.choice([-1, 1], a.shape).astype(np.float32))), jp)
        moves = [max(m, 2 * rel(b, a)) for m, (_, a), b in
                 zip(moves, flat, jax.tree.leaves(fn(nudged)[1]))]
    if "rec" in cfg.block_pattern:
        with gates_one_ulp_down():
            _, moved = grad_fn()(jp)
        moves = [max(m, rel(b, a)) for m, (_, a), b in
                 zip(moves, flat, jax.tree.leaves(moved))]
    tm = port_model(name, jp)
    params = list(tm.parameters())
    tl = TT.lm_loss(tm.cfg, tm, as_torch(batch), loss_chunk=8)
    # a leaf the loss never reads (the embedding table of an embeddings-
    # input arch with an untied unembedding) has JAX's zero gradient
    gs = torch.autograd.grad(tl, params, allow_unused=True,
                             materialize_grads=True)
    got = dict(_leaf_paths(tm.grad_tree({id(p): g for p, g in
                                         zip(params, gs)})))
    assert rel(tl, jl) <= 1e-5
    assert len(got) == len(flat)
    if cfg.mtp:
        assert any(k.startswith("mtp_") for k in got)
    for (path, want), moved in zip(flat, moves):
        key = "_".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        tol = max(1e-3, moved)
        assert rel(got[key], want) <= tol, (key, rel(got[key], want), tol)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "recurrentgemma-2b",
                                  "qwen2-vl-7b"])
def test_remat_matches_no_remat(name):
    """forward(remat=True) recomputes each body unit in backward: the same
    loss and gradients, bit for bit on the CPU."""
    cfg = jreg.REDUCED[name]
    jp = JL.init_params(jax.random.PRNGKey(1), JT.model_spec(cfg),
                        jnp.float32)
    tm = port_model(name, jp)
    batch = as_torch(batch_np(cfg, 5))
    out = {}
    for remat in (False, True):
        loss, grads = TS.make_grad_fn(tm.cfg, remat=remat)(tm, batch)
        out[remat] = (loss, TO.tree_leaves(grads))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "qwen2-vl-7b",
                                  "deepseek-v3-671b"])
def test_train_step_matches_jax(name):
    """Two whole train steps (AdamW, two microbatches: the M-RoPE streams
    split on their batch axis) against the reference's ``make_train_step``
    under ``jax.jit``, each from the reference's state: the loss and the
    gradient norm of each step; and the port's two microbatches against
    one on the same batch."""
    cfg = jreg.REDUCED[name]
    jp = JL.init_params(jax.random.PRNGKey(2), JT.model_spec(cfg),
                        jnp.float32)
    tm = port_model(name, jp)
    jcfg = JO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tcfg = TO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(JS.make_train_step(cfg, jcfg, num_microbatches=2,
                                       remat=False))
    tstep = TS.make_train_step(tm.cfg, tcfg, num_microbatches=2, remat=True)
    js = JO.init_opt_state(jp, jcfg)
    ts = TO.init_opt_state(tm.tree(), tcfg)
    batches = [batch_np(cfg, 60 + i, b=4) for i in range(2)]
    for b in batches:
        jp, js, jm = jstep(jp, js, as_jax(b))
        _, ts, tmet = tstep(tm, ts, as_torch(b))
        assert rel(tmet["loss"], jm["loss"]) <= 1e-5
        assert rel(tmet["grad_norm"], jm["grad_norm"]) <= 1e-4
        # the next step from the reference's state (module docstring)
        with torch.no_grad():
            for a, w in zip(TO.tree_leaves(tm.tree()), jax.tree.leaves(jp)):
                a.copy_(torch.from_numpy(np.array(w)))
        ts = interop.opt_state_from_numpy(jax.tree.map(np.asarray, js),
                                          device="cpu")
    one = TS.make_grad_fn(tm.cfg, remat=False)(tm, as_torch(batches[0]))
    two = TS.make_grad_fn(tm.cfg, num_microbatches=2, remat=False)(
        tm, as_torch(batches[0]))
    assert rel(two[0], one[0].numpy()) <= 1e-5
    assert rel(TO.global_norm(two[1]), TO.global_norm(one[1]).numpy()) \
        <= 1e-5


def test_split_microbatches_cuts_mrope_on_the_batch_axis():
    cfg = jreg.REDUCED["qwen2-vl-7b"]
    b = as_torch(batch_np(cfg, 3, b=4))
    parts = TS.split_microbatches(b, 2)
    assert [p["mrope_positions"].shape for p in parts] == [(3, 2, S)] * 2
    assert torch.equal(parts[1]["embeds"], b["embeds"][2:])
    assert torch.equal(parts[1]["mrope_positions"],
                       b["mrope_positions"][:, 2:])
    with pytest.raises(ValueError, match="does not split"):
        TS.split_microbatches(b, 3)


def test_model_tree_is_the_jax_layout_and_shares_storage():
    """``Transformer.tree()`` is the JAX tree (``params_to_numpy`` gives it
    back exactly); its body leaves are the stacked tensors the blocks
    view, so an in-place update reaches every block; serving models hold
    no autograd state, trainable ones require grad everywhere."""
    name = "recurrentgemma-2b"
    cfg = jreg.REDUCED[name]
    jp = JL.init_params(jax.random.PRNGKey(3), JT.model_spec(cfg),
                        jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    serving = interop.params_from_numpy(treg.REDUCED[name], tree,
                                        device="cpu")
    assert not any(p.requires_grad for p in serving.parameters())
    out, _, _ = TT.forward(serving.cfg, serving, {"tokens": torch.zeros(
        1, 4, dtype=torch.long)})
    assert out.grad_fn is None
    back = interop.params_to_numpy(serving.cfg, serving)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    tm = TT.Transformer(serving.cfg, serving.tree(), trainable=True)
    assert all(p.requires_grad for p in tm.parameters())
    w = tm.tree()["body"]["b0"]["rec"]["w_x"]
    with torch.no_grad():
        w[1].add_(1.0)
    n_pre, n_unit, _, _ = tm.segments
    assert torch.equal(tm.blocks[n_pre + n_unit].rec.w_x, w[1])
    assert tm.blocks[n_pre + n_unit].rec.w_x.data_ptr() == w[1].data_ptr()
    with pytest.raises(ValueError, match="does not match"):
        interop.params_to_numpy(treg.REDUCED["qwen3-1.7b"], tm)


# -- data --------------------------------------------------------------------

def test_token_stream_copy_matches_original():
    for seed in (0, 5):
        a, b = JStream(300, seed=seed), SyntheticTokenStream(300, seed=seed)
        np.testing.assert_array_equal(a.unigram, b.unigram)
        np.testing.assert_array_equal(a.succ, b.succ)
        for _ in range(3):
            np.testing.assert_array_equal(a.batch(4, 9), b.batch(4, 9))


def test_loader_delivers_the_streams_batches_in_order():
    """Every batch the stream draws, in order (the prefetch queue full or
    not), on the loader's device; labels equal tokens."""
    loader = ShardedLoader(SyntheticTokenStream(100, seed=1), 3, 7,
                           device="cpu", prefetch=1)
    ref = SyntheticTokenStream(100, seed=1)
    try:
        for _ in range(5):
            b = next(loader)
            want = ref.batch(3, 7)
            assert b["tokens"].dtype == torch.int64
            assert b["tokens"].device.type == "cpu"
            np.testing.assert_array_equal(b["tokens"].numpy(), want)
            assert torch.equal(b["labels"], b["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_launch_train_main(tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu``: the
    reference's flags and report line; --resume restores the last
    checkpoint; the stub-front-end archs are refused for training."""
    args = ["--reduced", "--device", "cpu", "--steps", "10", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path)]
    tr = launch_train.main(args)
    out = capsys.readouterr().out
    assert re.search(r"\[train\] qwen3-1.7b: loss \d+\.\d{3} -> \d+\.\d{3} "
                     r"over 10 steps; stragglers=\d+", out), out
    assert tr.ckpt.latest_step() == 10
    launch_train.main(args + ["--resume"])
    out = capsys.readouterr().out
    assert "[train] restored step 10" in out
    for arch in ("qwen2-vl-7b", "musicgen-large"):
        with pytest.raises(SystemExit, match="stub frontend"):
            launch_train.main(["--arch", arch, "--reduced", "--device",
                               "cpu"])


def test_launch_train_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        launch_train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ShardedLoader(SyntheticTokenStream(10), 1, 2)


def test_int8_training_falls(tmp_path):
    """int8 moments through the whole step: 12 steps of the reduced model
    stay finite and the loss falls."""
    cfg = treg.REDUCED["qwen3-1.7b"]
    tree = TL.init_params(TT.model_spec(cfg), torch.float32,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    tm = TT.Transformer(cfg, tree, trainable=True)
    ocfg = TO.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12,
                          moment_dtype="int8")
    st = TO.init_opt_state(tm.tree(), ocfg)
    step = TS.make_train_step(cfg, ocfg, remat=False)
    stream = SyntheticTokenStream(cfg.vocab_size, seed=0)
    losses = []
    for _ in range(12):
        tok = torch.from_numpy(stream.batch(4, 32)).long()
        _, st, m = step(tm, st, {"tokens": tok, "labels": tok})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(q.dtype == torch.int8 for q in TO.tree_leaves(st["m"])[::2])
