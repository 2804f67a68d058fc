"""The port's checkpoint manager and trainer (``repro_torch.checkpoint``,
``repro_torch.train.trainer``) against the JAX package's on the CPU: the
mirrors of ``tests/test_optim_ckpt.py``'s checkpoint and straggler tests,
the on-disk format byte for byte, and a checkpoint carried across in both
directions, each side then training 3 more steps to the same losses.

Tolerances: the restored leaves bit for bit; the losses of the 3 steps
after a restore within 1e-5 relative (the two packages' forward and
backward round apart by float32 reduction order; the same gradients
would give the same update, but each side uses its own).  The JAX
package cannot restore its own bfloat16 moments (``np.load`` gives a
``|V2`` array that ``astype(bfloat16)`` refuses), so bf16 files are held
byte for byte and read by the port only.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JCM  # noqa: E402
from repro.configs.registry import REDUCED as JREDUCED  # noqa: E402
from repro.models.layers import init_params as jinit  # noqa: E402
from repro.models.transformer import model_spec as jspec  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.train.step import make_train_step as jstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: E402
                                            _leaf_paths)
from repro_torch.configs.registry import REDUCED  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.train.trainer import (StragglerMonitor,  # noqa: E402
                                       Trainer, TrainerConfig)

ARCH = "qwen3-1.7b"


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10.0), "b": [torch.ones((2, 3)),
                                           torch.zeros(4, dtype=torch.int32)]}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(5, tree, blocking=True)
    assert mgr.latest_step() == 5
    like = {"a": torch.zeros(10), "b": [torch.zeros((2, 3)),
                                        torch.ones(4, dtype=torch.int32)]}
    out = mgr.restore(5, like)
    assert out is like
    for a, b in zip(TO.tree_leaves(tree), TO.tree_leaves(out)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(5, {"a": torch.zeros(9), "b": like["b"]})


def test_checkpoint_retention_and_atomicity(tmp_path):
    tree = {"x": torch.ones(3)}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_3", "step_4"]
    # a stale tmp dir is cleaned on startup
    os.makedirs(tmp_path / ".tmp_step_9_123")
    CheckpointManager(str(tmp_path), keep=2)
    assert not (tmp_path / ".tmp_step_9_123").exists()
    # an async write: saved once wait() returns
    mgr2 = CheckpointManager(str(tmp_path), keep=2)
    mgr2.save(7, tree)
    mgr2.wait()
    assert mgr2.latest_step() == 7


def test_async_save_snapshots_before_returning(tmp_path):
    """The tree may change in place the moment save() returns (the
    trainer's next step): the checkpoint holds the values at the call,
    host tensors included (the optimizer's step counter lives there)."""
    tree = {"w": torch.ones(1 << 16), "step": torch.tensor(20,
                                                         dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(20, tree)
    tree["w"].add_(1.0)
    tree["step"].fill_(21)
    mgr.wait()
    like = {"w": torch.zeros(1 << 16), "step": torch.tensor(0,
                                                         dtype=torch.int32)}
    mgr.restore(20, like)
    assert int(like["step"]) == 20 and bool((like["w"] == 1.0).all())


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(z=3.0, ema=0.9)
    for _ in range(50):
        mon.observe(0.10 + np.random.default_rng(0).normal() * 0.0)
    assert not mon.observe(0.101)
    assert mon.observe(1.0)          # 10x step time => flagged
    assert mon.flagged == 1


def _states(moment_dtype):
    """The same parameters and a one-step optimizer state in both
    packages (the port's from the JAX one, carried as numpy)."""
    cfg = JREDUCED[ARCH]
    jp = jinit(jax.random.PRNGKey(0), jspec(cfg), jnp.float32)
    ocfg = JO.AdamWConfig(moment_dtype=moment_dtype)
    g = jax.tree.map(lambda a: 0.01 * jnp.cos(a * 7), jp)
    jp, js, _ = JO.apply_updates(jp, g, JO.init_opt_state(jp, ocfg), ocfg)
    model = interop.params_from_numpy(REDUCED[ARCH],
                                      jax.tree.map(np.asarray, jp),
                                      device="cpu")
    ts = interop.opt_state_from_numpy(jax.tree.map(np.asarray, js),
                                      device="cpu")
    return jp, js, model, ts


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_files_are_the_references_byte_for_byte(tmp_path, moment_dtype):
    """Both managers save the same state: the same file names, every .npy
    identical byte for byte (bfloat16 moments too), meta.json equal but
    its time; the port restores the JAX files exactly."""
    jp, js, model, ts = _states(moment_dtype)
    JCM(str(tmp_path / "jax"), async_save=False).save(
        1, {"params": jp, "opt": js}, blocking=True)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        1, {"params": model.tree(), "opt": ts}, blocking=True)
    jd, td = tmp_path / "jax" / "step_1", tmp_path / "port" / "step_1"
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    for n in names:
        if n == "meta.json":
            jm, tm = (json.loads((d / n).read_text()) for d in (jd, td))
            jm.pop("time"), tm.pop("time")
            assert jm == tm
        else:
            assert (jd / n).read_bytes() == (td / n).read_bytes(), n
    ocfg = TO.AdamWConfig(moment_dtype=moment_dtype)
    like = {"params": model.tree(lambda p: torch.zeros_like(p)),
            "opt": TO.init_opt_state(model.tree(), ocfg)}
    CheckpointManager(str(tmp_path / "jax")).restore(1, like)
    for (n, got), (_, want) in zip(_leaf_paths(like),
                                   _leaf_paths({"params": model.tree(),
                                                "opt": ts}), strict=True):
        assert torch.equal(got, want), n


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_opt_state_round_trips_through_numpy(moment_dtype):
    """``interop.opt_state_to_numpy`` gives the reference's tree back
    (structure, dtypes and values; bf16 as its bytes): JAX -> port ->
    numpy equals JAX's own arrays."""
    _, js, _, ts = _states(moment_dtype)
    back = interop.opt_state_to_numpy(ts)
    want = jax.tree.map(np.asarray, js)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        assert a.tobytes() == b.tobytes()


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, 512, (2, 16)).astype(np.int32)
        out.append({"tokens": tok, "labels": tok.copy()})
    return out


def _port_losses(model, ts, ocfg, batches):
    step = make_train_step(REDUCED[ARCH], ocfg, remat=False)
    out = []
    for b in batches:
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        _, ts, m = step(model, ts, tb)
        out.append(float(m["loss"]))
    return out


def _jax_losses(jp, js, ocfg, batches):
    step = jax.jit(jstep(JREDUCED[ARCH], ocfg, remat=False))
    out = []
    for b in batches:
        jp, js, m = step(jp, js, jax.tree.map(jnp.asarray, b))
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_carries_across_and_trains_on(tmp_path, writer):
    """A checkpoint written by one package restores into the other
    (float32 moments, then int8's leaves exactly); from it both train 3
    more steps on the same batches to the same losses."""
    jp, js, model, ts = _states("float32")
    ocfg = JO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    tcfg = TO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    if writer == "jax":
        JCM(str(tmp_path), async_save=False).save(
            1, {"params": jp, "opt": js}, blocking=True)
        zeros = interop.params_from_numpy(
            REDUCED[ARCH], jax.tree.map(lambda a: np.zeros(a.shape,
                                                           np.float32), jp),
            device="cpu")
        zeros.requires_grad_(True)
        state = TO.init_opt_state(zeros.tree(), tcfg)
        CheckpointManager(str(tmp_path)).restore(
            1, {"params": zeros.tree(), "opt": state})
        assert int(state["step"]) == 1
        port_model, port_state = zeros, state
        jax_p, jax_s = jp, js
    else:
        CheckpointManager(str(tmp_path), async_save=False).save(
            1, {"params": model.tree(), "opt": ts}, blocking=True)
        like = {"params": jax.tree.map(jnp.zeros_like, jp),
                "opt": JO.init_opt_state(jp, ocfg)}
        out = JCM(str(tmp_path)).restore(1, like)
        for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(
                {"params": jp, "opt": js})):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        jax_p, jax_s = out["params"], out["opt"]
        model.requires_grad_(True)
        port_model, port_state = model, ts
    batches = _batches(3)
    want = _jax_losses(jax_p, jax_s, ocfg, batches)
    got = _port_losses(port_model, port_state, tcfg, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_int8_state_carries_both_ways(tmp_path):
    """int8 moments ((codes, scales) leaves): JAX -> port -> JAX, exact."""
    jp, js, model, ts = _states("int8")
    CheckpointManager(str(tmp_path), async_save=False).save(
        1, {"params": model.tree(), "opt": ts}, blocking=True)
    out = JCM(str(tmp_path)).restore(
        1, {"params": jp, "opt": JO.init_opt_state(
            jp, JO.AdamWConfig(moment_dtype="int8"))})
    for a, b in zip(jax.tree.leaves(out["opt"]), jax.tree.leaves(js)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_trainer_saves_on_sigterm_and_restores(tmp_path):
    """A preempted trainer writes its step and exits; a fresh one restores
    it into its model and state in place and resumes from that step."""
    cfg = REDUCED[ARCH]
    jp, _, model, _ = _states("float32")
    model.requires_grad_(True)
    tcfg = TO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(cfg, tcfg, remat=False)
    batches = iter([{k: torch.from_numpy(v).long() for k, v in b.items()}
                    for b in _batches(6)])
    log = tmp_path / "log.jsonl"
    tr = Trainer(step, model, TO.init_opt_state(model.tree(), tcfg), batches,
                 TrainerConfig(total_steps=6, ckpt_every=100, log_every=1,
                               log_path=str(log), ckpt_dir=str(tmp_path)))
    tr.run(2)
    tr._on_preempt()
    with pytest.raises(SystemExit, match="preempted at step 3"):
        tr.run(3)
    assert tr.ckpt.latest_step() == 3
    assert [json.loads(x)["step"] for x in log.read_text().splitlines()] \
        == [1, 2, 3]
    fresh = interop.params_from_numpy(
        cfg, jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jp),
        device="cpu")
    fresh.requires_grad_(True)
    tr2 = Trainer(step, fresh, TO.init_opt_state(fresh.tree(), tcfg),
                  batches, TrainerConfig(ckpt_every=100,
                                         ckpt_dir=str(tmp_path)))
    assert tr2.maybe_restore() and tr2.step == 3
    for a, b in zip(TO.tree_leaves(fresh.tree()),
                    TO.tree_leaves(model.tree())):
        assert torch.equal(a, b)
    assert int(tr2.opt_state["step"]) == 3
    hist = tr2.run(3)
    assert [h["step"] for h in hist] == [4, 5, 6]
    assert tr2.ckpt.latest_step() == 6
