"""The port's serving engine (``repro_torch.serve.engine``) and launcher
(``repro_torch.launch.serve``) against the JAX package's on the CPU, in
float32, with the JAX weights carried across
(``repro_torch.interop.params_from_numpy``).

Greedy tokens must be identical to the JAX ``Engine``'s, with one
exception: at the first step where they differ, the JAX logits' top-2 gap
must be below 1e-4 x max|logit| (a near tie that float32 reduction order
may break either way); the rows are compared up to that step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import REDUCED as JREDUCED  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import model_spec as jspec  # noqa: E402
from repro.models.transformer import decode_step as jdecode  # noqa: E402
from repro.models.transformer import forward as jforward  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.registry import REDUCED  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import (Transformer, init_params,  # noqa: E402
                                model_spec)
from repro_torch.serve.engine import (Engine, make_prefill_step,  # noqa: E402
                                      make_serve_step)

DENSE = ("qwen3-1.7b", "qwen2.5-3b", "minitron-8b")
# MLA (minicpm3-4b, deepseek-v3-671b) and the recurrent archs: with
# PROMPT + GEN = 18 the reduced recurrentgemma-2b's window of 16 wraps its
# attention layers' ring during decode
NEW = ("minicpm3-4b", "deepseek-v3-671b", "recurrentgemma-2b", "mamba2-780m")
LM = DENSE + ("deepseek-moe-16b",) + NEW
BATCH, PROMPT, GEN = 3, 8, 10


def _jax_logits_along(cfg, params, prompts, out, steps):
    """The JAX logits that chose each greedy token of ``out``."""
    s0 = prompts.shape[1]
    lg, caches, _ = jforward(cfg, params, {"tokens": jnp.asarray(prompts)},
                             mode="prefill", cache_len=s0 + steps)
    logits = [np.asarray(lg[:, -1])]
    for i in range(steps - 1):
        lg, caches = jdecode(cfg, params, jnp.asarray(out[:, i]), caches,
                             s0 + i)
        logits.append(np.asarray(lg))
    return np.stack(logits, axis=1)                     # (B, steps, V)


@pytest.mark.parametrize("name", LM)
def test_greedy_tokens_match_jax_engine(name):
    cfg = JREDUCED[name]
    jp = jinit(jax.random.PRNGKey(3), jspec(cfg), jnp.float32)
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    want = np.asarray(JEngine(cfg, jp, max_len=PROMPT + GEN).generate(
        jnp.asarray(prompts), GEN))
    model = interop.params_from_numpy(REDUCED[name],
                                      jax.tree.map(np.asarray, jp),
                                      device="cpu")
    engine = Engine(REDUCED[name], model, max_len=PROMPT + GEN,
                    device="cpu")
    got = engine.generate(torch.from_numpy(prompts), GEN).numpy()
    assert got.shape == want.shape == (BATCH, GEN)
    if (got == want).all():
        return
    logits = _jax_logits_along(cfg, jp, prompts, want, GEN)
    for row in range(BATCH):
        diff = np.flatnonzero(got[row] != want[row])
        if diff.size == 0:
            continue
        step = diff[0]
        top2 = np.sort(logits[row, step])[-2:]
        assert top2[1] - top2[0] < 1e-4 * np.abs(logits[row, step]).max(), (
            row, step)


def _reduced_model(name, seed=0, dtype=torch.float32):
    cfg = REDUCED[name]
    tree = init_params(model_spec(cfg), dtype,
                       generator=torch.Generator().manual_seed(seed),
                       device="cpu")
    return cfg, Transformer(cfg, tree)


def test_sampling_step_draws_from_its_generator():
    cfg, model = _reduced_model("qwen3-1.7b")
    prompts = torch.randint(0, cfg.vocab_size, (4, 6),
                            generator=torch.Generator().manual_seed(1))
    prefill = make_prefill_step(cfg, 12)
    step = make_serve_step(cfg, sample=True)
    greedy = make_serve_step(cfg)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        last, caches = prefill(model, {"tokens": prompts})
        nxt = torch.argmax(last, dim=-1)
        out = []
        for i in range(5):
            nxt, caches = step(model, caches, nxt, 6 + i, gen)
            out.append(nxt)
        return torch.stack(out, 1)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int64
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    last, caches = prefill(model, {"tokens": prompts})
    g, _ = greedy(model, caches, torch.argmax(last, -1), 6)
    assert g.shape == (4,)


def test_engine_refuses_to_run_past_max_len():
    cfg, model = _reduced_model("minitron-8b")
    engine = Engine(cfg, model, max_len=10, device="cpu")
    assert engine.generate(torch.zeros(2, 6, dtype=torch.long),
                           5).shape == (2, 5)
    with pytest.raises(ValueError, match="max_len"):
        engine.generate(torch.zeros(2, 6, dtype=torch.long), 6)


def test_bf16_engine_runs():
    cfg, model = _reduced_model("qwen2.5-3b", dtype=torch.bfloat16)
    out = Engine(cfg, model, max_len=16, device="cpu").generate(
        torch.ones(2, 8, dtype=torch.long), 8)
    assert out.shape == (2, 8)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()


def test_launch_serve_main(capsys, monkeypatch):
    launch_serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                       "6", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] qwen3-1.7b: generated (2, 4)" in out
    # --no-reduced reaches the full config (the JAX flag could not)
    asked = []
    monkeypatch.setattr(launch_serve, "get_arch",
                        lambda name: asked.append(name) or REDUCED[name])
    launch_serve.main(["--device", "cpu", "--no-reduced", "--arch",
                       "minitron-8b", "--batch", "1", "--prompt-len", "4",
                       "--gen", "2"])
    assert asked == ["minitron-8b"]
    assert "[serve] minitron-8b: generated (1, 2)" in capsys.readouterr().out


def test_launch_serve_runs_the_moe_arch(capsys):
    """``--arch deepseek-moe-16b --reduced``: the MoE arch goes through
    the launcher with no change but ``check_supported``'s."""
    launch_serve.main(["--device", "cpu", "--arch", "deepseek-moe-16b",
                       "--reduced", "--batch", "2", "--prompt-len", "6",
                       "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] deepseek-moe-16b: generated (2, 4)" in out
    first = out.split("first row: ")[1]
    toks = [int(v) for v in first.strip()[1:-1].split(",")]
    assert len(toks) == 4 and all(0 <= v < 512 for v in toks)


@pytest.mark.parametrize("name", NEW)
def test_launch_serve_runs_the_new_families(capsys, name):
    """MLA and the recurrent archs go through the launcher unchanged."""
    launch_serve.main(["--device", "cpu", "--arch", name, "--batch", "2",
                       "--prompt-len", "6", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {name}: generated (2, 4)" in out
    toks = [int(v) for v in out.split("first row: ")[1].strip()[1:-1]
            .split(",")]
    assert len(toks) == 4 and all(0 <= v < 512 for v in toks)
