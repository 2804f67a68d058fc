"""The port stands alone: nothing under src/repro_torch/ and nothing in
chip_smoke.py imports jax or the JAX package (imports of repro_torch
itself are fine), and its entry points never fall back to the CPU when
the card was asked for."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield node.lineno, "repro_torch (relative)"
            else:
                yield node.lineno, node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 10
    walked = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"src/repro_torch/serving/lsm.py",
            "src/repro_torch/serving/async_service.py",
            "src/repro_torch/kernels/hamming.py",
            "src/repro_torch/utils/mesh.py",
            "src/repro_torch/examples/active_learning_svm.py",
            "src/repro_torch/configs/base.py",
            "src/repro_torch/configs/registry.py",
            "src/repro_torch/configs/qwen3_1_7b.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/attention.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/models/rglru.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/examples/serve_lm.py",
            "src/repro_torch/examples/al_data_curation.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/optim/grad_compress.py",
            "src/repro_torch/train/step.py",
            "src/repro_torch/train/trainer.py",
            "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/data/tokens.py",
            "src/repro_torch/data/loader.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/examples/train_lm.py",
            "src/repro_torch/sharding/rules.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/specs.py",
            "src/repro_torch/launch/op_stats.py",
            "src/repro_torch/launch/analysis.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/kernels/contracts.py",
            "src/repro_torch/utils/captures.py"} <= walked
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in PORT_FILES for line, mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_walk_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import search\n"
                 "def g():\n    from repro_torch import ops\n")
    mods = [m for _, m in _imported_modules(f)]
    assert mods == ["jax.numpy", "repro.core", "repro_torch"]


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.core.indexer import IndexConfig
    from repro_torch.serving.lsm import LSMMultiTableIndex
    from repro_torch.serving.multi_table import MultiTableIndex
    from repro_torch.svm.active import make_selector
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (MultiTableIndex, LSMMultiTableIndex):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cls(IndexConfig(method="bh", tables=2))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_selector("bh", bits=8, radius=2, use_async=True)
    from repro_torch import interop
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        interop.families_from_numpy(
            [{"kind": "bh", "u": np.zeros((4, 2)), "v": np.zeros((4, 2))}])


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    """The LM path's entry points with their default device raise where
    no card is present, before any work."""
    from repro_torch.configs.registry import REDUCED
    from repro_torch.core.indexer import ActivationIndexer, IndexConfig
    from repro_torch.launch import serve
    from repro_torch.models import (Transformer, init_cache, init_params,
                                    model_spec)
    from repro_torch.models.transformer import init_block_cache
    from repro_torch.models.layers import tree_map
    from repro_torch.serve.engine import Engine
    from repro_torch import interop
    cfg = REDUCED["qwen3-1.7b"]
    tree = init_params(model_spec(cfg), torch.float32,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    model = Transformer(cfg, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Engine(cfg, model)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ActivationIndexer(lambda t: t, IndexConfig(method="bh"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(["--batch", "1", "--gen", "1"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        interop.params_from_numpy(cfg, tree_map(lambda v: v.numpy(), tree))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        init_cache(cfg, 1, 4, torch.float32)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        init_block_cache(cfg, "attn", 1, 4, torch.float32)
    assert model.embed.device.type == "cpu"


def test_kernel_wrappers_take_plain_versions_only_on_cpu():
    """A CPU tensor takes the plain version; any other device the kernel
    (a 'meta' tensor stands in for a device with no kernel here)."""
    from repro_torch.kernels.bilinear_hash import (bilinear_hash,
                                                   bilinear_hash_seeded)
    from repro_torch.kernels.hamming import (hamming_distance,
                                             hamming_distance_batch,
                                             hamming_topk_fused,
                                             hamming_topk_hist,
                                             hamming_topk_hist_dma)
    from repro_torch.kernels.lbh_grad import lbh_chain
    scans = (hamming_topk_hist, hamming_topk_fused, hamming_topk_hist_dma)
    kernels = (bilinear_hash_seeded, bilinear_hash, lbh_chain,
               hamming_distance, hamming_distance_batch, *scans)
    before = [k.launches for k in kernels]
    x = torch.zeros(5, 3)
    u = torch.zeros(3, 20)
    p, r = torch.zeros(5), torch.zeros(5, 5)
    assert bilinear_hash_seeded(x, [1], 20).shape == (1, 5, 1)
    codes = torch.zeros(1, 5, 1, dtype=torch.int32)
    for scan in scans:
        assert scan(codes, codes[:, :2], 3, 8)[0].shape == (1, 1, 2, 3)
    assert hamming_distance(codes[0], codes[0, 0]).shape == (5,)
    assert hamming_distance_batch(codes[0], codes[0, :2]).shape == (2, 5)
    assert bilinear_hash(x, u, u).shape == (5, 1)
    assert lbh_chain(p, p, r)[0].shape == (5,)
    assert [k.launches for k in kernels] == before
    meta = lambda *ts: [t.to("meta") for t in ts]  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        bilinear_hash_seeded(x.to("meta"), [1], 20)
    for scan in scans:
        with pytest.raises(ValueError, match="unsupported device"):
            scan(codes.to("meta"), codes[:, :2].to("meta"), 3, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        hamming_distance(*meta(codes[0], codes[0, 0]))
    with pytest.raises(ValueError, match="unsupported device"):
        hamming_distance_batch(*meta(codes[0], codes[0, :2]))
    with pytest.raises(ValueError, match="unsupported device"):
        bilinear_hash(*meta(x, u, u))
    with pytest.raises(ValueError, match="unsupported device"):
        lbh_chain(*meta(p, p, r))


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where
    torch.cuda.is_available() is False."""
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the smoke run would start")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
