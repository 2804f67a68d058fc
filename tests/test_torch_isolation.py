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
    from repro_torch.serving.multi_table import MultiTableIndex
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        MultiTableIndex(IndexConfig(method="bh", tables=2))
    from repro_torch import interop
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        interop.families_from_numpy(
            [{"kind": "bh", "u": np.zeros((4, 2)), "v": np.zeros((4, 2))}])


def test_kernel_wrappers_take_plain_versions_only_on_cpu():
    """A CPU tensor takes the plain version; any other device the kernel
    (a 'meta' tensor stands in for a device with no kernel here)."""
    from repro_torch.kernels.bilinear_hash import bilinear_hash_seeded
    from repro_torch.kernels.hamming import hamming_topk_hist
    before = (bilinear_hash_seeded.launches, hamming_topk_hist.launches)
    x = torch.zeros(5, 3)
    assert bilinear_hash_seeded(x, [1], 20).shape == (1, 5, 1)
    codes = torch.zeros(1, 5, 1, dtype=torch.int32)
    assert hamming_topk_hist(codes, codes[:, :2], 3, 8)[0].shape == (
        1, 1, 2, 3)
    assert (bilinear_hash_seeded.launches,
            hamming_topk_hist.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        bilinear_hash_seeded(x.to("meta"), [1], 20)
    with pytest.raises(ValueError, match="unsupported device"):
        hamming_topk_hist(codes.to("meta"), codes[:, :2].to("meta"), 3, 8)


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
