"""The kernel build's cache key: a library is rebuilt whenever its source or
a header it may include changes (``kernels._build.library_path``).  Runs on
the CPU: it hashes files, it compiles nothing."""
import re

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "scan.cu").write_text('#include "select.cuh"\nint a;\n')
    (tmp_path / "select.cuh").write_text("int b;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit", [
    ("select.cuh", "int b2;\n"),       # the shared header
    ("scan.cu", '#include "select.cuh"\nint a2;\n'),
    ("other.cuh", "int c;\n"),         # a header added beside it
])
def test_library_path_changes_with_source_or_header(csrc, edit):
    before = _build.library_path("scan")
    assert _build.library_path("scan") == before       # stable when unchanged
    name, text = edit
    (csrc / name).write_text(text)
    after = _build.library_path("scan")
    assert after != before
    assert after.parent == _build.BUILD_DIR and after.suffix == ".so"


def test_every_included_file_is_a_hashed_header():
    """Each quoted include of a kernel source is a ``*.cuh`` beside it, so
    editing it changes ``library_path`` and the library builds anew."""
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert sources
    for src in sources:
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert inc.endswith(".cuh") and (_build.CSRC / inc).is_file(), (
                src.name, inc)
