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


def test_concurrent_first_use_builds_and_loads_once(tmp_path, monkeypatch):
    """Two threads that use a library for the first time together get one
    build (one nvcc run), one loaded library and no error: ``load`` and
    ``build`` hold a module lock, and the temporary file carries the
    thread id.  nvcc is a script here that copies a real shared object
    (the ctypes extension) to its -o path, slowly."""
    import _ctypes
    import threading

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "twice.cu").write_text("int a;\n")
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> '{calls}'\n"
        "sleep 0.3\n"
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && o="$2"; shift; done\n'
        f"cp '{_ctypes.__file__}' \"$o\"\n"
        "echo \"ptxas info    : Compiling entry function for 'sm_90a'\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LIBS", {})
    barrier = threading.Barrier(2)
    got, errors = [], []

    def first_use():
        try:
            barrier.wait(10)
            got.append(_build.load("twice", {}))
        except BaseException as e:   # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(got) == 2 and got[0] is got[1]
    assert calls.read_text().split() == ["run"]
    assert sorted(p.suffix for p in out.iterdir()) == [".log", ".so"]
    assert "sm_90a" in _build.build_log("twice")


def test_launch_counter_loses_no_increment():
    """``_build.count`` bumps a wrapper's counter under a lock: 32 threads
    of 5,000 bumps each, switching as often as the interpreter allows, add
    up exactly."""
    import sys
    import threading

    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count(wrapper) for _ in range(5_000)]) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 160_000
    _build.count(wrapper, n=7)
    assert wrapper.launches == 160_007
