"""Build the CUDA sources under ``csrc/`` and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own with nvcc for ``sm_90a`` into ``build/kernels/`` at the repository root,
at first use.  The library's file name carries a hash of its source, of
every header under ``csrc/`` and of the flags, so an edited source or
header builds anew and an unchanged one is reused.
No ``--use_fast_math``: the hash kernel's generator needs IEEE logf/cosf.
A failed build raises with nvcc's output; nothing falls back.

Threads: ``build`` and ``load`` hold one module lock, so two threads that
use a library for the first time build it once and load it once (the
router's shard threads and the refresh worker meet first uses together).
The launch counters of the kernel wrappers move through ``count``, under
a lock of their own, so concurrent launches lose no increment.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.RLock()    # build / load: one first use at a time
_COUNT_LOCK = threading.Lock()
_first_uses = 0    # builds and first loads under way (guarded by _COUNT_LOCK)


def count(fn, attr: str = "launches", n: int = 1) -> None:
    """Add n to the counter ``fn.<attr>`` of a kernel wrapper, under a lock
    (a bare ``+=`` on a function attribute can lose increments between
    threads)."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)


def nvcc_path() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    nvcc = home / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names) -> None:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together.  nvcc's output (with the
    ``-Xptxas -v`` register / shared-memory / spill report) is kept beside
    each library; see ``build_log``.  The temporary file carries the
    process and the thread id, so no two threads write one file."""
    _note_first_use(1)
    try:
        with _BUILD_LOCK:
            _build_locked(names)
    finally:
        _note_first_use(-1)


def _note_first_use(n: int) -> None:
    global _first_uses
    with _COUNT_LOCK:
        _first_uses += n


def building() -> bool:
    """True while a build, or a first load waiting for one, is under way in
    this process: a caller's deadline (the router's per-replica call) does
    not count a first use's nvcc time."""
    with _COUNT_LOCK:
        return _first_uses > 0


def _build_locked(names) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(
            f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build_log(name: str) -> str:
    """nvcc's output from the build of ``name`` (empty if none was kept)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    ``signatures`` ({function: (restype, argtypes)}) declared on it.
    Pointers and the stream go as ``ctypes.c_void_p``: an undeclared
    argument would pass as a 32-bit int and cut a pointer."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _note_first_use(1)
    try:
        with _BUILD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                so = library_path(name)
                if not so.exists():
                    build([name])
                lib = ctypes.CDLL(str(so))
                for fn, (restype, argtypes) in signatures.items():
                    getattr(lib, fn).restype = restype
                    getattr(lib, fn).argtypes = argtypes
                _LIBS[name] = lib
    finally:
        _note_first_use(-1)
    return lib
