"""Fault-tolerant checkpointing: atomic step directories, async writes,
retention, in the JAX package's on-disk layout, so that a checkpoint
written by either package restores into the other.

Layout:  <root>/step_<n>/{meta.json, <leaf-name>.npy ...}
A leaf's name joins its path in the tree (dict keys in sorted order, list
and tuple indices) with "_", as the reference's ``_leaf_paths`` does:
``params_body_b0_attn_w_q``, ``opt_m_embed_0`` (an int8 moment's codes),
``opt_step``.  A step directory is written under a tmp name and renamed
into place, so readers never see a partial checkpoint; an interrupted
save leaves only a tmp dir that the next manager removes.

bfloat16 leaves: the reference's ``np.save`` of an ml_dtypes bfloat16
array writes the two bytes of each element under the descr ``<V2`` (which
``np.load`` reads back as ``|V2``); the port writes the same header and
bytes from a uint16 view and reads them back through one, so its files
are the reference's byte for byte and it needs no ml_dtypes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

V2 = np.dtype("V2")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor as numpy (a copy also of a tensor already
    on the host, so that later in-place updates do not reach it);
    bfloat16 as its bytes in a ``V2`` array (the reference's file format
    for it)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(V2)
    return t.numpy()


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy -> tensor; a two-byte void array (a bfloat16 leaf written by
    either package) or an ml_dtypes bfloat16 array becomes bfloat16."""
    a = np.require(a, requirements="C")             # keeps 0-d arrays 0-d
    if a.dtype.itemsize == 2 and a.dtype.kind == "V" or (
            a.dtype.name == "bfloat16"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _save(path: str, arr: np.ndarray) -> None:
    """``np.save``, with a bfloat16 leaf's header as the reference's."""
    if arr.dtype != V2:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _leaf_paths(tree, prefix=()):
    """[(name, leaf)] in ``jax.tree_util.tree_flatten_with_path`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _leaf_paths(t, prefix + (str(i),))]
    return [("_".join(prefix), tree)]


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(root, exist_ok=True)
        self._cleanup_tmp()

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot to host memory now (a copy of every leaf: the caller
        may update the tree in place while the write runs), write to disk
        on a thread (or here when blocking or not async)."""
        host = [(n, to_numpy(t)) for n, t in _leaf_paths(tree)]
        self.wait()
        if self.async_save and not blocking:
            self._thread = threading.Thread(
                target=self._write_logged, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write_logged(self, step, host):
        try:
            self._write(step, host)
        except BaseException as e:      # raised by the next wait()
            self._error = e

    def _write(self, step: int, host):
        tmp = os.path.join(self.root, f".tmp_step_{step}_{os.getpid()}")
        final = os.path.join(self.root, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        meta = {"step": step, "leaves": [], "time": time.time()}
        for name, arr in host:
            fname = f"{name}.npy"
            _save(os.path.join(tmp, fname), arr)
            meta["leaves"].append({"name": name, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": ("bfloat16" if arr.dtype == V2
                                             else str(arr.dtype))})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        """Wait for the async write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    # -- restore -------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.root)
                 if d.startswith("step_")]
        return max(steps) if steps else None

    def restore(self, step: int, like_tree):
        """Load step's checkpoint into like_tree's tensors, in place (each
        converted to its like's dtype, on its device); returns like_tree.
        Every leaf must have its like's shape."""
        d = os.path.join(self.root, f"step_{step}")
        for name, like in _leaf_paths(like_tree):
            arr = from_numpy(np.load(os.path.join(d, f"{name}.npy")))
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(arr.shape)}, expected "
                                 f"{tuple(like.shape)}")
            with torch.no_grad():
                like.copy_(arr.to(like.dtype))
        return like_tree

    # -- hygiene -------------------------------------------------------------
    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.root)
                       if d.startswith("step_"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)

    def _cleanup_tmp(self):
        for d in os.listdir(self.root):
            if d.startswith(".tmp_step_"):
                shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
