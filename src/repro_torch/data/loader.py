"""Host -> device data loader with background prefetch.

A thread draws each step's batch from the stream (``tokens.
SyntheticTokenStream``) and places it on the loader's device ahead of the
step that takes it: on the card from pinned host memory by a non-blocking
copy on the device's default stream, ordered before the kernels that read
it.  Every drawn batch is delivered, in order, so a loader over a stream
rebuilt from its seed reproduces the batches (the reference's thread
drops a batch whenever its queue stays full for 0.5 s).
"""
from __future__ import annotations

import queue
import threading

import torch

from repro_torch.utils.device import resolve_device


class ShardedLoader:
    """``next(loader)`` -> {"tokens", "labels"}: (batch_size, seq_len)
    int64 tensors on ``device`` (default the card; a missing card
    raises), the labels a copy of the tokens."""

    def __init__(self, stream, batch_size: int, seq_len: int,
                 device="cuda", prefetch: int = 2):
        self.stream = stream
        self.batch = batch_size
        self.seq = seq_len
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _place(self, toks):
        t = torch.from_numpy(toks).to(torch.int64)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _make(self, step: int):
        toks = self.stream.batch(self.batch, self.seq)
        return {"tokens": self._place(toks),
                "labels": self._place(toks.copy())}

    def _work(self):
        while not self._stop.is_set():
            batch = self._make(self._step)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    self._step += 1
                    break
                except queue.Full:
                    continue

    def __next__(self):
        return self._q.get()

    def __iter__(self):
        return self

    def close(self):
        """Stop the prefetch thread and wait for it."""
        self._stop.set()
        self._thread.join()
