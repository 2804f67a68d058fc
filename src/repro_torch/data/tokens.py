"""Synthetic LM token pipeline: Zipfian unigram + Markov bigram structure so
training loss has real signal (a model that learns the bigram table beats
the unigram entropy floor)."""
from __future__ import annotations

import numpy as np


class SyntheticTokenStream:
    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 32,
                 zipf_a: float = 1.2):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # unigram: zipf-ish weights over vocab
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = (ranks ** -zipf_a)
        self.unigram /= self.unigram.sum()
        # bigram: each token transitions to `branch` preferred successors
        self.succ = rng.integers(0, vocab_size, (vocab_size, branch))
        self.rng = rng
        self.branch = branch

    def batch(self, batch_size: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch_size, seq_len), np.int32)
        cur = self.rng.choice(self.vocab, batch_size, p=self.unigram)
        out[:, 0] = cur
        for t in range(1, seq_len):
            use_bigram = self.rng.random(batch_size) < 0.8
            picks = self.succ[cur, self.rng.integers(0, self.branch,
                                                     batch_size)]
            fresh = self.rng.choice(self.vocab, batch_size, p=self.unigram)
            cur = np.where(use_bigram, picks, fresh).astype(np.int32)
            out[:, t] = cur
        return out
