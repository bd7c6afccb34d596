"""Deterministic synthetic corpus (a copy of ``repro/data/tokens.py``:
numpy only, so the port keeps its own).

A Zipf-distributed unigram mixed with a first-order Markov chain gives the
token stream enough structure that calibration activations develop
correlated, outlier-bearing statistics.  Fully keyed by ``seed``: the same
seed gives the same tokens, bitwise, in both packages."""

from __future__ import annotations

import numpy as np


class SyntheticCorpus:
    def __init__(self, vocab_size: int, seed: int = 0, n_states: int = 64,
                 zipf_a: float = 1.8, bigram_p: float = 0.5):
        self.vocab_size = vocab_size
        self.seed = seed
        self.bigram_p = bigram_p
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = ranks ** (-zipf_a)
        self.unigram /= self.unigram.sum()
        # deterministic bigram skeleton: a fixed random permutation
        self.perm = rng.permutation(vocab_size).astype(np.int32)

    def sequence(self, index: int, length: int) -> np.ndarray:
        """Deterministic sequence #index (independent of call order)."""
        rng = np.random.default_rng((self.seed, index))
        mix = rng.random(length)
        base = rng.choice(self.vocab_size, size=length, p=self.unigram)
        toks = np.empty(length, np.int32)
        toks[0] = base[0]
        for t in range(1, length):
            if mix[t] < self.bigram_p:
                toks[t] = self.perm[toks[t - 1]]  # learnable transition
            else:
                toks[t] = base[t]
        return toks

    def batch(self, start_index: int, batch: int, length: int) -> np.ndarray:
        return np.stack([self.sequence(start_index + i, length) for i in range(batch)])
