"""Synthetic token data for the language models (a copy of the
reference's ``data/tokens.py``): a first-order Markov chain over the
vocabulary with low-entropy transitions, so short training runs show a
falling loss.  The same seed draws the same tokens as the reference.
"""
from __future__ import annotations

import numpy as np


class MarkovTokens:
    def __init__(self, vocab: int, seed: int = 0, branching: int = 8):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.branching = branching
        # each token prefers `branching` successors
        self._succ = self.rng.integers(0, vocab, size=(min(vocab, 4096),
                                                       branching))

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len), np.int32)
        cur = self.rng.integers(0, self.vocab, size=batch)
        for t in range(seq_len):
            out[:, t] = cur
            idx = cur % self._succ.shape[0]
            pick = self.rng.integers(0, self.branching, size=batch)
            nxt = self._succ[idx, pick]
            noise = self.rng.random(batch) < 0.1
            cur = np.where(noise, self.rng.integers(0, self.vocab, batch), nxt)
        return out

    def batches(self, batch: int, seq_len: int):
        while True:
            yield {"tokens": self.sample(batch, seq_len)}
