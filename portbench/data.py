"""The cells' token stream: a frozen copy of the program's synthetic
stream (a noisy periodic progression, numpy, seeded), so that later
changes to the program cannot move the yardstick. Every step's rows
differ; every seed gives batches of the same shapes."""

from __future__ import annotations

import numpy as np


def batch(seed: int, step: int, *, vocab: int, global_batch: int,
          seq_len: int, period: int = 17, noise: float = 0.05
          ) -> np.ndarray:
    """Tokens (global_batch, seq_len) int32 of global step `step`."""
    rng = np.random.default_rng(int(seed) * 1_000_003 + step)
    base = rng.integers(0, vocab, size=(global_batch, 1), dtype=np.int64)
    t = np.arange(seq_len, dtype=np.int64)[None, :]
    tokens = (base + t * (1 + (base % period))) % vocab
    mask = rng.random((global_batch, seq_len)) < noise
    other = rng.integers(0, vocab, size=(global_batch, seq_len),
                         dtype=np.int64)
    return np.where(mask, other, tokens).astype(np.int32)
