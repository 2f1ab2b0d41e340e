"""Synthetic CTR data with a planted factorized rule for FM training.

A copy of ``repro.data.recsys_data`` (pure numpy): the same seed gives
byte-identical arrays.
"""

from __future__ import annotations

import numpy as np


def ctr_batches(seed: int, batch: int, vocab_sizes: tuple,
                embed_dim: int = 8):
    """Infinite {"ids" (B, F), "y" (B,)} stream; labels follow a hidden FM."""
    rng = np.random.RandomState(seed)
    f = len(vocab_sizes)
    # hidden true factors (hashed per field to keep memory tiny)
    h_dim = 64
    field_emb = rng.normal(0, 0.5, (f, h_dim, embed_dim)).astype(np.float32)
    while True:
        ids = np.stack([rng.randint(0, s, batch) for s in vocab_sizes], 1)
        v = field_emb[np.arange(f)[None, :], ids % h_dim]      # (B, F, K)
        sv = v.sum(1)
        score = 0.5 * ((sv ** 2).sum(-1) - (v ** 2).sum(1).sum(-1))
        p = 1.0 / (1.0 + np.exp(-score))
        y = (rng.rand(batch) < p).astype(np.int32)
        yield {"ids": ids.astype(np.int32), "y": y}
