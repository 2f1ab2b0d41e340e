"""Synthetic LM token streams with learnable bigram structure.

A random (but fixed-seed) bigram transition matrix over the vocab generates
sequences whose next-token entropy is well below log(V), so training loss
visibly drops below the uniform baseline within a few hundred steps — a
real learning signal for the end-to-end driver without external data.
"""

from __future__ import annotations

import numpy as np


def _bigram_table(vocab: int, branching: int = 32, seed: int = 99):
    rng = np.random.RandomState(seed)
    nexts = rng.randint(0, vocab, size=(vocab, branching)).astype(np.int32)
    return nexts


def make_tokens(rng: np.random.RandomState, batch: int, seq: int,
                vocab: int, branching: int = 32):
    nexts = _bigram_table(vocab, branching)
    toks = np.zeros((batch, seq), np.int32)
    toks[:, 0] = rng.randint(0, vocab, batch)
    choice = rng.randint(0, branching, size=(batch, seq))
    for t in range(1, seq):
        toks[:, t] = nexts[toks[:, t - 1], choice[:, t]]
    return toks


def lm_batches(seed: int, batch: int, seq: int, vocab: int):
    """Infinite iterator of {"tokens", "labels"} batches (shifted)."""
    rng = np.random.RandomState(seed)
    while True:
        t = make_tokens(rng, batch, seq + 1, vocab)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:].copy()}
