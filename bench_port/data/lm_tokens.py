"""The LM decode cell's requests, drawn on the host.

One multiset of (prompt length, new tokens) from the mix's
``shape_seed``, uniform over ``prompt_min``-``prompt_max`` and
``new_min``-``new_max``, so every seed gets the same work.  Its first
``slots`` requests start mid-flight: their prompt carries an
already-decoded part, uniform over 0 to ``max_new - 1`` tokens, which is
taken off what they still generate.  Those parts come from ``shape_seed``
too, stratified (request i's share of its ``max_new`` lies in its own
``1 / slots`` of [0, 1)), so each is uniform while every seed starts from
the same set of mid-flight states, and how many of them end in a window
does not vary from seed to seed.  The run's seed shuffles the mid-flight
requests over the slots and the rest of the multiset into the queue
behind them, and draws the token ids, uniform over the vocabulary.
"""

from __future__ import annotations

import numpy as np


def requests(mix: dict, seed: int, vocab: int):
    """[(tokens (int32), max_new, pre-decoded count), ...] in queue order."""
    n, slots = int(mix["requests"]), int(mix["slots"])
    base = np.random.default_rng(int(mix["shape_seed"]))
    plen = base.integers(int(mix["prompt_min"]), int(mix["prompt_max"]) + 1, n)
    new = base.integers(int(mix["new_min"]), int(mix["new_max"]) + 1, n)
    pre = np.zeros(n, np.int64)
    share = (base.permutation(slots) + base.random(slots)) / slots
    pre[:slots] = np.minimum(np.floor(share * new[:slots]), new[:slots] - 1)
    own = np.random.default_rng(int(seed))
    order = np.concatenate([own.permutation(slots),
                            slots + own.permutation(n - slots)])
    plen, new, pre = plen[order], new[order], pre[order]
    out = []
    for p, m, d in zip(plen.tolist(), new.tolist(), pre.tolist()):
        toks = own.integers(0, vocab, p + d, dtype=np.int64).astype(np.int32)
        out.append((toks, m - d, d))
    return out
