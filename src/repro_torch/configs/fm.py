"""fm [recsys] — Factorization Machine. [ICDM'10 (Rendle); paper]

n_sparse=39 embed_dim=10, pairwise interactions via the O(nk) sum-square
strength reduction.  Table sizes follow a Criteo-like skewed distribution:
a few 10M+-row id fields, a long tail of small ones — 90,218,865 rows in
all (3.36 GiB fp32), one concatenated table that fits on one H100.
"""

import numpy as np

from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, RecsysConfig


def _criteo_like_sizes(n_fields: int = 39, seed: int = 7) -> tuple:
    """Deterministic power-law table sizes: max 40M rows, min 4 rows."""
    rng = np.random.RandomState(seed)
    # log-uniform between 10^0.6 and 10^7.6, with the 4 largest pinned so
    # the total is stable across numpy versions.
    sizes = np.power(10.0, rng.uniform(0.6, 6.3, size=n_fields)).astype(np.int64)
    sizes[:4] = (40_000_000, 25_000_000, 12_000_000, 8_000_000)
    return tuple(int(s) for s in sizes)


MODEL = RecsysConfig(
    name="fm",
    kind="fm",
    n_sparse=39,
    embed_dim=10,
    vocab_sizes=_criteo_like_sizes(),
)

ARCH = ArchSpec(
    arch_id="fm",
    family="recsys",
    model=MODEL,
    shapes=dict(RECSYS_SHAPES),
    source="ICDM'10 (Rendle); paper",
    notes=f"{MODEL.total_rows:,} total embedding rows; single concatenated "
          "table (TBE layout), one gather per batch.",
)
