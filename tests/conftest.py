"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see the real
single CPU device; only launch/dryrun.py forces 512 placeholder devices."""

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "chaos: fault-injection suite for the resilient serving layer "
        "(runs in tier-1 AND standalone in CI's chaos job via -m chaos)")
    config.addinivalue_line(
        "markers",
        "sentinel: silent-corruption sentinel suite (canaries, shadow "
        "re-execution, canary-gated quarantine); runs in tier-1 AND in "
        "CI's chaos job via -m 'chaos or sentinel'")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); skips "
        "without one")


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def random_graph(rng, n=20, e=60, d=8, with_pos=False, n_classes=3):
    import jax.numpy as jnp
    g = {
        "x": jnp.asarray(rng.normal(0, 1, (n, d)).astype(np.float32)),
        "senders": jnp.asarray(rng.randint(0, n, e).astype(np.int32)),
        "receivers": jnp.asarray(rng.randint(0, n, e).astype(np.int32)),
        "y": jnp.asarray(rng.randint(0, n_classes, n).astype(np.int32)),
    }
    if with_pos:
        g["pos"] = jnp.asarray(rng.normal(0, 1, (n, 3)).astype(np.float32))
    return g
