"""Synthetic jet dataset generator for JEDI-net training.

A copy of ``repro.data.jets`` (pure numpy): the port imports nothing of the
JAX package, and the same seed must give byte-identical arrays.

The real HLS4ML LHC jet datasets (Zenodo 3601436 / 3601443) are not
available offline, so this module generates a *structured* synthetic
surrogate with the same tensor layout ((N_o particles, 16 features),
5 classes) and a planted physics-flavoured rule, so that training runs
show real learning curves and the co-design accuracy proxy can be
calibrated against actually-trained models:

Each class c gets a characteristic subjet multiplicity and angular spread;
particles are drawn as (pT, eta, phi)-like triples with class-dependent
clustering, then embedded into 16 features via a fixed random linear map +
nonlinearity, mimicking the engineered-feature redundancy of the real
dataset.  Bayes accuracy is tunable via `noise`; at the default ~0.25 a
JEDI-net reaches high accuracy while a linear model cannot.
"""

from __future__ import annotations

import numpy as np


N_CLASSES = 5


def make_jets(rng: np.random.RandomState, n: int, n_particles: int,
              n_features: int = 16, noise: float = 0.25):
    """Returns (x (n, N_o, P) float32, y (n,) int32)."""
    y = rng.randint(0, N_CLASSES, size=n).astype(np.int32)

    # class-dependent generative parameters
    n_subjets = 1 + (y % 3)                       # 1..3 clusters
    spread = 0.1 + 0.15 * (y % 2)                 # angular spread
    softness = 0.5 + 0.25 * (y // 2)              # pT falloff

    x3 = np.zeros((n, n_particles, 3), np.float32)
    for i in range(n):
        k = n_subjets[i]
        centers = rng.normal(0, 1.0, size=(k, 2))
        assign = rng.randint(0, k, size=n_particles)
        ang = centers[assign] + rng.normal(0, spread[i], (n_particles, 2))
        # pT: falling spectrum, leading particles first
        pt = rng.exponential(softness[i], n_particles).astype(np.float32)
        pt = np.sort(pt)[::-1]
        x3[i, :, 0] = np.log1p(pt)            # compress the pT spectrum
        x3[i, :, 1:] = ang
    # embed 3 -> n_features with a FIXED random map (shared across calls)
    emb_rng = np.random.RandomState(1234)
    w1 = emb_rng.normal(0, 1.0, (3, n_features)).astype(np.float32)
    w2 = emb_rng.normal(0, 0.5, (3, n_features)).astype(np.float32)
    x = np.tanh(x3 @ w1) + x3 @ w2
    x += rng.normal(0, noise, x.shape).astype(np.float32)
    # fixed global standardization keeps inputs O(1) for any noise level
    x = (x - x.mean(axis=(0, 1), keepdims=True)) / (
        x.std(axis=(0, 1), keepdims=True) + 1e-6)
    return x.astype(np.float32), y


def jet_batches(seed: int, batch: int, n_particles: int,
                n_features: int = 16, noise: float = 0.25):
    """Infinite iterator of {"x", "y"} batches."""
    rng = np.random.RandomState(seed)
    while True:
        x, y = make_jets(rng, batch, n_particles, n_features, noise)
        yield {"x": x, "y": y}


# --- large-graph regime: track-level events ---------------------------------

#: Tracks per event in the large-graph configs — the regime real-time
#: graph building on FPGAs targets (Neu et al., arXiv:2307.07289:
#: O(100) tracks/event at 40 MHz), where the UNTILED whole-network
#: kernel's (N_o, N_o, H1) grid no longer fits VMEM at any batch tile
#: and only the sender-tiled kernel applies.
TRACKS_N = 128


def make_tracks(rng: np.random.RandomState, n: int,
                n_tracks: int = TRACKS_N, n_features: int = 16,
                noise: float = 0.25):
    """Synthetic TRACK-level events: (x (n, n_tracks, P) float32, y (n,)).

    Where :func:`make_jets` plants calorimeter-style (pT, eta, phi)
    clusters, this generator mimics an inner-tracker readout: each class
    plants a characteristic number of displaced vertices, and every
    track carries 5 helix-flavoured raw features — (log pT, eta, phi,
    d0, z0) — with d0/z0 drawn around its vertex, then embedded into
    ``n_features`` via the same fixed random map + nonlinearity trick
    so the tensor layout matches the jet datasets exactly.  Same label
    space (:data:`N_CLASSES`) so the full JEDI-net stack runs unchanged
    at N_o = ``n_tracks``.
    """
    y = rng.randint(0, N_CLASSES, size=n).astype(np.int32)

    # class-dependent generative parameters
    n_vertices = 1 + (y % 3)                      # prompt + displaced
    displacement = 0.05 + 0.20 * (y % 2)          # d0/z0 scale per class
    softness = 0.5 + 0.25 * (y // 2)              # pT falloff

    x5 = np.zeros((n, n_tracks, 5), np.float32)
    for i in range(n):
        k = n_vertices[i]
        vtx = rng.normal(0, displacement[i], size=(k, 2))   # (d0, z0) centers
        dirs = rng.normal(0, 1.0, size=(k, 2))              # (eta, phi) axes
        assign = rng.randint(0, k, size=n_tracks)
        pt = rng.exponential(softness[i], n_tracks).astype(np.float32)
        pt = np.sort(pt)[::-1]
        x5[i, :, 0] = np.log1p(pt)
        x5[i, :, 1:3] = dirs[assign] + rng.normal(0, 0.2, (n_tracks, 2))
        x5[i, :, 3:5] = vtx[assign] + rng.normal(
            0, 0.02, (n_tracks, 2))
    emb_rng = np.random.RandomState(4321)
    w1 = emb_rng.normal(0, 1.0, (5, n_features)).astype(np.float32)
    w2 = emb_rng.normal(0, 0.5, (5, n_features)).astype(np.float32)
    x = np.tanh(x5 @ w1) + x5 @ w2
    x += rng.normal(0, noise, x.shape).astype(np.float32)
    x = (x - x.mean(axis=(0, 1), keepdims=True)) / (
        x.std(axis=(0, 1), keepdims=True) + 1e-6)
    return x.astype(np.float32), y


def track_batches(seed: int, batch: int, n_tracks: int = TRACKS_N,
                  n_features: int = 16, noise: float = 0.25):
    """Infinite iterator of {"x", "y"} track-level batches."""
    rng = np.random.RandomState(seed)
    while True:
        x, y = make_tracks(rng, batch, n_tracks, n_features, noise)
        yield {"x": x, "y": y}
