"""Synthetic jets for the benchmark's traffic, drawn from ``--seed``.

The generative model of ``src/repro_torch/data/jets.py``'s ``make_jets``
(itself a copy of the JAX package's), frozen here so that a change to the
program cannot change the benchmark's inputs.  Each event draws a class
(g, q, W, Z, t); the class sets a number of subjets (1-3), an angular
spread and a pT falloff; particles are (log1p pT, eta, phi)-like triples,
leading pT first, embedded into ``n_features`` by a fixed random map and
a tanh, with Gaussian noise, then standardised over the whole draw.

Written in torch ops on the generator's device, so a pool of 64,000
events is a few calls on the card instead of a Python loop per event.
Same model, other random stream: the arrays are not the program
generator's for any seed.
"""

from __future__ import annotations

import numpy as np
import torch

N_CLASSES = 5
MAX_SUBJETS = 3
EMBED_SEED = 1234      # the fixed embedding map of the program's generator


def _embedding(n_features: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    emb = np.random.RandomState(EMBED_SEED)
    w1 = emb.normal(0, 1.0, (3, n_features)).astype(np.float32)
    w2 = emb.normal(0, 0.5, (3, n_features)).astype(np.float32)
    return (torch.from_numpy(w1).to(device), torch.from_numpy(w2).to(device))


def _embed(x3: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x3 (..., 3) @ w (3, F) as three broadcast products: no matrix
    product, so no TF32 setting can touch the inputs."""
    return (x3[..., 0:1] * w[0] + x3[..., 1:2] * w[1]) + x3[..., 2:3] * w[2]


def make_jets(gen: torch.Generator, n: int, n_particles: int,
              n_features: int = 16, noise: float = 0.25):
    """(x (n, n_particles, n_features) fp32, y (n,) int64) on ``gen``'s
    device."""
    dev = gen.device
    y = torch.randint(0, N_CLASSES, (n,), generator=gen, device=dev)
    n_sub = 1 + y % 3
    spread = 0.1 + 0.15 * (y % 2).float()
    softness = 0.5 + 0.25 * (y // 2).float()
    centers = torch.randn((n, MAX_SUBJETS, 2), generator=gen, device=dev)
    u = torch.rand((n, n_particles), generator=gen, device=dev)
    assign = torch.minimum((u * n_sub[:, None]).long(), (n_sub - 1)[:, None])
    ang = torch.gather(centers, 1, assign[..., None].expand(-1, -1, 2))
    ang = ang + torch.randn((n, n_particles, 2), generator=gen,
                            device=dev) * spread[:, None, None]
    pt = torch.empty((n, n_particles), device=dev).exponential_(
        1.0, generator=gen) * softness[:, None]
    pt = pt.sort(dim=1, descending=True).values
    x3 = torch.cat([torch.log1p(pt)[..., None], ang], dim=-1)
    w1, w2 = _embedding(n_features, dev)
    x = torch.tanh(_embed(x3, w1)) + _embed(x3, w2)
    x = x + torch.randn(x.shape, generator=gen, device=dev) * noise
    mean = x.mean(dim=(0, 1), keepdim=True)
    std = x.std(dim=(0, 1), keepdim=True, correction=0)
    return ((x - mean) / (std + 1e-6)).float().contiguous(), y
