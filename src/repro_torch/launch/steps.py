"""Per-(architecture x shape) step helpers (counterpart of
``repro.launch.steps``).

The port carries the GNN family's helpers that the train program uses:
the feature width of a shape, which kinds need node positions, and the
family's loss on a model's output.  The reference's cell programs over a
device mesh (``CellProgram``, the dry-run's abstract inputs) wait for
ROADMAP Queue A item 11b; the shardings they place their state by are
in :mod:`repro_torch.parallel.sharding`.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeSpec


def _gnn_feat_dim(shape: ShapeSpec) -> int:
    return int(shape.dim("d_feat", 16))


def _needs_pos(kind: str) -> bool:
    return kind in ("meshgraphnet", "equiformer_v2")


def _gnn_loss(kind: str, cfg, out, graph):
    """Family-appropriate loss on model output: masked cross-entropy and
    accuracy over labels ``y >= 0`` for gcn / pna, mean squared error
    (over ``seed_mask``'s nodes where the graph has one) for the
    regression heads.  ``argmax`` takes the first of tied maxima, as
    ``jnp.argmax`` does."""
    if kind in ("gcn", "pna"):
        y = graph["y"]
        mask = (y >= 0).float()
        logp = torch.log_softmax(out.float(), -1)
        nll = -logp.gather(-1, y.clamp_min(0).long()[:, None])[:, 0]
        count = mask.sum().clamp_min(1.0)
        loss = (nll * mask).sum() / count
        acc = ((out.argmax(-1) == y).float() * mask).sum() / count
        return loss, {"accuracy": acc}
    # regression heads
    y = graph["y"].float()
    if y.ndim == 1:
        y = y[:, None]
    mask = graph.get("seed_mask")
    err = (out.float() - y).square()
    if mask is not None:
        m = mask.float()[:, None]
        loss = (err * m).sum() / (m.sum() * err.shape[-1]).clamp_min(1.0)
    else:
        loss = err.mean()
    return loss, {"mse": loss}
